"""What depends on a model family, one module a family:
``families/<family>.py``, found by the configuration's ``family`` as
``bench.check.reference`` finds ``reference/<reference>.py``.  A new
family comes in as a new module here and a new reference, with no edit
to the harness.  Each module gives:

- ``PROGRAM_KEYS``: the program's ``ModelConfig`` fields that its
  configuration files give (``bench.harness.program_config``);
- ``layers(cfg)``: ``{name: (shape, kind, std)}`` of every leaf beyond
  ``embedding``, ``ln_f`` and ``head``, in the program's order, each of a
  kind that ``bench.weights.make`` draws (``bench.weights.spec``);
- ``picks(b, seed, c)``: ``{kept leaf: indices along its axis 1}`` of
  what a kept request's check compares of the state it hands on, keyed as
  ``bench.harness.kept_names`` keys the cache; ``POSITIONS``, the pick
  whose indices are the cache positions the reference is handed; and
  ``CUT``, the picked leaves the reference hands back whole, which the
  check cuts to the picks (``bench.check``);
- ``prefill(cfg, B, S)``, ``decode_step(cfg, B, valid)``,
  ``n_attention(cfg)`` and ``n_params(cfg)``: the counts that
  ``bench.roofline`` hands on.
"""
from __future__ import annotations

import importlib

import numpy as np
import torch

from bench import traffic


def of(cfg: dict):
    """The family module of a configuration."""
    return importlib.import_module(f"bench.families.{cfg['family']}")


def drawn(n: int, k: int, tail: int, seed: int, stream_index: int
          ) -> torch.Tensor:
    """k of range(n), sorted: the last ``tail`` and the rest drawn from
    the seed; all of them where n <= k."""
    if n <= k:
        return torch.arange(n)
    rng = np.random.default_rng(traffic.subseed(seed, traffic.STREAM_SAMPLE,
                                                stream_index))
    head = rng.choice(n - tail, size=k - tail, replace=False)
    return torch.as_tensor(np.sort(np.concatenate(
        [head, np.arange(n - tail, n)])), dtype=torch.long)

