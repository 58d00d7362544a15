"""A run with the program broken underneath must come out not correct.

Each cell runs at the port's smoke sizes on the CPU, past the harness's
look for a card, with the cell's own limits: once sound (correct), then
once with each fault a one-card serving cell can have planted in the
program: a step that hands its state on unchanged, half of the batch left
out (its rows served the other half's answers), and a served token altered
where it is produced.  (An exchange between cards is not in a one-card
cell.)"""
from __future__ import annotations

import copy
import time

import pytest
import torch

from bench import harness
from bench.tests.smoke import FILED, smoke_cell

SEED = 2 ** 31 + 17
SECONDS = 4.0  # two batches of two or more requests, also on a loaded CPU


def _run(name: str) -> dict:
    c = smoke_cell(name)
    return harness.run_cell(c, SEED, SECONDS, False, "cpu",
                            time.perf_counter()).checks


def _clone(cache: dict) -> dict:
    return {k: {leaf: t.clone() for leaf, t in v.items()}
            for k, v in cache.items()}


def _state_unchanged(method):
    def broken(self, tokens, cache, *args):
        logits, _ = method(self, tokens, _clone(cache), *args)
        return logits, cache
    return broken


def _half_batch(method):
    def broken(self, tokens, cache, *args):
        half = tokens.shape[0] // 2
        if half:
            tokens = tokens.clone()
            tokens[half:2 * half] = tokens[:half]
        return method(self, tokens, cache, *args)
    return broken


def _token_altered(method):
    def broken(self, tokens, cache, *args):
        logits, cache = method(self, tokens, cache, *args)
        return torch.roll(logits, 1, dims=-1), cache
    return broken


FAULTS = {"state_unchanged": _state_unchanged, "half_batch": _half_batch,
          "token_altered": _token_altered}


@pytest.mark.parametrize("name", FILED)
def test_sound_run_is_correct(name):
    checks = _run(name)
    assert checks["correct"], checks
    assert checks["requests"] >= 2


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("name", FILED)
def test_fault_is_not_correct(name, fault, monkeypatch):
    from repro_torch.models.model import Model
    entry = "decode" if harness.cell(name).mix["kind"] == "decode" \
        else "prefill"
    monkeypatch.setattr(Model, entry, FAULTS[fault](getattr(Model, entry)))
    checks = _run(name)
    assert not checks["correct"], checks


def test_clone_is_deep():
    cache = {"layers": {"k": torch.zeros(2)}}
    other = _clone(cache)
    other["layers"]["k"] += 1
    assert cache["layers"]["k"].sum() == 0
    assert copy.deepcopy(cache).keys() == other.keys()


def test_final_state_fault_shows_in_the_first_layer(monkeypatch):
    """Every Mamba2 layer hands on its final SSM state 15% short (a decay
    applied once too often): too little for ``state_err``'s limit, which
    the deep layers' rounding sets, and far past ``state_err_first``'s."""
    from repro_torch.models import ssm
    forward = ssm.mamba2_forward

    def short(*args, **kw):
        res = forward(*args, **kw)
        if kw.get("return_state"):
            out, final, conv = res
            return out, final * 0.85, conv
        return res
    monkeypatch.setattr(ssm, "mamba2_forward", short)
    checks = _run("zamba2-7b.prefill")
    limits = checks["limits"]
    assert checks["values"]["state_err"] <= limits["state_err"], checks
    assert checks["values"]["state_err_first"] > limits["state_err_first"]
    assert not checks["correct"]
