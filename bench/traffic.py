"""The one traffic generator: it reads a mix's parameters
(``traffic/<mix>.json``) and a seed, and yields the batches a run hands to
the program, in order.

- ``prefill``: a closed loop of batches that each hold ``tokens_per_batch``
  prompt tokens, B = tokens_per_batch / S requests of S tokens, each
  returning its first token only.  The
  lengths come in shuffled rounds: each round runs every length once, in
  an order drawn from the seed, so every window holds them in near-equal
  numbers whatever the seed.
- ``decode``: a closed loop of batches of ``batch`` requests, each a
  prompt of ``prompt_len`` tokens that generates ``new_tokens`` greedily
  into a cache of ``prompt_len + new_tokens + cache_slack`` positions.  A
  pool in its steady state meets its requests part of the way through:
  the first ``generated_before`` of the generated tokens (0 where the mix
  does not name it) are drawn from the seed like the prompt and prefilled
  with it, so a ``Batch`` of the mix has ``length`` = prompt_len +
  generated_before tokens prefilled and ``new_tokens`` = new_tokens -
  generated_before still to generate.  A batch follows the last when it is
  done.

Token ids are uniform over the vocabulary, drawn on the device by a
generator seeded from the run's seed and the batch's index, so a batch's
prompts do not depend on what came before.
"""
from __future__ import annotations

import dataclasses
from collections.abc import Iterator

import numpy as np
import torch

# streams of random numbers drawn from one seed
STREAM_ORDER, STREAM_WEIGHTS, STREAM_PROMPTS, STREAM_WARM, STREAM_SAMPLE = \
    range(5)


def subseed(seed: int, stream: int, index: int = 0) -> int:
    """A seed of its own for ``stream`` (and a batch ``index`` in it),
    under 2**63, for any non-negative run seed."""
    ss = np.random.SeedSequence([seed, stream, index])
    return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))


@dataclasses.dataclass(frozen=True)
class Batch:
    index: int
    batch: int          # requests
    length: int         # tokens a request prefills
    new_tokens: int     # tokens each request generates after its prefill


def batches(mix: dict, seed: int) -> Iterator[Batch]:
    """The batches of ``mix`` in the order a run hands them over, without
    end."""
    index = 0
    if mix["kind"] == "prefill":
        lengths = list(mix["lengths"])
        total = mix["tokens_per_batch"]
        if any(total % s for s in lengths):
            raise ValueError(f"{total} tokens do not split into batches of "
                             f"{lengths}")
        rng = np.random.default_rng(subseed(seed, STREAM_ORDER))
        while True:
            for s in rng.permutation(lengths):
                yield Batch(index, total // int(s), int(s), 1)
                index += 1
    elif mix["kind"] == "decode":
        before = mix.get("generated_before", 0)
        if not 0 <= before < mix["new_tokens"]:
            raise ValueError(f"generated_before {before} is not under "
                             f"new_tokens {mix['new_tokens']}")
        while True:
            yield Batch(index, mix["batch"], mix["prompt_len"] + before,
                        mix["new_tokens"] - before)
            index += 1
    else:
        raise ValueError(f"unknown traffic kind {mix['kind']!r}")


def shapes(mix: dict) -> list[tuple[int, int]]:
    """Every (batch, length) the mix hands over, each once."""
    if mix["kind"] == "prefill":
        return [(mix["tokens_per_batch"] // s, s) for s in mix["lengths"]]
    return [(mix["batch"],
             mix["prompt_len"] + mix.get("generated_before", 0))]


def prompts(b: Batch, vocab: int, seed: int, device,
            stream: int = STREAM_PROMPTS) -> torch.Tensor:
    """(b.batch, b.length) int64 token ids of batch ``b``."""
    gen = torch.Generator(device=device).manual_seed(
        subseed(seed, stream, b.index))
    return torch.randint(0, vocab, (b.batch, b.length), generator=gen,
                         device=device)
