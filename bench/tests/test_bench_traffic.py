"""The traffic generator: rounds, seeds, prompts and the kept sample."""
from __future__ import annotations

import itertools

import numpy as np
import pytest
import torch

from bench import check, harness, traffic

SEEDS = (0, 7, 2 ** 31 + 5, 2 ** 40 + 3)


@pytest.mark.parametrize("mix_name", ["prefill_pool", "prefill_long"])
@pytest.mark.parametrize("seed", SEEDS)
def test_prefill_rounds_hold_every_length_once(mix_name, seed):
    mix = harness.load("traffic", mix_name)
    n = len(mix["lengths"])
    got = list(itertools.islice(traffic.batches(mix, seed), 20 * n))
    assert [b.index for b in got] == list(range(20 * n))
    for r in range(20):
        rnd = got[r * n:(r + 1) * n]
        assert sorted(b.length for b in rnd) == sorted(mix["lengths"])
        assert all(b.batch * b.length == mix["tokens_per_batch"] for b in rnd)


def test_rounds_follow_the_seed():
    mix = harness.load("traffic", "prefill_pool")

    def order(seed):
        return [b.length for b in itertools.islice(traffic.batches(mix, seed),
                                                   50)]
    assert order(11) == order(11)
    assert order(11) != order(12)


def test_decode_mix_repeats_its_batch():
    mix = harness.load("traffic", "decode_pool")
    got = list(itertools.islice(traffic.batches(mix, 3), 3))
    # met half way: 1,024 prompt tokens and 1,024 generated ones prefilled,
    # 1,024 still to generate, into a cache of 1,024 + 2,048 + 4
    assert [(b.index, b.batch, b.length, b.new_tokens) for b in got] == [
        (i, 64, 2048, 1024) for i in range(3)]
    assert got[0].length + got[0].new_tokens + mix["cache_slack"] == 3076
    assert traffic.shapes(mix) == [(64, 2048)]


@pytest.mark.parametrize("before", [0, 1, 63])
def test_decode_mix_meets_requests_where_it_says(before):
    mix = dict(kind="decode", batch=4, prompt_len=16, new_tokens=64,
               cache_slack=4, generated_before=before)
    b = next(traffic.batches(mix, 5))
    assert (b.length, b.new_tokens) == (16 + before, 64 - before)
    if before == 0:
        mix.pop("generated_before")
        assert next(traffic.batches(mix, 5)) == b


def test_decode_mix_refuses_a_request_met_after_its_end():
    mix = dict(kind="decode", batch=4, prompt_len=16, new_tokens=64,
               cache_slack=4, generated_before=64)
    with pytest.raises(ValueError):
        next(traffic.batches(mix, 5))


def test_shapes_are_the_mix_s():
    mix = harness.load("traffic", "prefill_pool")
    assert traffic.shapes(mix) == [(32, 512), (16, 1024), (8, 2048),
                                   (4, 4096), (2, 8192)]


@pytest.mark.parametrize("seed", SEEDS)
def test_prompts_follow_seed_and_batch(seed):
    b = traffic.Batch(5, 3, 40, 1)
    a = traffic.prompts(b, 1000, seed, "cpu")
    assert a.shape == (3, 40) and a.dtype == torch.int64
    assert int(a.min()) >= 0 and int(a.max()) < 1000
    assert torch.equal(a, traffic.prompts(b, 1000, seed, "cpu"))
    other = traffic.Batch(6, 3, 40, 1)
    assert not torch.equal(a, traffic.prompts(other, 1000, seed, "cpu"))
    warm = traffic.prompts(b, 1000, seed, "cpu", stream=traffic.STREAM_WARM)
    assert not torch.equal(a, warm)


def test_subseeds_fit_a_generator_and_differ():
    seen = {traffic.subseed(s, k, i) for s in SEEDS for k in range(5)
            for i in range(3)}
    assert len(seen) == len(SEEDS) * 15
    assert all(0 <= s < 2 ** 63 for s in seen)


@pytest.mark.parametrize("B", [1, 2, 4, 32])
def test_kept_row_alternates_halves(B):
    rows = [harness.kept_row(traffic.Batch(i, B, 64, 1), 9, i)
            for i in range(40)]
    assert all(0 <= r < B for r in rows)
    if B > 1:
        assert all(r < B // 2 for r in rows[0::2])
        assert all(r >= B // 2 for r in rows[1::2])


@pytest.mark.parametrize("S,n", [(8, 16), (16, 16), (8192, 64)])
def test_kv_positions(S, n):
    c = harness.cell("minitron-4b.prefill-long")
    c.sample["kv_positions"] = n
    got = harness.picks(traffic.Batch(3, 1, S, 1), 5, c)
    assert set(got) == {"k", "v"} and torch.equal(got["k"], got["v"])
    pos = got["k"].tolist()
    assert pos == sorted(set(pos)) and len(pos) == min(S, n)
    assert 0 <= pos[0] and pos[-1] == S - 1
    if S > n:
        assert pos[-(n // 2):] == list(range(S - n // 2, S))


def test_ssm_heads_are_drawn_where_the_sample_names_them():
    c = harness.cell("zamba2-7b.prefill")
    got = harness.picks(traffic.Batch(4, 2, 8192, 1), 5, c)
    heads = got["ssm"].tolist()
    assert len(heads) == c.sample["ssm_heads"] == len(set(heads))
    assert 0 <= min(heads) and max(heads) < 112
    other = harness.picks(traffic.Batch(5, 2, 8192, 1), 5, c)["ssm"]
    assert not torch.equal(got["ssm"], other)


@pytest.mark.parametrize("B,n", [(64, 8), (4, 4), (2, 8), (1, 8)])
def test_decode_rows_take_both_halves(B, n):
    rows = check.decode_rows(B, n, 4, 0)
    assert rows == sorted(set(rows)) and all(0 <= r < B for r in rows)
    if B > 1:
        assert any(r < B // 2 for r in rows) and any(r >= B // 2 for r in rows)


def test_select_takes_the_longest_then_a_budget():
    def kept(i, S):
        b = traffic.Batch(i, 16384 // S, S, 1)
        return check.Kept(b, harness.kept_row(b, 3, i), torch.zeros(1), {},
                          {})
    ks = [kept(i, S) for i, S in enumerate([512, 8192, 1024, 8192, 2048,
                                              4096, 512])]
    got = check.select(ks, 3, 12000)
    assert got[0].batch.index == 1 or any(k.batch.index == 1 for k in got)
    assert sum(k.batch.length for k in got) <= 12000
    assert [k.batch.index for k in got] == sorted(k.batch.index for k in got)
    assert check.select(ks, 3, 12000) == got
    assert any(k.row >= k.batch.batch // 2 > 0 for k in got)
    assert check.select([], 3, 100) == []


def test_rng_is_numpy_s_pcg():
    # the rounds' order is drawn by numpy's default generator: a change of
    # generator would change every seed's traffic
    assert isinstance(np.random.default_rng(0).bit_generator, np.random.PCG64)


@pytest.mark.parametrize("path", sorted((harness.BENCH / "traffic")
                                        .glob("*.json")))
def test_every_mix_says_where_it_comes_from(path):
    src = harness.load("traffic", path.stem)["source"]
    assert src and "\n" not in src
    assert src.startswith("synthetic") or "arXiv" in src or "http" in src
