"""The port's checkpoint writer, its tuner and the token pipeline against the
JAX package's (``repro.checkpoint``, ``repro.data.pipeline``).

- Checkpoints: ``tests/test_distribution.py``'s round trip, pruning and
  crash safety, on torch leaves; a checkpoint of float32, int32 and
  bfloat16 leaves written by either package restores bit for bit in the
  other, with equal manifests, and bfloat16 arrives as ``torch.bfloat16``
  (the port needs no ``ml_dtypes``; the reference's side of the test does).
- ``CheckpointTuner``: the same recommendation in both packages from one
  fixed ``transfers.jsonl``; real save timings differ from run to run, so
  the decision is compared on a log the test writes, not on timings.
- ``TokenPipeline``: ``_gen_shard`` bit for bit, and the batch sequence at
  ``cc = 1``.  With more workers ``next_batch`` returns batches in the order
  the workers finish, so each batch is compared only to the reference's
  batches of the indices it can have.
"""
import json
import os

import ml_dtypes
import numpy as np
import pytest
import torch

from repro.checkpoint import ckpt as jckpt
from repro.checkpoint import tuning as jtuning
from repro.data import pipeline as jpipe
from repro_torch.checkpoint import ckpt as pckpt
from repro_torch.checkpoint import tuning as ptuning
from repro_torch.data import pipeline as ppipe
from repro_torch.models.params import paths_from_tree


def _torch_tree():
    g = torch.Generator().manual_seed(0)
    return {"layers": {"w": torch.arange(1000, dtype=torch.float32).reshape(10, 100),
                       "b": torch.ones((7,), dtype=torch.float32),
                       "idx": torch.arange(-20, 13, dtype=torch.int32)},
            "embed": torch.randn((64, 8), generator=g).to(torch.bfloat16),
            "scalar": torch.tensor(3.5, dtype=torch.float32)}


def _numpy_tree(tree):
    """The same leaves as the reference holds them (bfloat16 by
    ``ml_dtypes``)."""
    out = {}
    for path, t in paths_from_tree(tree).items():
        if t.dtype == torch.bfloat16:
            out[path] = t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
        else:
            out[path] = t.numpy()
    return out


def _bits(x) -> bytes:
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            x = x.view(torch.int16)
        return x.contiguous().numpy().tobytes()
    return np.ascontiguousarray(x).tobytes()


def _manifest(directory, step):
    with open(os.path.join(directory, f"step_{step:08d}", "manifest.json")) as fh:
        return json.load(fh)


# ---------------------------- checkpointing --------------------------- #
def test_checkpoint_roundtrip_and_pruning(tmp_path):
    tree = _torch_tree()
    d = str(tmp_path / "ckpt")
    log = str(tmp_path / "log.jsonl")
    for step in (1, 2, 3, 4):
        stats = pckpt.save_checkpoint(d, step, tree,
                                      params=pckpt.CkptParams(cc=3, p=2, pp=2),
                                      log_path=log)
        assert stats["throughput_mbps"] > 0
    assert pckpt.latest_step(d) == 4
    back = pckpt.restore_checkpoint(d, device="cpu")
    for path, want in paths_from_tree(tree).items():
        got = paths_from_tree(back)[path]
        assert got.dtype == want.dtype and got.shape == want.shape
        assert got.device.type == "cpu"
        assert torch.equal(got, want), path
    pckpt.prune_checkpoints(d, keep=2)
    assert pckpt.latest_step(d) == 4
    assert len(os.listdir(d)) == 2
    # transfer log accumulated for offline tuning
    assert sum(1 for _ in open(log)) == 4


def test_checkpoint_crash_safety(tmp_path):
    """An interrupted save (temp dir left behind) must not break restore."""
    tree = {"w": torch.ones((16,), dtype=torch.float32)}
    d = str(tmp_path / "ckpt")
    pckpt.save_checkpoint(d, 1, tree)
    os.makedirs(os.path.join(d, ".tmp_step_00000002"))  # simulated crash
    assert pckpt.latest_step(d) == 1
    back = pckpt.restore_checkpoint(d, device="cpu")
    assert torch.equal(back["w"], tree["w"])
    with pytest.raises(FileNotFoundError):
        pckpt.restore_checkpoint(str(tmp_path / "empty"), device="cpu")


@pytest.mark.parametrize("prm", [(1, 1, 1), (3, 2, 2), (4, 5, 1)])
def test_port_checkpoint_restores_in_the_reference(prm, tmp_path):
    tree = _torch_tree()
    pd, jd = str(tmp_path / "port"), str(tmp_path / "ref")
    pckpt.save_checkpoint(pd, 7, tree, params=pckpt.CkptParams(*prm))
    jckpt.save_checkpoint(jd, 7, _numpy_tree(tree),
                          params=jckpt.CkptParams(*prm))
    assert _manifest(pd, 7) == _manifest(jd, 7)
    assert sorted(os.listdir(os.path.join(pd, "step_00000007"))) == sorted(
        os.listdir(os.path.join(jd, "step_00000007")))
    back = paths_from_tree(jckpt.restore_checkpoint(pd))
    for path, want in paths_from_tree(tree).items():
        assert back[path].shape == tuple(want.shape)
        assert _bits(back[path]) == _bits(want), path
    assert back["embed"].dtype == np.dtype(ml_dtypes.bfloat16)


@pytest.mark.parametrize("prm", [(1, 1, 1), (3, 2, 2), (4, 5, 1)])
def test_reference_checkpoint_restores_in_the_port(prm, tmp_path):
    tree = _torch_tree()
    jd = str(tmp_path / "ref")
    jckpt.save_checkpoint(jd, 3, _numpy_tree(tree),
                          params=jckpt.CkptParams(*prm))
    back = paths_from_tree(pckpt.restore_checkpoint(
        jd, params=pckpt.CkptParams(*prm), device="cpu"))
    for path, want in paths_from_tree(tree).items():
        assert back[path].dtype == want.dtype, path
        assert back[path].shape == want.shape
        assert _bits(back[path]) == _bits(want), path
    assert back["layers.idx"].dtype == torch.int32
    assert back["embed"].dtype == torch.bfloat16


def test_float8_leaves_round_trip_by_their_ml_dtypes_names(tmp_path):
    """The port names float8 leaves as ``ml_dtypes`` does and writes their
    bits unsigned, so they come back bit for bit, and the reference reads
    ``float8_e4m3fn`` as its own.  ``float8_e5m2`` it cannot: ``ml_dtypes``
    gives that type kind "f", so the reference's writer saves it as "<f1",
    which numpy cannot load back, and its reader casts a "u1" payload by
    value; the port keeps the reference's on-disk form for every type
    numpy lacks (bits, unsigned), which is what the reference meant."""
    src = torch.linspace(-3.0, 3.0, 40)
    tree = {"e4m3": src.to(torch.float8_e4m3fn),
            "e5m2": src.to(torch.float8_e5m2)}
    d = str(tmp_path / "ckpt")
    pckpt.save_checkpoint(d, 1, tree)
    man = _manifest(d, 1)
    assert man["e4m3"]["dtype"] == "float8_e4m3fn"
    assert man["e5m2"]["dtype"] == "float8_e5m2"
    back = pckpt.restore_checkpoint(d, device="cpu")
    for name, t in tree.items():
        assert back[name].dtype == t.dtype
        assert torch.equal(back[name].view(torch.uint8), t.view(torch.uint8))
    ref = jckpt.restore_checkpoint(d)
    assert ref["e4m3"].dtype == np.dtype(ml_dtypes.float8_e4m3fn)
    assert ref["e4m3"].tobytes() == tree["e4m3"].view(torch.uint8).numpy().tobytes()
    assert np.dtype(ml_dtypes.float8_e5m2).kind == "f"


def test_transfer_log_records_have_the_reference_keys(tmp_path):
    tree = _torch_tree()
    plog, jlog = str(tmp_path / "p.jsonl"), str(tmp_path / "j.jsonl")
    ps = pckpt.save_checkpoint(str(tmp_path / "p"), 5, tree, log_path=plog)
    js = jckpt.save_checkpoint(str(tmp_path / "j"), 5, _numpy_tree(tree),
                               log_path=jlog)
    assert list(ps) == list(js)
    rec_p = json.loads(open(plog).read())
    rec_j = json.loads(open(jlog).read())
    assert list(rec_p) == list(rec_j)
    for key in ("step", "bytes", "cc", "p", "pp", "n_arrays"):
        assert rec_p[key] == rec_j[key], key
    # both logs adapt to the offline phase's schema alike
    assert ptuning._entry_from_stats(rec_p).n_files == \
        jtuning._entry_from_stats(rec_j).n_files


def _fixed_log(path):
    """Twelve save records with made-up but fixed rates: more writers and
    deeper queues help up to a point, as on a real disk."""
    rng = np.random.default_rng(4)
    combos = [(1, 1, 1), (2, 2, 2), (4, 2, 4), (8, 2, 4), (4, 4, 4),
              (16, 4, 4), (2, 8, 8), (8, 8, 2), (3, 5, 7), (12, 1, 3),
              (6, 6, 6), (10, 3, 1)]
    with open(path, "w") as fh:
        for i, (cc, p, pp) in enumerate(combos):
            rate = (4000.0 * min(cc, 8) ** 0.5 * (1 + 0.05 * min(pp, 4))
                    - 60.0 * p + rng.normal(0, 50.0))
            fh.write(json.dumps({
                "step": 10_000 + i, "bytes": 16_000_000, "elapsed_s": 0.01,
                "throughput_mbps": rate, "cc": cc, "p": p, "pp": pp,
                "n_arrays": 16}) + "\n")


def test_checkpoint_tuner_recommends_as_the_reference_from_one_log(tmp_path):
    log = str(tmp_path / "transfers.jsonl")
    _fixed_log(log)
    want = jtuning.CheckpointTuner(log).fit().recommend()
    got = ptuning.CheckpointTuner(log, device="cpu").fit().recommend()
    assert (got.cc, got.p, got.pp) == (want.cc, want.p, want.pp)
    b, jb = ptuning.ckpt_bounds(), jtuning.ckpt_bounds()
    assert (b.max_cc, b.max_p, b.max_pp) == (jb.max_cc, jb.max_p, jb.max_pp)


def test_checkpoint_tuner_seed_history_saves_torch_trees(tmp_path):
    g = torch.Generator().manual_seed(1)
    tree = {f"l{i}": torch.randn(2_000, generator=g) for i in range(4)}
    log = str(tmp_path / "log.jsonl")
    tuner = ptuning.CheckpointTuner(log, device="cpu")
    stats = tuner.seed_history(tree, str(tmp_path / "seed"), n_probes=10)
    assert len(stats) == 10 and all(s["bytes"] == 32_000 for s in stats)
    rec = tuner.fit().recommend()
    b = ptuning.ckpt_bounds()
    assert 1 <= rec.cc <= b.max_cc and 1 <= rec.p <= b.max_p
    assert 1 <= rec.pp <= b.max_pp
    back = pckpt.restore_checkpoint(str(tmp_path / "seed"), device="cpu")
    assert all(torch.equal(back[k], v) for k, v in tree.items())


# --------------------------- data pipeline ---------------------------- #
CFG = dict(vocab_size=100, global_batch=8, seq_len=16, seed=3)


def test_token_pipeline_determinism_and_prefetch():
    cfg = ppipe.DataConfig(**CFG)
    p1 = ppipe.TokenPipeline(cfg, ppipe.PipelineParams(cc=2, p=2, pp=3))
    batches1 = [p1.next_batch() for _ in range(3)]
    p1.close()
    for b in batches1:
        assert b["tokens"].shape == (8, 16)
        assert b["tokens"].min() >= 0 and b["tokens"].max() < 100
    # pipeline keeps producing under prefetch pressure
    p2 = ppipe.TokenPipeline(cfg, ppipe.PipelineParams(cc=1, p=1, pp=1))
    tput = p2.measure_throughput(n_batches=4)
    p2.close()
    assert tput > 0


@pytest.mark.parametrize("codebooks", [0, 4])
def test_gen_shard_is_the_references_bit_for_bit(codebooks):
    cfg = dict(CFG, n_codebooks=codebooks)
    port = ppipe.TokenPipeline(ppipe.DataConfig(**cfg),
                               ppipe.PipelineParams(cc=1, p=1, pp=1))
    ref = jpipe.TokenPipeline(jpipe.DataConfig(**cfg),
                              jpipe.PipelineParams(cc=1, p=1, pp=1))
    try:
        for idx, shard, rows in ((0, 0, 8), (5, 1, 3), (123, 2, 5)):
            a = port._gen_shard(idx, shard, rows)
            b = ref._gen_shard(idx, shard, rows)
            assert a.dtype == b.dtype == np.int32
            assert np.array_equal(a, b)
    finally:
        port.close()
        ref.close()


@pytest.mark.parametrize("p", [1, 3])
def test_batches_at_one_worker_are_the_references(p):
    prm = dict(cc=1, p=p, pp=2)
    port = ppipe.TokenPipeline(ppipe.DataConfig(**CFG), ppipe.PipelineParams(**prm))
    ref = jpipe.TokenPipeline(jpipe.DataConfig(**CFG), jpipe.PipelineParams(**prm))
    try:
        for _ in range(6):
            a, b = port.next_batch(), ref.next_batch()
            assert np.array_equal(a["tokens"], b["tokens"])
            assert np.array_equal(a["labels"], b["labels"])
    finally:
        port.close()
        ref.close()


def test_batches_at_many_workers_come_from_the_references_indices():
    """At cc > 1 batch n is one of the reference's batches of index below
    n + cc (pp + 1): at most cc (pp + 1) batches are claimed ahead of it,
    in the queue or in the workers' hands."""
    prm = dict(cc=3, p=2, pp=2)
    cfg = ppipe.DataConfig(**CFG)
    port = ppipe.TokenPipeline(cfg, ppipe.PipelineParams(**prm))
    ref = jpipe.TokenPipeline(jpipe.DataConfig(**CFG),
                              jpipe.PipelineParams(cc=1, p=2, pp=1))
    try:
        want = [ref.next_batch()["tokens"] for _ in range(40)]
        got = [port.next_batch()["tokens"] for _ in range(12)]
    finally:
        port.close()
        ref.close()
    seen = set()
    for n, tokens in enumerate(got):
        ahead = n + prm["cc"] * (prm["pp"] + 1)
        hits = [i for i in range(ahead) if np.array_equal(tokens, want[i])]
        assert hits, n
        seen.add(hits[0])
    assert len(seen) == len(got)          # no batch twice
