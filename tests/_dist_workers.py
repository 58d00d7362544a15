"""Worker side of the port's multi-process ``torch.distributed`` tests
(``tests/test_torch_dist.py``): ``spawn_group`` starts one process a rank
on a gloo group, each runs the named checks, and a worker's traceback is
raised again in the test.

Every check runs on every rank and asserts there; the data each rank
holds is made from a seed with numpy, so each rank can also compute what
every other rank holds and the expected result without communication.
"""
from __future__ import annotations

import dataclasses
import datetime
import multiprocessing
import os
import time
import traceback
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

# a collective that waits past this raises in the worker, so that one
# failing rank cannot leave the others waiting beyond the test's timeout
COLLECTIVE_TIMEOUT_S = 60


def spawn_group(tmp_path: Path, world: int, checks: list[str],
                timeout_s: float) -> None:
    """Run ``checks`` (names of functions in this module) on ``world``
    spawned processes joined by a gloo group on a ``FileStore`` under
    ``tmp_path``.  Fails with the first worker's traceback, or when the
    group has not finished within ``timeout_s`` (its processes are killed
    then)."""
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=run, args=(rank, world, str(tmp_path),
                                           checks), daemon=True)
             for rank in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout_s
    for p in procs:
        p.join(max(deadline - time.monotonic(), 0.0))
    hung = [i for i, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join(10)
    errors = [f"rank {r}:\n{(tmp_path / f'error.{r}').read_text()}"
              for r in range(world) if (tmp_path / f"error.{r}").exists()]
    if errors:
        raise AssertionError("\n".join(errors))
    assert not hung, f"ranks {hung} did not finish within {timeout_s} s"
    codes = [p.exitcode for p in procs]
    assert codes == [0] * world, f"worker exit codes {codes}"
    for r in range(world):
        assert (tmp_path / f"done.{r}").read_text().split() == checks


def run(rank: int, world: int, directory: str, checks: list[str]) -> None:
    """One rank: join the group, run every check in order, record each
    one that passed (``done.<rank>``) or the traceback (``error.<rank>``)."""
    d = Path(directory)
    torch.set_num_threads(1)
    try:
        store = dist.FileStore(str(d / "store"), world)
        dist.init_process_group(
            "gloo", store=store, rank=rank, world_size=world,
            timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S))
        done = []
        for name in checks:
            globals()[name](rank, world, d)
            done.append(name)
        (d / f"done.{rank}").write_text(" ".join(done))
    except BaseException:
        (d / f"error.{rank}").write_text(traceback.format_exc())
        os._exit(1)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


# ----------------------------- the checks ----------------------------- #
PLANS = [(1, 1, 1), (3, 2, 1), (3, 2, 4), (2, 2, 9), (5, 1, 2)]


def _rank_vector(rank: int, n: int, integer: bool) -> np.ndarray:
    rng = np.random.default_rng(100 + rank)
    if integer:
        return rng.integers(-1000, 1000, n).astype(np.float32)
    return (rng.normal(size=n) * (1 + rank)).astype(np.float32)


def bucketed_sum(rank: int, world: int, directory: Path) -> None:
    """``bucketed_allreduce`` equals the float32 sum of every rank's
    vector, bit for bit: integer values, so the order of the sum cannot
    matter."""
    from repro_torch.dist.collectives import BucketPlan, bucketed_allreduce
    for n in (37, 1000, 1):
        want = sum(_rank_vector(r, n, True) for r in range(world))
        mine = torch.from_numpy(_rank_vector(rank, n, True))
        for plan in PLANS:
            got = bucketed_allreduce(mine, BucketPlan(*plan))
            assert torch.equal(mine, torch.from_numpy(
                _rank_vector(rank, n, True))), "the input was written"
            np.testing.assert_array_equal(got.numpy(), want,
                                          err_msg=f"n={n} plan={plan}")


def quantized_formula(vectors: list[np.ndarray], n_chunks: int, depth: int
                      ) -> np.ndarray:
    """The reference's int8 all-reduce in numpy: per chunk, the global max
    of every rank's scale max|x| / 127 + 1e-12, each rank's x quantized to
    round(x / scale) clipped to +-127 in int8, summed in int32, times the
    scale.  ``depth`` only groups the chunks into waves, which changes no
    value."""
    del depth
    f32 = np.float32
    n = vectors[0].size
    per = -(-n // n_chunks)

    def chunked(v):
        return np.pad(v, (0, n_chunks * per - n)).reshape(n_chunks, per)

    blocks = [chunked(v) for v in vectors]
    scales = np.max([np.max(np.abs(b), axis=1) / f32(127.0) + f32(1e-12)
                     for b in blocks], axis=0).astype(f32)
    total = np.zeros((n_chunks, per), np.int32)
    for b in blocks:
        q = np.clip(np.round(b / scales[:, None]), -127, 127).astype(np.int8)
        total += q.astype(np.int32)
    out = total.astype(f32) * scales[:, None]
    return out.reshape(-1)[:n]


def quantized_sum(rank: int, world: int, directory: Path) -> None:
    """``quantized_allreduce`` equals ``quantized_formula`` bit for bit."""
    from repro_torch.dist.collectives import BucketPlan, quantized_allreduce
    for n in (257, 37, 1000):
        vectors = [_rank_vector(r, n, False) for r in range(world)]
        mine = torch.from_numpy(vectors[rank].copy())
        for plan in PLANS:
            bp = BucketPlan(*plan)
            got = quantized_allreduce(mine, bp)
            want = quantized_formula(vectors, bp.n_chunks, bp.pipeline_depth)
            np.testing.assert_array_equal(got.numpy(), want,
                                          err_msg=f"n={n} plan={plan}")
    empty = torch.zeros(0)
    assert quantized_allreduce(empty, BucketPlan(2, 2)) is empty


def _tanh_stack(n_layers: int, d: int) -> dict:
    rng = np.random.default_rng(0)
    return {"w": torch.from_numpy(
        (rng.normal(size=(n_layers, d, d)) * 0.3).astype(np.float32))}


def _tanh_slice(params: dict, x: torch.Tensor) -> torch.Tensor:
    for w in params["w"]:
        x = torch.tanh(x @ w)
    return x


def pipeline_stages(rank: int, world: int, directory: Path) -> None:
    """``make_pipeline_fn`` with one stage a rank equals the sequential
    stack on every microbatch, on every rank (float32, rtol 1e-6: the same
    products in the same order, so equal but for the BLAS's blocking)."""
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.dist.pipeline_par import (PipelineConfig,
                                               make_pipeline_fn,
                                               split_stages)
    mesh = init_device_mesh("cpu", (world,), mesh_dim_names=("stage",))
    stacked = _tanh_stack(2 * world, 8)
    for n_micro in (1, 3, 6):
        xs = torch.from_numpy(np.random.default_rng(n_micro).normal(
            size=(n_micro, 5, 8)).astype(np.float32))
        fn = make_pipeline_fn(_tanh_slice, mesh,
                              PipelineConfig(world, n_micro))
        got = fn(split_stages(stacked, world), xs)
        want = torch.stack([_tanh_slice(stacked, x) for x in xs])
        torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-7)


def _mini_cfg():
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config("minitron-4b", "smoke"),
                               remat=False, dtype=torch.float32)


def data_parallel_step(rank: int, world: int, directory: Path) -> None:
    """The sharded step on a (world, 1) mesh, each rank computing its
    block of the batch, against the one-process step on the whole batch:
    loss, gradient norm and every parameter after 2 steps within 1e-6 of
    their scale (float32; the two sum the batch's gradients in other
    orders).  The optimizer state rests sharded over ``data``, and every
    rank's parameters stay equal."""
    from torch.distributed.tensor import DTensor
    from repro_torch.dist.collectives import BucketPlan
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.model import build_model
    from repro_torch.optim import AdamWConfig
    from repro_torch.train.loop import (TrainConfig, init_train_state,
                                        make_train_step)
    cfg = _mini_cfg()
    tcfg = TrainConfig(opt=AdamWConfig(moment_dtype=torch.float32, lr=1e-3),
                       warmup_steps=1, total_steps=6)
    mesh = make_host_mesh(device="cpu")
    assert tuple(mesh.shape) == (world, 1)
    runs = []
    for m in (None, mesh):
        model = build_model(cfg, "cpu", seed=None)
        _, opt = init_train_state(model, 0, tcfg)
        step = make_train_step(model, tcfg, mesh=m, plan=BucketPlan(3, 2, 2))
        log = []
        for i in range(2):
            rng = np.random.default_rng(20 + i)
            tok = torch.from_numpy(rng.integers(0, cfg.vocab_size, (4, 16)))
            opt, met = step(opt, {"tokens": tok, "labels": tok})
            log.append({k: float(v) for k, v in met.items()})
        runs.append((model, opt, log))
    (whole, _, want), (shard, opt, got) = runs
    for a, b in zip(got, want):
        for key in ("loss", "ce", "grad_norm", "lr_scale"):
            assert abs(a[key] - b[key]) <= 1e-6 * abs(b[key]), (key, a, b)
    for (name, p), q in zip(shard.named_parameters(), whole.parameters()):
        gap = (p - q).abs().max().item()
        assert gap <= 1e-6 * q.abs().max().item(), (name, gap)
        mine = p.detach().clone()
        dist.broadcast(mine, 0)
        assert torch.equal(mine, p.detach()), f"{name} differs across ranks"
    master = opt["master"]["layers.0.attn.wq"]
    assert isinstance(master, DTensor)
    assert master.to_local().shape[0] == cfg.d_model // world
    assert int(opt["step"].to_local()) == 2


def reshard_round_trip(rank: int, world: int, directory: Path) -> None:
    """``recover`` onto a (world, 1) mesh: each rank's local shards are
    its blocks of the saved tensors, and ``full_tensor`` gives them back
    bit for bit."""
    from repro_torch.checkpoint.ckpt import save_checkpoint
    from repro_torch.models.model import build_model
    from repro_torch.models.params import reference_paths
    from repro_torch.train import elastic
    model = build_model(_mini_cfg(), "cpu", seed=3)
    axes = model.param_axes()
    saved = reference_paths(dict(model.named_parameters()))
    ckpt = directory / "ckpt"
    if rank == 0:
        save_checkpoint(str(ckpt), 1, saved)
    dist.barrier()
    plan, mesh, state = elastic.recover(str(ckpt), axes, list(range(world)),
                                        model_parallel=1, device="cpu")
    assert plan.shape == (world, 1) and tuple(mesh.shape) == (world, 1)
    for path, want in saved.items():
        got = state[path]
        assert torch.equal(got.full_tensor(), want.detach()), path
    wq = state["layers.attn.wq"]           # ("layers", "embed", ...): data
    assert wq.to_local().shape[1] == wq.shape[1] // world

