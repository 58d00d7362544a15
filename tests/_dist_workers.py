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
from torch.utils._python_dispatch import TorchDispatchMode

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
    """The sharded step on a (world, 1) mesh, the model cut over ``data``
    (``build_model(mesh=)``), each rank computing its block of the batch,
    against the one-process step on the whole batch: loss, gradient norm
    and every parameter after 2 steps, gathered over ``data``, within 1e-6
    of their scale (float32; the two sum the batch's gradients in other
    orders).  The optimizer state rests sharded over ``data``, and every
    rank's parameters that the rules leave whole over ``data`` stay
    equal."""
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
        model = build_model(cfg, "cpu", seed=None, mesh=m)
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
    got = _gathered(shard, {n: p.detach()
                            for n, p in shard.named_parameters()})
    assert any(hasattr(p, "data_cut") for p in shard.parameters())
    for (name, p), q in zip(shard.named_parameters(), whole.parameters()):
        gap = (got[name] - q).abs().max().item()
        assert gap <= 1e-6 * q.abs().max().item(), (name, gap)
        if hasattr(p, "data_cut"):
            continue
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
    bit for bit.  Then the optimizer state of a model cut over ``data`` on
    the (world, 1) mesh, after a step, gathered whole (the (1, 1) layout:
    what one rank holds), saved and recovered onto (world, 1): each
    recovered shard equals the cut state's block bit for bit."""
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
    _fsdp_state_round_trip(rank, world, directory)


def _fsdp_state_round_trip(rank: int, world: int, directory: Path) -> None:
    from repro_torch.checkpoint.ckpt import save_checkpoint
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.model import build_model
    from repro_torch.models.params import reference_path, reference_paths
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import elastic
    from repro_torch.train.loop import (TrainConfig, init_train_state,
                                        make_train_step, opt_state_axes)
    mesh = make_host_mesh(device="cpu")
    model = build_model(_mini_cfg(), "cpu", seed=None, mesh=mesh)
    tcfg = TrainConfig(opt=AdamWConfig(moment_dtype=torch.float32),
                       warmup_steps=1, total_steps=4)
    _, opt = init_train_state(model, 0, tcfg)
    step = make_train_step(model, tcfg, mesh=mesh)
    tok = torch.from_numpy(np.random.default_rng(9).integers(
        0, model.cfg.vocab_size, (4, 16)))
    opt, _ = step(opt, {"tokens": tok, "labels": tok})
    keys = ("m", "v", "master")
    cut = {k: {n: t.to_local() for n, t in opt[k].items()} for k in keys}
    whole = {k: reference_paths(_gathered(model, cut[k])) for k in keys}
    ckpt = directory / "ckpt_fsdp"
    if rank == 0:
        save_checkpoint(str(ckpt), 1, whole)
    dist.barrier()
    axes = opt_state_axes(model.param_axes())
    _, back_mesh, state = elastic.recover(str(ckpt), axes, list(range(world)),
                                          model_parallel=1, device="cpu")
    assert tuple(back_mesh.shape) == (world, 1)
    n_cut = 0
    for k in keys:
        for name, block in cut[k].items():
            path, stacked = reference_path(name)
            got = state[f"{k}.{path}"]
            assert torch.equal(got.full_tensor(), whole[k][path]), (k, path)
            local = got.to_local()
            if stacked:
                local = local[int(name.split(".")[1])]
            assert torch.equal(local, block), (k, name)
            n_cut += hasattr(model.get_parameter(name), "data_cut")
    assert n_cut > 0



# ------------------------ tensor parallelism -------------------------- #
# (the workers of ``tests/test_torch_tensor_parallel.py``: the test writes
# the reference's unsplit results, computed with JAX in its own process,
# to ``tp_case.pkl`` in the group's directory; each rank cuts its shard of
# the reference's weights through ``load_reference_params``)
# (2, 1) and (2, 2) cut the weights over ``data`` too (``dist.fsdp``)
TP_MESHES = {2: [((1, 2), ("data", "model")), ((2, 1), ("data", "model"))],
             4: [((2, 2), ("data", "model")),
                 ((2, 1, 2), ("pod", "data", "model"))]}


def _tp_case(directory: Path) -> dict:
    import pickle
    with open(directory / "tp_case.pkl", "rb") as f:
        return pickle.load(f)


def _tp_cfg(case: dict, dtype=torch.float32):
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config(case["arch"], "smoke"),
                               dtype=dtype, remat=False, **case["over"])


def _tp_model(case: dict, mesh, dtype=torch.float32):
    """The port's model split over ``mesh``'s ``model`` axis, each rank's
    blocks cut from the reference's weights."""
    from repro_torch.models.model import build_model
    from repro_torch.models.params import load_reference_params
    model = build_model(_tp_cfg(case, dtype), "cpu", seed=None, mesh=mesh)
    load_reference_params(model, case["params"])
    return model


def _gathered(model, tensors: dict) -> dict:
    """{name: whole value} of tensors keyed and cut as the model's
    parameters are (parameters, gradients, optimizer leaves), over
    ``data`` and ``model`` (``gather_cut``)."""
    from repro_torch.dist.tensor_parallel import gather_cut, model_group
    mg = model_group(model)
    own = dict(model.named_parameters())
    return {n: gather_cut(t, own[n], mg, model.fsdp)
            for n, t in tensors.items()}


def _close_to_scale(got: np.ndarray, want: np.ndarray, rtol: float,
                    what: str) -> None:
    gap = float(np.abs(got - want).max())
    scale = float(np.abs(want).max())
    assert gap <= rtol * scale, (what, gap, rtol * scale)


def _rel_l2(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want)
                 / max(np.linalg.norm(want), 1e-30))


def _tp_forward(case: dict, mesh, tag: str) -> None:
    """The whole batch on every rank, the model split: its parameters
    gathered over ``model`` (``gather_cut``) equal to the reference's bit
    for bit, the logits gathered within the case's bound of the
    reference's (``logits_tol`` of their scale), the loss within 1e-5,
    every gradient gathered within ``test_loss_and_grads_match_reference``'s
    bound of it."""
    from repro_torch.dist.tensor_parallel import model_group
    from repro_torch.models.model import loss_fn
    from repro_torch.models.params import reference_paths
    model = _tp_model(case, mesh).requires_grad_(True)
    params = reference_paths(_gathered(model, {
        n: p.detach() for n, p in model.named_parameters()}))
    for path, want in case["params"].items():     # gather_cut's round trip
        assert np.array_equal(params[path].numpy(), want), (tag, path)
    batch = {k: torch.from_numpy(v) for k, v in case["batch"].items()}
    logits, _ = model(batch["tokens"], batch.get("patch_embeds"))
    mg = model_group(model)
    if model.tp is not None:
        assert logits.shape[-1] == model.cfg.vocab_size // mg.size
        logits = model.tp.gather(logits)
    _close_to_scale(logits.detach().numpy(), case["logits"],
                    case["logits_tol"], f"{tag} logits")
    loss, _ = loss_fn(model, batch)
    loss.backward()
    assert abs(loss.item() - case["loss"]) <= 1e-5 * abs(case["loss"]), \
        (tag, loss.item(), case["loss"])
    # every rank ran the whole batch: a block cut over ``data`` left the
    # backward summed over the data ranks' equal gradients
    n_data = model.fsdp.size if model.fsdp is not None else 1
    grads = _gathered(model, {n: (p.grad if p.grad is not None
                                  else torch.zeros_like(p))
                                 / (n_data if hasattr(p, "data_cut") else 1)
                              for n, p in model.named_parameters()})
    got = reference_paths(grads)
    assert sorted(got) == sorted(case["grads"])
    for path, want in case["grads"].items():
        g = got[path].numpy()
        assert g.shape == want.shape, (tag, path, g.shape, want.shape)
        tol = case["grad_tol"][path]
        assert _rel_l2(g, want) <= tol, (tag, path, _rel_l2(g, want), tol)


def _tp_steps(case: dict, mesh, tag: str) -> None:
    """Three sharded steps (the batch over the mesh's batch axes, the
    model over ``model``) from the reference's weights and AdamW state:
    the metrics and every parameter, gathered, against the reference's
    steps, as ``test_train_steps_match_reference`` holds the unsplit
    step."""
    from repro_torch.models.params import (opt_state_from_reference,
                                           reference_paths)
    from repro_torch.optim import AdamWConfig
    from repro_torch.train.loop import TrainConfig, make_train_step
    model = _tp_model(case, mesh).requires_grad_(True)
    tt = TrainConfig(opt=AdamWConfig(moment_dtype=torch.float32, lr=1e-3,
                                     eps=case["eps"]),
                     warmup_steps=1, total_steps=6)
    opt = opt_state_from_reference(case["opt"], tt.opt, "cpu", model=model)
    step = make_train_step(model, tt, mesh=mesh)
    for i, want in enumerate(case["steps"]):
        batch = {k: torch.from_numpy(v) for k, v in want["batch"].items()}
        opt, met = step(opt, batch)
        for key in ("loss", "ce", "lr_scale"):
            w = want["metrics"][key]
            assert abs(float(met[key]) - w) <= 1e-5 * abs(w) + 1e-7, \
                (tag, i, key, float(met[key]), w)
        w = want["metrics"]["grad_norm"]
        assert abs(float(met["grad_norm"]) - w) <= want["norm_tol"] * w, \
            (tag, i, float(met["grad_norm"]), w, want["norm_tol"])
    got = reference_paths(_gathered(model, dict(model.named_parameters())))
    for path, w in case["final"].items():
        np.testing.assert_allclose(got[path].detach().numpy(), w, rtol=2e-4,
                                   atol=2e-5, err_msg=f"{tag} {path}")


def _tp_serve(case: dict, mesh, tag: str) -> None:
    """Prefill and 4 greedy decode steps on the rank's block of the
    prompts (``batch_block``; a mixture of experts routed over the whole
    batch, ``routed_over``), the model split: the gathered last-position
    logits within the case's bound (``logits_tol`` of their scale) of the
    reference's, and every greedy token equal."""
    from repro_torch.dist.sharding import batch_block
    from repro_torch.models.moe import routed_over
    from repro_torch.train.loop import _batch_group, batch_routing
    model = _tp_model(case, mesh)
    serve = case["serve"]
    prompt = serve["prompt"]
    index, count = batch_block(mesh, prompt.shape[0])
    rows = slice(index * prompt.shape[0] // count,
                 (index + 1) * prompt.shape[0] // count)
    pe = serve.get("patch_embeds")
    pe = None if pe is None else torch.from_numpy(pe[rows])
    cache = model.init_cache(prompt[rows].shape[0], serve["max_len"])
    _check_cache_share(model, cache)
    routing = batch_routing(_batch_group(mesh), index, count)
    with routed_over(model, routing):
        logits, cache = model.prefill(torch.from_numpy(prompt[rows]), cache,
                                      pe)
    for j, (want_lg, want_tok) in enumerate(zip(serve["logits"],
                                                serve["tokens"])):
        assert logits.shape[-1] == model.cfg.vocab_size
        _close_to_scale(logits.numpy(), want_lg[rows], serve["logits_tol"],
                        f"{tag} serve step {j}")
        tok = logits[:, -1].argmax(-1)[:, None]
        np.testing.assert_array_equal(tok.numpy(), want_tok[rows],
                                      err_msg=f"{tag} token {j}")
        if j + 1 < len(serve["logits"]):
            with routed_over(model, routing):
                logits, cache = model.decode(tok, cache)


def _check_cache_share(model, cache: dict) -> None:
    """The rank's cache keeps 1/n of the kv heads where they split, of the
    ssm heads and conv channels where Mamba2 splits, of the WKV heads
    where the time mix splits, and every other dim whole."""
    from repro_torch.dist.tensor_parallel import AttentionSplit, model_group
    from repro_torch.models.params import paths_from_tree
    mg = model_group(model)
    runs = model.split_plan.runs()
    split = {"layers.ssm": (2, runs.get("mamba2")),
             "layers.conv": (3, runs.get("mamba2")),
             "layers.wkv": (2, runs.get("time mix"))}
    blocks = model.attention_layers()
    tp = blocks[0].attn.tp if blocks else None
    kv = isinstance(tp, AttentionSplit) and tp.kv_index is None
    for name in ("layers", "dense_layers", "shared_attn"):
        split[f"{name}.k"] = split[f"{name}.v"] = (3, kv)
    whole = paths_from_tree(model.init_cache(1, 4, whole=True))
    for path, t in paths_from_tree(model.init_cache(1, 4)).items():
        dim, cut = split.get(path, (None, False))
        want = list(whole[path].shape)
        if cut:
            want[dim] //= mg.size
        assert list(t.shape) == want, (path, tuple(t.shape), want)


def tp_parity(rank: int, world: int, directory: Path) -> None:
    """For every mesh of ``TP_MESHES[world]`` (or of the case's own
    ``meshes``): the forward, the loss and the gradients, three train
    steps, and prefill with decode of the split model against the
    reference's unsplit results (``tp_case.pkl``)."""
    from torch.distributed.device_mesh import init_device_mesh
    case = _tp_case(directory)
    for shape, names in case.get("meshes", TP_MESHES[world]):
        mesh = init_device_mesh("cpu", shape, mesh_dim_names=names)
        tag = f"{case['name']} on {shape}"
        _tp_forward(case, mesh, tag)
        _tp_steps(case, mesh, tag)
        _tp_serve(case, mesh, tag)


def tp_norm_backward(rank: int, world: int, directory: Path) -> None:
    """zamba2-7b's smoke case on a (1, 2) mesh: with ``reduce_from``
    (identity backward) in place of ``sum_partial`` in the gated norm, the
    logits still match and the gradient of ``norm_w`` leaves the
    reference's bound; with ``sum_partial`` it is within it."""
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.dist import tensor_parallel as tp
    from repro_torch.models.model import loss_fn
    from repro_torch.models.params import reference_paths
    case = _tp_case(directory)
    mesh = init_device_mesh("cpu", (1, world), mesh_dim_names=("data",
                                                               "model"))
    batch = {k: torch.from_numpy(v) for k, v in case["batch"].items()}
    path = "layers.mixer.norm_w"
    want, tol = case["grads"][path], case["grad_tol"][path]
    gaps, right = {}, tp.sum_partial
    try:
        for name, fn in (("sum_partial", right),
                         ("reduce_from", tp.reduce_from)):
            tp.sum_partial = fn
            model = _tp_model(case, mesh).requires_grad_(True)
            logits, _ = model(batch["tokens"])
            _close_to_scale(model.tp.gather(logits).detach().numpy(),
                            case["logits"], case["logits_tol"], name)
            loss, _ = loss_fn(model, batch)
            loss.backward()
            grads = _gathered(model, {n: p.grad for n, p
                                      in model.named_parameters()})
            gaps[name] = _rel_l2(reference_paths(grads)[path].numpy(), want)
    finally:
        tp.sum_partial = right
    assert gaps["sum_partial"] <= tol < gaps["reduce_from"], (gaps, tol)


def tp_norm(rank: int, world: int, directory: Path) -> None:
    """The clip's global norm on a split model's gradients, each rank
    holding its blocks and the replicated leaves: the norm of the whole
    gradients, the split leaves counted once over ``model``, the
    replicated ones once (summing them over ``model`` as well reads
    sqrt(2) times their part)."""
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.configs import get_config
    from repro_torch.dist.tensor_parallel import all_reduce, model_group
    from repro_torch.models.model import build_model
    from repro_torch.optim.grad_utils import global_norm
    cfg = dataclasses.replace(get_config("qwen2-vl-2b", "smoke"),
                              dtype=torch.float32)
    mesh = init_device_mesh("cpu", (1, world), mesh_dim_names=("data",
                                                               "model"))
    model = build_model(cfg, "cpu", seed=3, mesh=mesh)
    whole = build_model(cfg, "cpu", seed=3)
    mg = model_group(model)
    params = dict(model.named_parameters())
    split = frozenset(n for n, p in params.items() if hasattr(p, "cut"))
    assert split and len(split) < len(params)
    def over_model(t):
        return all_reduce(t, mg)
    got = global_norm(params, {n: (over_model,) for n in split})
    want = global_norm(dict(whole.named_parameters()))
    assert abs(got.item() - want.item()) <= 1e-6 * want.item(), (got, want)
    twice = global_norm(params, {n: (over_model,) for n in params})
    assert twice.item() > want.item() * (1 + 1e-3), (twice, want)


def _pod_cfg():
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config("qwen2-vl-2b", "smoke"),
                               remat=False, dtype=torch.float32)


def pod_split_step(rank: int, world: int, directory: Path) -> None:
    """On a (2, 2, 1) ``("pod", "data", "model")`` mesh: each rank's rows
    are the block the reference's ``batch_sharding`` over ``("pod",
    "data")`` gives it (ranks that differ only in ``pod`` hold different
    rows), and 2 sharded steps of the model cut over ``data``
    (``build_model(mesh=)``) equal the one-process step on the whole batch
    (loss, gradient norm and every parameter, gathered over ``data``,
    within 1e-6 of their scale, float32)."""
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.dist.sharding import batch_block, batch_sharding
    from repro_torch.models.model import build_model
    from repro_torch.optim import AdamWConfig
    from repro_torch.train.loop import (TrainConfig, init_train_state,
                                        make_train_step)
    mesh = init_device_mesh("cpu", (2, 2, 1),
                            mesh_dim_names=("pod", "data", "model"))
    assert batch_sharding(mesh, ndim=2, batch_size=4).spec == \
        (("pod", "data"),)
    index, count = batch_block(mesh, 4)
    pod, data = mesh.get_local_rank("pod"), mesh.get_local_rank("data")
    assert (index, count) == (2 * pod + data, 4)
    blocks = [torch.zeros(1, dtype=torch.int64) for _ in range(world)]
    dist.all_gather(blocks, torch.tensor([index]))
    coords = mesh.mesh.reshape(-1).tolist()
    by_rank = {r: int(blocks[r]) for r in range(world)}
    for r in coords:                    # pod-only neighbours differ
        p, rest = divmod(coords.index(r), 2)
        other = coords[(1 - p) * 2 + rest]
        assert by_rank[r] != by_rank[other], by_rank
    cfg = _pod_cfg()
    # eps 1: an update linear in its gradient (``test_torch_tensor_parallel
    # .EPS``), so that the zero-initialised biases' near-cancelling
    # gradients cannot flip an update's sign between the two orders of sum
    tcfg = TrainConfig(opt=AdamWConfig(moment_dtype=torch.float32, lr=1e-3,
                                       eps=1.0),
                       warmup_steps=1, total_steps=6)
    import pytest
    with pytest.raises(ValueError, match="rests whole over"):
        make_train_step(build_model(cfg, "cpu", seed=None), tcfg, mesh=mesh)
    runs = []
    for m in (None, mesh):
        model = build_model(cfg, "cpu", seed=None, mesh=m)
        _, opt = init_train_state(model, 0, tcfg)
        step = make_train_step(model, tcfg, mesh=m)
        log = []
        for i in range(2):
            rng = np.random.default_rng(40 + i)
            tok = torch.from_numpy(rng.integers(0, cfg.vocab_size, (4, 16)))
            pe = torch.from_numpy(rng.normal(0, 0.02, (4, cfg.n_patches,
                                                        cfg.d_model)
                                             ).astype(np.float32))
            opt, met = step(opt, {"tokens": tok, "labels": tok,
                                  "patch_embeds": pe})
            log.append({k: float(v) for k, v in met.items()})
        runs.append((model, log))
    (whole, want), (sharded, got) = runs
    for a, b in zip(got, want):
        for key in ("loss", "ce", "grad_norm", "lr_scale"):
            assert abs(a[key] - b[key]) <= 1e-6 * abs(b[key]), (key, a, b)
    got = _gathered(sharded, {n: p.detach()
                              for n, p in sharded.named_parameters()})
    assert any(hasattr(p, "data_cut") for p in sharded.parameters())
    for name, q in whole.named_parameters():
        gap = (got[name] - q).abs().max().item()
        assert gap <= 1e-6 * q.abs().max().item(), (name, gap)


def tp_bf16_band(rank: int, world: int, directory: Path) -> None:
    """Three bf16 steps of qwen2-vl-2b's smoke config at 4 q heads over 2
    kv heads on a (1, 2) mesh and unsplit, from one seed and the same
    batches: every split loss within the band (``band.json``, relative) of
    the unsplit step's.  (Not the gradient norms: a bf16 step's own norm
    moves by tens of percent from its float32 one at these widths.)"""
    import json
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.configs import get_config
    from repro_torch.models.model import build_model
    from repro_torch.train.loop import TrainConfig, Trainer, make_train_step
    band = json.loads((directory / "band.json").read_text())
    cfg = dataclasses.replace(get_config("qwen2-vl-2b", "smoke"), n_heads=4,
                              n_kv_heads=2, dtype=torch.bfloat16)
    mesh = init_device_mesh("cpu", (1, world), mesh_dim_names=("data",
                                                               "model"))
    tcfg = TrainConfig(total_steps=10, warmup_steps=1)
    logs = []
    for m in (None, mesh):
        trainer = Trainer(build_model(cfg, "cpu", seed=None, mesh=m), tcfg,
                          seed=0)
        if m is not None:
            trainer.step_fn = make_train_step(trainer.model, tcfg, mesh=m)
        batches = []
        for i in range(3):
            rng = np.random.default_rng(50 + i)
            tok = rng.integers(0, cfg.vocab_size, (4, 16))
            batches.append({"tokens": tok, "labels": tok,
                            "patch_embeds": rng.normal(
                                0, 0.02, (4, cfg.n_patches, cfg.d_model)
                            ).astype(np.float32)})
        logs.append(trainer.run(batches))
    for got, want in zip(logs[1], logs[0]):
        assert abs(got["loss"] - want["loss"]) <= band * abs(want["loss"]), \
            (got["loss"], want["loss"], band)


# ----------------------- MoE routing, batch split ---------------------- #
# (the workers of ``tests/test_torch_dist.py``'s routing tests: the test
# writes the reference's results on the whole batch, computed with JAX in
# its own process, to ``moe_case.pkl``)
ROUTING_MESHES = {2: (2, 1), 4: (2, 2)}


def _tp_case_named(directory: Path, name: str) -> dict:
    import pickle
    with open(directory / name, "rb") as f:
        return pickle.load(f)


def moe_routing_step(rank: int, world: int, directory: Path) -> None:
    """mixtral's smoke config at capacity factor 1 (drops bind) on a
    ``ROUTING_MESHES[world]`` ("data", "model") mesh, 2 microbatches,
    against the reference's ``make_train_step`` on the whole batch: two
    sharded steps from the reference's weights and AdamW state (loss, ce,
    aux within 1e-5, the gradient norm within the case's bound, every
    gathered parameter at ``test_train_steps_match_reference``'s
    tolerance); then the first step's loss, aux and every gradient,
    gathered over ``model`` and ``data`` and averaged over the batch
    group as the step averages them (a block cut over ``data`` arrives
    summed over it), within ``test_loss_and_grads_match_reference``'s
    bound."""
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.models.params import (opt_state_from_reference,
                                           reference_paths)
    from repro_torch.optim import AdamWConfig
    from repro_torch.train.loop import TrainConfig, make_train_step
    case = _tp_case_named(directory, "moe_case.pkl")
    mesh = init_device_mesh("cpu", ROUTING_MESHES[world],
                            mesh_dim_names=("data", "model"))
    tag = f"{case['name']} on {ROUTING_MESHES[world]}"
    tt = TrainConfig(opt=AdamWConfig(moment_dtype=torch.float32, lr=1e-3,
                                     eps=case["eps"]),
                     microbatches=case["micro"], warmup_steps=1,
                     total_steps=6)
    model = _tp_model(case, mesh).requires_grad_(True)
    opt = opt_state_from_reference(case["opt"], tt.opt, "cpu", model=model)
    step = make_train_step(model, tt, mesh=mesh)
    for i, want in enumerate(case["steps"]):
        batch = {k: torch.from_numpy(v) for k, v in want["batch"].items()}
        opt, met = step(opt, batch)
        for key in ("loss", "ce", "aux"):
            w = want["metrics"][key]
            assert abs(float(met[key]) - w) <= 1e-5 * abs(w) + 1e-7, \
                (tag, i, key, float(met[key]), w)
        w = want["metrics"]["grad_norm"]
        assert abs(float(met["grad_norm"]) - w) <= want["norm_tol"] * w, \
            (tag, i, float(met["grad_norm"]), w, want["norm_tol"])
    got = reference_paths(_gathered(model, dict(model.named_parameters())))
    for path, w in case["final"].items():
        np.testing.assert_allclose(got[path].detach().numpy(), w, rtol=2e-4,
                                   atol=2e-5, err_msg=f"{tag} {path}")

    from repro_torch.dist.collectives import process_group
    from repro_torch.dist.sharding import batch_block
    from repro_torch.models.moe import routed_over
    from repro_torch.train.loop import (_batch_group, accumulate_grads,
                                        batch_routing, rank_rows)
    model = _tp_model(case, mesh).requires_grad_(True)
    batch = {k: torch.from_numpy(v) for k, v in case["batch"].items()}
    index, count = batch_block(mesh, case["batch"]["tokens"].shape[0])
    group = _batch_group(mesh)
    local = {k: rank_rows(v, case["micro"], index, count)
             for k, v in batch.items()}
    with routed_over(model, batch_routing(group, index, count)):
        loss, metrics, grads = accumulate_grads(model, local, case["micro"])
    pg = process_group(group)
    n = dist.get_world_size(pg)
    # a block cut over ``data`` left the backward summed over the data
    # ranks, which are the whole batch group here (no ``pod``)
    cut = [g for name, g in grads.items()
           if hasattr(model.get_parameter(name), "data_cut")]
    for t in [loss, metrics["aux"], *grads.values()]:
        if not any(t is c for c in cut):
            dist.all_reduce(t, group=pg)
        t.div_(n)
    for key, val in (("loss", loss), ("aux", metrics["aux"])):
        assert abs(val.item() - case[key]) <= 1e-5 * abs(case[key]), \
            (tag, key, val.item(), case[key])
    got = reference_paths(_gathered(model, grads))
    for path, want in case["grads"].items():
        gap = _rel_l2(got[path].numpy(), want)
        assert gap <= case["grad_tol"][path], (tag, path, gap)


def moe_routing_forward(rank: int, world: int, directory: Path) -> None:
    """One ``moe_forward`` of the case's MoE layer (capacity factor 1) on
    rank r's block of the rows, routed over the world group: its outputs
    within 1e-5 of their scale of the reference's rows of the whole
    batch's output (the case holds pairs dropped), the aux the whole
    batch's, and the gradient of the aux alone on the router, averaged
    over the ranks as the step averages it, the reference's (so counted
    once, not once a rank)."""
    from repro_torch.dist.tensor_parallel import ModelGroup
    from repro_torch.models import moe
    from repro_torch.models.params import InitCtx, load_reference_params
    case = _tp_case_named(directory, "moe_layer.pkl")
    cfg = _tp_cfg(case)
    p = moe.moe_init(cfg, InitCtx(torch.float32, torch.device("cpu")))
    load_reference_params(p, case["params"])
    p.requires_grad_(True)
    x = case["x"]
    rows = slice(rank * x.shape[0] // world, (rank + 1) * x.shape[0] // world)
    mine = torch.from_numpy(x[rows])
    routing = moe.BatchRouting(ModelGroup(dist.group.WORLD, world, rank),
                               rank, world)
    with moe.routed_over(p, routing):
        out, aux = moe.moe_forward(p, mine, cfg)
    assert case["dropped"] > 0
    _close_to_scale(out.detach().numpy(), case["out"][rows], 1e-5,
                    f"rank {rank} outputs")
    assert abs(aux.item() - case["aux"]) <= 1e-5 * case["aux"], \
        (aux.item(), case["aux"])
    aux.backward()
    g = p.router.grad.clone()
    dist.all_reduce(g)
    g.div_(world)
    assert _rel_l2(g.numpy(), case["aux_router_grad"]) <= 1e-5, \
        _rel_l2(g.numpy(), case["aux_router_grad"])


def tp_moe_router_faults(rank: int, world: int, directory: Path) -> None:
    """mixtral's smoke case split over a (1, 2) mesh (its experts split):
    the gradient of the router within the reference's bound, and out of
    it with the load-balance loss's router means entering the split
    (``copy_to``: its gradient summed over ``model``, so counted twice) or
    with the gates entering the experts as they are (identity backward:
    each rank's gate gradient only its own experts' part)."""
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.dist import tensor_parallel as tp
    from repro_torch.models import moe
    from repro_torch.models.model import loss_fn
    from repro_torch.models.params import reference_paths
    case = _tp_case(directory)
    mesh = init_device_mesh("cpu", (1, world), mesh_dim_names=("data",
                                                               "model"))
    batch = {k: torch.from_numpy(v) for k, v in case["batch"].items()}
    path = "layers.moe.router"
    want, tol = case["grads"][path], case["grad_tol"][path]
    right_loss, right_enter = moe.load_balance_loss, tp.ExpertSplit.enter

    def summed(probs, me, route):
        return right_loss(tp.copy_to(probs, mg), me, route)

    def gates_as_they_are(self, t):
        return t if t.dim() == 1 else right_enter(self, t)
    gaps = {}
    try:
        for name in ("right", "aux summed", "gates without copy_to"):
            model = _tp_model(case, mesh).requires_grad_(True)
            mg = tp.model_group(model)
            assert model.split_plan.runs()["experts"]
            if name == "aux summed":
                moe.load_balance_loss = summed
            if name == "gates without copy_to":
                tp.ExpertSplit.enter = gates_as_they_are
            loss, _ = loss_fn(model, batch)
            loss.backward()
            moe.load_balance_loss, tp.ExpertSplit.enter = (right_loss,
                                                           right_enter)
            grads = {n: p.grad for n, p in model.named_parameters()}
            gaps[name] = _rel_l2(reference_paths(grads)[path].numpy(), want)
    finally:
        moe.load_balance_loss, tp.ExpertSplit.enter = right_loss, right_enter
    assert gaps["right"] <= tol, (gaps, tol)
    assert tol < min(gaps["aux summed"], gaps["gates without copy_to"]), \
        (gaps, tol)


# --------------------------- FSDP over data ---------------------------- #
# (the workers of ``tests/test_torch_fsdp.py``: the test writes the arch
# to ``fsdp.json`` in the group's directory)
def _fsdp_setup(directory: Path):
    """(the smoke config of the case's arch in float32, the (world, 1)
    mesh, the model cut over ``data`` from seed 3, the unsplit model from
    the same seed)."""
    import json
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.configs import get_config
    from repro_torch.models.model import build_model
    arch = json.loads((directory / "fsdp.json").read_text())["arch"]
    cfg = dataclasses.replace(get_config(arch, "smoke"), dtype=torch.float32)
    mesh = init_device_mesh("cpu", (dist.get_world_size(), 1),
                            mesh_dim_names=("data", "model"))
    return (cfg, mesh, build_model(cfg, "cpu", seed=3, mesh=mesh),
            build_model(cfg, "cpu", seed=3))


def _smoke_tokens(cfg, seed: int) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    shape = (4, 16, cfg.n_codebooks) if cfg.n_codebooks else (4, 16)
    return torch.from_numpy(rng.integers(0, cfg.vocab_size, shape))


def fsdp_exact(rank: int, world: int, directory: Path) -> None:
    """The case's smoke config cut over a (world, 1) mesh's ``data`` axis
    against the unsplit model from the same seed:

    - every parameter whose spec names ``data`` keeps its block, 1 /
      world of its whole elements, and every other parameter stays whole;
      gathered (``gather_cut``) each equals the unsplit one bit for bit;
    - on this rank's rows (``batch_block``) the forward logits, the loss
      (remat on, the layers checkpointed), a prefill's and two decode
      steps' logits and the cache equal the unsplit model's bit for bit:
      each layer runs on its gathered weights, which are the unsplit ones;
    - the backward: a parameter left whole takes the unsplit model's
      gradient on these rows, and a block cut over ``data`` the sum over
      the ranks of the unsplit gradients, at the block (the
      reduce-scatter), each within 1e-5 of its scale (float32: the gather
      nodes change the order in which autograd adds a tensor's gradient
      terms, ~1e-7 of the scale)."""
    from repro_torch.dist.sharding import batch_block
    from repro_torch.models.model import loss_fn
    from repro_torch.models.params import whole_shape
    cfg, mesh, model, whole = _fsdp_setup(directory)
    assert model.fsdp is not None and model.fsdp.size == world
    n_cut = 0
    for name, p in model.named_parameters():
        spec = model.split_plan.specs[name]
        dims = [d for d, e in enumerate(spec) if e == "data"]
        if dims:
            assert p.data_cut == (dims[0], rank, world), (name, p.data_cut)
            assert p.numel() * world == int(np.prod(whole_shape(p))), name
            n_cut += 1
        else:
            assert not hasattr(p, "data_cut"), name
            assert tuple(p.shape) == whole_shape(p), name
    assert n_cut > 0
    got = _gathered(model, {n: p.detach() for n, p in model.named_parameters()})
    for name, q in whole.named_parameters():
        assert torch.equal(got[name], q.detach()), name
    tok = _smoke_tokens(cfg, 0)
    pe = None
    if cfg.vision_stub:
        pe = torch.from_numpy(np.random.default_rng(1).normal(
            0, 0.02, (4, cfg.n_patches, cfg.d_model)).astype(np.float32))
    index, count = batch_block(mesh, tok.shape[0])
    assert count == world
    rows = slice(index * 4 // count, (index + 1) * 4 // count)
    mine = {"tokens": tok[rows], "labels": tok[rows]}
    if pe is not None:
        mine["patch_embeds"] = pe[rows]
    with torch.no_grad():
        a, _ = model(mine["tokens"], mine.get("patch_embeds"))
        b, _ = whole(mine["tokens"], mine.get("patch_embeds"))
    assert torch.equal(a, b), "forward logits"
    caches = []
    for m in (model, whole):
        cache = m.init_cache(mine["tokens"].shape[0], 24)
        lg, cache = m.prefill(mine["tokens"], cache, mine.get("patch_embeds"))
        seq = [lg]
        for _ in range(2):
            lg, cache = m.decode(lg[:, -1].argmax(-1)[:, None], cache)
            seq.append(lg)
        caches.append((seq, cache))
    (seq_a, cache_a), (seq_b, cache_b) = caches
    assert all(torch.equal(x, y) for x, y in zip(seq_a, seq_b)), "serve"
    from repro_torch.models.params import paths_from_tree
    flat_b = paths_from_tree(cache_b)
    for path, t in paths_from_tree(cache_a).items():
        assert torch.equal(t, flat_b[path]), path
    assert cfg.remat
    losses = []
    for m in (model, whole):
        m.requires_grad_(True)
        loss, _ = loss_fn(m, mine)
        loss.backward()
        losses.append(loss.detach())
    assert torch.equal(*losses), "loss"
    for (name, p), q in zip(model.named_parameters(), whole.parameters()):
        want = q.grad
        if hasattr(p, "data_cut"):
            want = want.contiguous().clone()
            dist.all_reduce(want)
            dim = p.data_cut[0]
            want = want.narrow(dim, rank * p.shape[dim], p.shape[dim])
        _close_to_scale(p.grad.numpy(), want.numpy(), 1e-5, name)


class _AllGathers(TorchDispatchMode):
    """Keeps the arguments and outputs of every all-gather (``c10d`` and
    ``_c10d_functional`` ops) dispatched under it."""

    def __init__(self):
        super().__init__()
        self.gathered = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.namespace in ("c10d", "_c10d_functional") and \
                "gather" in func.overloadpacket.__name__:
            self.gathered.append((args, out))
        return out


def _tensors_in(tree) -> list:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, (list, tuple)):
        return [t for x in tree for t in _tensors_in(x)]
    return []


def fsdp_step_state(rank: int, world: int, directory: Path) -> None:
    """The sharded step of the case's model cut over ``data``: the AdamW
    state rests as DTensors in its parameters' blocks (each leaf's local
    tensor shaped as its parameter, 1 / world of the whole over ``data``),
    and a step updates those local tensors in place: the same DTensors
    after it, and no all-gather reads or writes a tensor of ``m``, ``v``
    or ``master`` (the step's all-gathers are the layers' weights')."""
    from torch.distributed.tensor import DTensor
    from repro_torch.optim import AdamWConfig
    from repro_torch.train.loop import (TrainConfig, init_train_state,
                                        make_train_step)
    cfg, mesh, model, _ = _fsdp_setup(directory)
    tcfg = TrainConfig(opt=AdamWConfig(moment_dtype=torch.float32),
                       microbatches=2, warmup_steps=1, total_steps=6)
    _, opt = init_train_state(model, 0, tcfg)
    step = make_train_step(model, tcfg, mesh=mesh)
    tok = _smoke_tokens(cfg, 5)
    batch = {"tokens": tok, "labels": tok}
    if cfg.vision_stub:
        batch["patch_embeds"] = torch.zeros((4, cfg.n_patches, cfg.d_model))
    opt, _ = step(opt, batch)
    params = dict(model.named_parameters())
    keys = ("m", "v", "master")
    before = {k: dict(opt[k]) for k in keys}
    storages = set()
    for k in keys:
        for name, t in opt[k].items():
            assert isinstance(t, DTensor), (k, name)
            local = t.to_local()
            assert local.shape == params[name].shape, (k, name)
            if hasattr(params[name], "data_cut"):
                assert t.shape[params[name].data_cut[0]] == \
                    world * local.shape[params[name].data_cut[0]]
            storages.add(local.untyped_storage().data_ptr())
    mode = _AllGathers()
    with mode:
        opt, met = step(opt, batch)
    assert np.isfinite(float(met["loss"]))
    assert mode.gathered, "the step gathered no weight"
    for args, out in mode.gathered:
        for t in _tensors_in(args) + _tensors_in(out):
            assert t.untyped_storage().data_ptr() not in storages, \
                "an all-gather moved the optimizer state"
    for k in keys:
        for name, t in opt[k].items():
            assert t is before[k][name], (k, name)
    assert int(opt["step"].to_local()) == 2

