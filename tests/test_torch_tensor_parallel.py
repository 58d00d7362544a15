"""The port's tensor parallelism over the mesh's ``model`` axis
(``repro_torch.dist.tensor_parallel``, ``Model.shard``) and the sharded
step's batch split over ``("pod", "data")`` against the JAX package's
unsplit results, on the CPU.

- The reference (``repro``, JAX on the CPU, float32) computes, in this
  process, the forward logits and loss, every gradient (with its float32
  error against its own float64 run, as ``test_torch_train`` bounds a
  gradient), three steps of its ``make_train_step``, and a prefill with 4
  greedy decode steps, for seven configs: the smoke configs of
  qwen2-vl-2b and minitron-4b (3 q heads over 1 kv head: at ``model`` = 2
  their attention runs whole), musicgen-large's (4 over 4: split), two
  made with ``dataclasses.replace`` from qwen2-vl-2b's: 4 q heads over 2
  kv heads (M-RoPE and the q/k/v biases on split heads) and 4 over 1 (the
  q heads split, the kv heads not: llama3-405b's case at 16), and the
  smoke configs of zamba2-7b (8 SSD heads, 2 x 16 B/C columns, the shared
  block at 4 over 4 heads) and rwkv6-1.6b (4 heads of 16).
- Spawned gloo groups (``_dist_workers``) of 2 ranks as (1, 2) and of 4
  ranks as (2, 2) and (2, 1, 2) cut each rank's blocks out of those
  weights (``load_reference_params``) and hold the split model to them:
  the forward logits within 1e-5 of their scale plus twice the
  reference's own float32 gap to its float64 run (musicgen-large's smoke
  decode logits lie 1.25e-5 of their scale from its float64 ones, so
  1e-5 alone would hold the port closer than the reference holds itself;
  the gradients' bound adds the same term), the loss within 1e-5
  (relative),
  every gathered gradient within
  ``test_loss_and_grads_match_reference``'s bound, three
  sharded steps (metrics, ``grad_norm`` within that bound's norm, every
  gathered parameter at ``test_train_steps_match_reference``'s
  tolerance; AdamW's eps 1, see ``EPS``), and prefill with decode (the
  gathered last-position logits within the same bound, every greedy token
  equal).
- The ``pod`` split on (2, 2, 1): ranks that differ only in ``pod`` take
  different rows, and the step equals the one-process step.
- The split's global norm counts a split leaf once over ``model`` and a
  replicated one once.
- In bf16, three split steps' losses lie within ``BF16_LOSS_RTOL`` of the
  unsplit steps' (the band ``chip_smoke.py``'s two-process phase holds
  the card to).
- Which regions split, for the six configs of the dense, vlm and audio
  families and for zamba2-7b and rwkv6-1.6b at ``model`` = 2 and 16,
  against ``spec_for`` (the MoE family's in
  ``test_torch_tensor_parallel_moe``).  Mamba2's
  index-map cut put back together equals the whole leaf bit for bit.
  (The zamba2-7b and rwkv6-1.6b parity cases, and the gated norm's need
  of its all-reduce backward, run from ``test_torch_tensor_parallel_scan``
  on this file's references.)
- A local embedding lookup of ids outside the rank's rows gives zeros.
- The dry run on a fake 256/512-rank group: a train cell's FLOPs a rank
  at 2x16x16 are half its 16x16 row's (8 rows a rank, not 16).
"""
import dataclasses
import functools
import json
import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import _dist_workers
from _lm_parity import jax_model
from repro.models.model import build_model as jbuild
from repro.models.model import loss_fn as jloss
from repro.models.params import paths_from_tree as jpaths
from repro.models.params import tree_from_paths as jtree
from repro.optim import adamw_init as jadamw_init
from repro.train import loop as jloop
from repro_torch.configs import get_config
from repro_torch.dist import sharding
from repro_torch.dist.tensor_parallel import local_lookup, split_plan
from repro_torch.models.model import build_model

ROOT = Path(__file__).resolve().parents[1]

# name -> (arch, overrides of its smoke config)
CONFIGS = {
    "qwen2-vl-2b": ("qwen2-vl-2b", {}),
    "minitron-4b": ("minitron-4b", {}),
    "musicgen-large": ("musicgen-large", {}),
    "qwen2-vl-2b-4q2kv": ("qwen2-vl-2b", {"n_heads": 4, "n_kv_heads": 2}),
    "qwen2-vl-2b-4q1kv": ("qwen2-vl-2b", {"n_heads": 4, "n_kv_heads": 1}),
    "zamba2-7b": ("zamba2-7b", {}),
    "rwkv6-1.6b": ("rwkv6-1.6b", {}),
    "mixtral-8x22b": ("mixtral-8x22b", {}),
    "deepseek-v3-671b": ("deepseek-v3-671b", {}),
    # 3 experts do not split over 2 ranks: each expert's columns do
    "mixtral-8x22b-3e": ("mixtral-8x22b", {"n_experts": 3}),
}
# the scan families' parity cases run from test_torch_tensor_parallel_scan
# .py, the MoE family's from test_torch_tensor_parallel_moe.py: a file of
# its own goes to a test worker of its own, and the scan families' JAX
# references take minutes on the CPU
SCAN_CONFIGS = ("zamba2-7b", "rwkv6-1.6b")
MOE_CONFIGS = ("mixtral-8x22b", "deepseek-v3-671b", "mixtral-8x22b-3e")
# configs whose reference weights are ``_conditioned``: at the reference's
# init (stacked layer weights at std 1/sqrt(depth), 0.71 for deepseek's two
# MoE layers) MLA's softmax rows are saturated, and the float32 orders of
# the two frameworks pick different keys where two tie: the unsplit port's
# second step's gradient norm lies 1.7e-3 from the reference's, ten times
# the reference's own float32 gap to float64
CONDITIONED = ("deepseek-v3-671b",)
# a spawned group must end within this (a few tens of seconds when it
# passes)
GROUP_TIMEOUT_S = 240
# the split bf16 steps' losses against the unsplit ones, relative: one
# bf16 rounding (2^-8) of the loss.  A split rounds each product's partial
# sums to bf16 before their sum, and the unsplit order differs from it by
# ~1e-4 of the loss at these widths
BF16_LOSS_RTOL = 2.0 ** -8
B, S, S0, STEPS = 4, 16, 8, 4
# AdamW's eps in the three steps, as the (1, 1) sharded step's test in
# ``test_torch_dist`` takes it: at 1e-8 the first updates are each
# gradient element's sign times the rate, and an element whose terms
# cancel to float32 rounding (a zero-initialised bias's) takes either sign
# in either framework; at 1 an update is linear in its gradient
EPS = 1.0


def _batch(cfg, seed: int) -> dict:
    rng = np.random.default_rng(seed)
    shape = (B, S, cfg.n_codebooks) if cfg.n_codebooks else (B, S)
    tok = rng.integers(0, cfg.vocab_size, shape).astype(np.int32)
    batch = {"tokens": tok, "labels": tok}
    if cfg.vision_stub:
        batch["patch_embeds"] = rng.normal(
            0.0, 0.02, (B, cfg.n_patches, cfg.d_model)).astype(np.float32)
    return batch


@functools.lru_cache(maxsize=None)
def _jit_grad(cfg):
    model = jbuild(cfg)
    return jax.jit(jax.grad(lambda p, b: jloss(model, p, b)[0]))


def _grads(cfg, params, batch: dict) -> dict:
    jb = {k: jnp.asarray(v, cfg.dtype if v.dtype == np.float32 else v.dtype)
          for k, v in batch.items()}
    grads = _jit_grad(cfg)(params, jb)
    return {k: np.asarray(v, np.float64) for k, v in jpaths(grads).items()}


def _grads64(cfg, params, batch: dict) -> dict:
    """The reference's gradients under jax x64 on the same weights."""
    jax.config.update("jax_enable_x64", True)
    try:
        p64 = jax.tree.map(lambda a: jnp.asarray(np.asarray(a), jnp.float64),
                           params)
        return _grads(dataclasses.replace(cfg, dtype=jnp.float64), p64,
                      batch)
    finally:
        jax.config.update("jax_enable_x64", False)


def _scale_gap(got: np.ndarray, want: np.ndarray) -> float:
    return float(np.abs(got - want).max() / np.abs(want).max())


def _float64_outputs(cfg, params, batch: dict, prompt: np.ndarray, pe,
                     tokens: list) -> tuple[np.ndarray, list]:
    """The reference's forward logits on ``batch`` and its prefill and
    decode logits teacher-forced on ``tokens``, under jax x64 on the same
    weights."""
    jax.config.update("jax_enable_x64", True)
    try:
        jm = jbuild(dataclasses.replace(cfg, dtype=jnp.float64))
        p64 = jax.tree.map(lambda a: jnp.asarray(np.asarray(a), jnp.float64),
                           params)

        def f64(a):
            return None if a is None else jnp.asarray(a, jnp.float64)
        fwd, _ = jm.forward(p64, jnp.asarray(batch["tokens"]),
                            f64(batch.get("patch_embeds")))
        cache, _ = jm.init_cache(B, S0 + STEPS + 2)
        # int64 lengths: the decode's update slice takes x64's int64 zeros
        cache = jax.tree.map(lambda a: a.astype(jnp.int64)
                             if a.dtype == jnp.int32 else a, cache)
        lg, cache = jm.prefill(p64, jnp.asarray(prompt), cache, f64(pe))
        serve = [np.asarray(lg)]
        for tok in tokens[:-1]:
            lg, cache = jm.decode(p64, jnp.asarray(tok), cache)
            serve.append(np.asarray(lg))
        return np.asarray(fwd), serve
    finally:
        jax.config.update("jax_enable_x64", False)


def _flat_norm_gap(g32: dict, g64: dict) -> float:
    keys = sorted(g32)
    return _dist_workers._rel_l2(
        np.concatenate([g32[k].ravel() for k in keys]),
        np.concatenate([g64[k].ravel() for k in keys]))


@functools.lru_cache(maxsize=None)
def _reference(name: str) -> dict:
    """The reference's unsplit results for config ``name`` (see the
    module's docstring), as numpy."""
    arch, over = CONFIGS[name]
    jm, _ = jax_model(arch, "float32", False, remat=False, **over)
    cfg = jm.cfg
    jt = jloop.TrainConfig(
        opt=dataclasses.replace(jloop.AdamWConfig(), moment_dtype=jnp.float32,
                                lr=1e-3, eps=EPS),
        warmup_steps=1, total_steps=6)
    params, opt, _ = jloop.init_train_state(jm, jax.random.PRNGKey(0), jt)
    if name in CONDITIONED:
        params = _conditioned(params)
        opt = jadamw_init(params, jt.opt)
    flat = {k: np.asarray(v) for k, v in jpaths(params).items()}
    batch = _batch(cfg, 0)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    logits, _ = jm.forward(params, jb["tokens"], jb.get("patch_embeds"))
    loss, _ = jloss(jm, params, jb)
    g32 = {k: np.asarray(v) for k, v in jpaths(jax.grad(
        lambda p: jloss(jm, p, jb)[0])(params)).items()}
    g64 = _grads64(cfg, params, batch)
    case = {"name": name, "arch": arch, "over": over, "eps": EPS,
            "params": flat,
            "batch": batch, "logits": np.asarray(logits),
            "loss": float(loss), "grads": g32,
            "grad_tol": {k: 1e-4 + 2 * _dist_workers._rel_l2(g32[k], g64[k])
                         for k in g32},
            "opt": {key: {k: np.asarray(v)
                          for k, v in jpaths(opt[key]).items()}
                    for key in ("m", "v", "master")}}
    case["opt"]["step"] = int(opt["step"])
    params0 = params
    jstep = jloop.make_train_step(jm, jt)
    steps = []
    for i in range(3):
        sb = _batch(cfg, 20 + i)
        tol = 1e-4 + 2 * _flat_norm_gap(_grads(cfg, params, sb),
                                        _grads64(cfg, params, sb))
        params, opt, met = jstep(params, opt,
                                 {k: jnp.asarray(v) for k, v in sb.items()})
        steps.append({"batch": sb, "norm_tol": tol,
                      "metrics": {k: float(v) for k, v in met.items()}})
    case["steps"] = steps
    case["final"] = {k: np.asarray(v) for k, v in jpaths(params).items()}
    # prefill S0 tokens, then greedy decode steps, from the first weights
    jparams = params0
    prompt = batch["tokens"][:, :S0]
    pe = batch.get("patch_embeds")
    cache, _ = jm.init_cache(B, S0 + STEPS + 2)
    lg, cache = jm.prefill(jparams, jnp.asarray(prompt), cache,
                           None if pe is None else jnp.asarray(pe))
    logits_seq, tokens = [], []
    for j in range(STEPS + 1):
        lg = np.asarray(lg)
        tok = np.argmax(lg[:, -1], axis=-1)[:, None]
        logits_seq.append(lg)
        tokens.append(tok)
        if j < STEPS:
            lg, cache = jm.decode(jparams, jnp.asarray(tok), cache)
    case["serve"] = {"prompt": prompt, "patch_embeds": pe,
                     "max_len": S0 + STEPS + 2, "logits": logits_seq,
                     "tokens": tokens}
    # the logits' bound: 1e-5 of their scale plus twice the reference's
    # own float32 gap to its float64 run, as the gradients' bound adds it
    fwd64, serve64 = _float64_outputs(cfg, params0, batch, prompt, pe,
                                      tokens)
    case["logits_tol"] = 1e-5 + 2 * _scale_gap(case["logits"], fwd64)
    case["serve"]["logits_tol"] = 1e-5 + 2 * max(
        _scale_gap(a, b) for a, b in zip(logits_seq, serve64))
    return case


def _conditioned(params: dict) -> dict:
    """The reference's parameter tree with each stacked layer matrix (n,
    fan-in, ...) rescaled from its std 1/sqrt(n) to 1/sqrt(fan-in), the
    leading dim of a layer's leaf (``chip_smoke._conditioned``'s rule)."""
    flat = {}
    for path, a in jpaths(params).items():
        if path.split(".")[0] in ("layers", "dense_layers") and a.ndim >= 3:
            a = a * float(np.sqrt(a.shape[0] / a.shape[1]))
        flat[path] = a
    return jtree(flat)


def _write_case(tmp_path: Path, case: dict) -> None:
    with open(tmp_path / "tp_case.pkl", "wb") as f:
        pickle.dump(case, f)


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("name", [n for n in CONFIGS if n not in
                                  SCAN_CONFIGS + MOE_CONFIGS])
def test_split_matches_reference(tmp_path, name, world):
    """The split model against the reference's unsplit results on every
    mesh of ``_dist_workers.TP_MESHES[world]`` (see the module's
    docstring)."""
    _write_case(tmp_path, _reference(name))
    _dist_workers.spawn_group(tmp_path, world, ["tp_parity"],
                              GROUP_TIMEOUT_S)


def test_pod_split_and_split_norm(tmp_path):
    """On 4 ranks: the ``pod`` split of the sharded step, and the split
    global norm on a (1, 4) mesh."""
    _dist_workers.spawn_group(tmp_path, 4, ["pod_split_step", "tp_norm"],
                              GROUP_TIMEOUT_S)


def test_bf16_split_steps_within_the_band(tmp_path):
    """Three bf16 steps of qwen2-vl-2b's smoke config at 4 q heads over 2
    kv heads (everything split) on a (1, 2) mesh: each loss within
    ``BF16_LOSS_RTOL`` of the unsplit steps' from the same seed and
    batches."""
    (tmp_path / "band.json").write_text(json.dumps(BF16_LOSS_RTOL))
    _dist_workers.spawn_group(tmp_path, 2, ["tp_bf16_band"], GROUP_TIMEOUT_S)


# --------------------------- which regions split ------------------------ #
SIX = ["qwen2-vl-2b", "minitron-4b", "musicgen-large", "internlm2-20b",
       "qwen2.5-32b", "llama3-405b"]


class _FakeMesh:
    def __init__(self, shape: dict):
        self.shape = shape


@pytest.mark.parametrize("n", [2, 16])
@pytest.mark.parametrize("arch", SIX)
def test_split_plan_follows_spec_for(arch, n):
    """Each region splits exactly where ``spec_for`` shards its weights'
    dim over ``model`` (the full config, on the meta device), and a
    region's weights agree; llama3-405b at 16 splits its q heads and not
    its kv heads, qwen2-vl-2b at 16 runs its attention whole."""
    cfg = get_config(arch, "full")
    model = build_model(cfg, "meta", seed=None)
    mesh = _FakeMesh({"data": 16, "model": n})
    plan = split_plan(model, mesh)
    rules = sharding.default_rules(False)
    want = {"heads": cfg.n_heads % n == 0,
            "kv_heads": cfg.n_kv_heads % n == 0,
            "mlp": cfg.d_ff % n == 0, "vocab": cfg.vocab_size % n == 0}
    assert plan.split == want, plan.split
    for name, p in model.named_parameters():
        spec = sharding.spec_for(tuple(p.shape), p.logical_axes, rules, mesh)
        assert plan.specs[name] == spec, name
        split = [a for a, e in zip(p.logical_axes, spec)
                 if e == "model" or (isinstance(e, tuple) and "model" in e)]
        assert all(want[a] for a in split), (name, split)
        for region in want:
            if region in p.logical_axes:
                assert (region in split) == want[region], (name, region)
    if (arch, n) == ("llama3-405b", 16):
        assert plan.split["heads"] and not plan.split["kv_heads"]
    if (arch, n) == ("qwen2-vl-2b", 16):
        assert not plan.split["heads"] and plan.split["mlp"] \
            and plan.split["vocab"]
    if (arch, n) == ("qwen2-vl-2b", 2):
        assert all(plan.split.values())
    assert f"model axis {n}" in plan.describe()


@pytest.mark.parametrize("n", [2, 16])
@pytest.mark.parametrize("arch", ["rwkv6-1.6b", "zamba2-7b"])
def test_ssm_families_split_as_spec_for(arch, n):
    """The full zamba2-7b and rwkv6-1.6b at ``model`` = 2 and 16 (on the
    meta device): every region splits (Mamba2, the shared block's
    attention and MLP, the vocabulary; the time mix, the channel mix, the
    vocabulary), exactly the leaves whose ``spec_for`` shards a dim over
    ``model`` are cut, and each cut block's shape is the spec's block
    (zamba2-7b's w_in at 16: 911 of 14,576 columns, 448 + 448 + 8 + 7);
    the mesh's ``data`` axis of 16 cuts the dims the spec shards over
    ``data`` too (``dist.fsdp``)."""
    cfg = get_config(arch, "full")
    model = build_model(cfg, "meta", seed=None)
    mesh = sharding.CutMesh({"data": 16, "model": n})
    model.shard(mesh)
    plan = model.split_plan
    assert all(plan.runs().values()), \
        plan.describe()
    want = ({"mamba2", "attention", "mlp", "vocab"} if arch == "zamba2-7b"
            else {"time mix", "channel mix", "vocab"})
    assert set(plan.runs()) == want
    assert "later slice" not in plan.describe()
    rules = sharding.default_rules(False)
    n_cut = 0
    for name, p in model.named_parameters():
        spec = sharding.spec_for(p.whole_shape if hasattr(p, "cut")
                                 else tuple(p.shape), p.logical_axes,
                                 rules, mesh)
        assert plan.specs[name] == spec, name
        shape = getattr(p, "whole_shape", tuple(p.shape))
        spec = tuple(spec) + (None,) * (len(shape) - len(spec))
        block = [s // n if e == "model" else s // 16 if e == "data" else s
                 for s, e in zip(shape, spec)]
        assert hasattr(p, "cut") == ("model" in spec), name
        assert hasattr(p, "data_cut") == ("data" in spec), name
        assert list(p.shape) == block, (name, tuple(p.shape), block)
        n_cut += hasattr(p, "cut")
    assert n_cut > 0
    if arch == "zamba2-7b":
        mixer = model.layers[0].mixer
        di, N, H = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
        assert mixer.w_in.cut == (1, 0, n, (di, di, 2 * N, H))
        assert mixer.w_in.shape[1] == (2 * di + 2 * N + H) // n
        if n == 16:
            assert mixer.w_in.shape[1] == 911 == 448 + 448 + 8 + 7
            assert mixer.conv_b.shape[0] == 456 == 448 + 8
        cache = model.init_cache(1, 4)
        assert cache["layers"]["ssm"].shape[2] == H // n
        assert cache["layers"]["conv"].shape[3] == (di + 2 * N) // n
        assert model.init_cache(1, 4, whole=True)["layers"]["ssm"].shape[2] \
            == H
    else:
        assert model.layers[0].time.u.shape[0] == 32 // n
        assert model.init_cache(1, 4)["layers"]["wkv"].shape[2] == 32 // n


@pytest.mark.parametrize("n", [2, 4, 8])
def test_mamba2_index_map_cut_round_trips(n):
    """Every Mamba2 leaf of zamba2-7b's smoke config (8 heads, 2 x 16 B/C
    columns), cut over ``n`` ranks by its segments: the ranks' blocks put
    back together (``params.assemble``, what ``gather_cut`` does after its
    all-gather) equal the whole leaf bit for bit, and rank r's block of
    w_in holds the z and x columns and the dt column of its heads and its
    2N / n B/C columns."""
    from repro_torch.models.params import assemble, local_part
    cfg = get_config("zamba2-7b", "smoke")
    di, N, H, P = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    whole = build_model(cfg, "cpu", seed=1)
    ranks = [build_model(cfg, "meta", seed=None).shard(
        sharding.CutMesh({"data": 1, "model": n}, r)) for r in range(n)]
    checked = 0
    for name, w in whole.named_parameters():
        own = [m.get_parameter(name) for m in ranks]
        if ".mixer." not in name or not hasattr(own[0], "cut"):
            assert ".mixer." not in name or own[0].logical_axes == (None,)
            continue
        blocks = [local_part(p, w.detach()) for p in own]
        assert all(tuple(b.shape) == tuple(p.shape)
                   for b, p in zip(blocks, own)), name
        assert torch.equal(assemble(blocks, own[0].cut), w.detach()), name
        checked += 1
        if name.endswith("w_in"):
            h, b = H // n, 2 * N // n
            for rank, blk in enumerate(blocks):
                cols = (list(range(rank * h * P, (rank + 1) * h * P))
                        + list(range(di + rank * h * P,
                                     di + (rank + 1) * h * P))
                        + list(range(2 * di + rank * b,
                                     2 * di + (rank + 1) * b))
                        + list(range(2 * di + 2 * N + rank * h,
                                     2 * di + 2 * N + (rank + 1) * h)))
                assert torch.equal(blk, w.detach()[:, cols]), rank
    assert checked == 5 * cfg.n_layers      # w_in, conv_w, conv_b, norm_w, w_out



def test_local_lookup_gives_zeros_outside_the_rank_rows():
    table = torch.arange(12, dtype=torch.float32).reshape(4, 3) + 1
    ids = torch.tensor([[0, 3, 4, 7], [8, 5, 100, -1]])
    got = local_lookup(table, ids, lo=4)
    want = torch.zeros((2, 4, 3))
    want[0, 2], want[0, 3], want[1, 1] = table[0], table[3], table[1]
    assert torch.equal(got, want)
    assert torch.equal(local_lookup(table, ids, lo=200), torch.zeros(2, 4, 3))


def test_shard_keeps_the_unsplit_model_values():
    """``build_model(..., mesh=)`` draws every weight whole from the seed
    and keeps its block: on a one-rank (1, 1) mesh nothing is cut and the
    model equals the unsplit one; the cut of a stand-in 2-way mesh keeps
    rank 1's half of each split weight, bit for bit."""
    from repro_torch.models.params import cut_params, local_part
    cfg = dataclasses.replace(get_config("qwen2-vl-2b", "smoke"),
                              dtype=torch.float32)
    whole = build_model(cfg, "cpu", seed=5)
    model = build_model(cfg, "cpu", seed=None)
    plan = split_plan(model, _FakeMesh({"data": 1, "model": 2}))
    cuts = {}
    for name, spec in plan.specs.items():
        for dim, e in enumerate(spec):
            if e == "model":
                cuts[name] = (dim, 1, 2)
    cut_params(model, cuts)
    model.init(5)
    for (name, p), q in zip(model.named_parameters(), whole.parameters()):
        assert torch.equal(p, local_part(p, q)), name
        if name in cuts:
            assert p.shape != q.shape and p.whole_shape == tuple(q.shape)


# ------------------------------- dry run ------------------------------- #
DRYRUN = """
import dataclasses, json, sys
from repro_torch.configs import get_config
from repro_torch.launch import dryrun
from repro_torch.launch.shapes import SHAPES
cfg = dataclasses.replace(get_config("qwen2-vl-2b", "smoke"), n_heads=16,
                          n_kv_heads=16, d_ff=128, vocab_size=512)
multi = sys.argv[1] == "1"
with dryrun.fake_process_group(512 if multi else 256):
    row = dryrun._lower_and_analyze(cfg, "qwen2-vl-2b", SHAPES["train_4k"],
                                    multi_pod=multi)
print(json.dumps(row))
"""


def _dryrun_row(multi_pod: bool) -> dict:
    out = subprocess.run(
        [sys.executable, "-c", DRYRUN, "1" if multi_pod else "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=120,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.strip().splitlines()
    return json.loads(lines[-1]), "\n".join(lines[:-1])


def test_dryrun_multi_pod_train_row_halves_the_flops():
    """qwen2-vl-2b's smoke config at 16 q and kv heads, a d_ff of 128 and
    a vocabulary of 512 (every region split 16 ways) x train_4k: at
    2x16x16 a rank takes 8 of the 256 rows, not 16, so its FLOPs are half
    the 16x16 row's (within 2%), and both rows report the split."""
    (one, log1), (two, log2) = _dryrun_row(False), _dryrun_row(True)
    assert one["n_devices"] == 256 and two["n_devices"] == 512
    assert abs(two["flops_total"] / one["flops_total"] - 0.5) <= 0.01, \
        (one["flops_total"], two["flops_total"])
    assert one["bytes_per_device"]["argument"] > \
        two["bytes_per_device"]["argument"]
    for log in (log1, log2):            # the printed split plan
        assert "mlp 128 split, 8 a rank" in log, log
        assert "attention split, mlp split, vocab split" in log, log
