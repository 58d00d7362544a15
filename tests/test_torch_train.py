"""The port's training path (``repro_torch.models.model.loss_fn``,
``repro_torch.train``, ``repro_torch.launch.train`` and the kernels'
``torch.autograd.Function``s) against the JAX package's, on the CPU.

- ``loss_fn`` and every parameter's gradient, in float32, from the
  reference's weights, for one smoke config of each family.  The loss to
  1e-5.  A gradient to 1e-4 in relative L2, plus twice the reference's own
  float32 error against its float64 run (jax x64) on the same weights and
  batch: these smoke models are stacked at the reference's init std
  1/sqrt(n_layers), and float32 rounding alone moves some of the
  reference's own gradients by up to 3e-4 (mixtral's attention), which the
  port, rounding at other places, cannot be held closer than.  Each family
  runs both ways: the plain route, and ``use_kernel=True``, where every
  attention and scan goes through its ``autograd.Function`` (the plain
  version in the kernel's place here).
- Three ``make_train_step`` steps on minitron-4b smoke in float32 at
  ``microbatches`` 1 and 2 against the reference's, parameters and AdamW
  state.
- The reference's own integration tests, on the port: microbatching equal
  to the full batch (its rtol 2e-4, atol 2e-5), training reduces the loss,
  checkpoint and resume bit for bit; remat equal to no remat; the mesh
  plan, the straggler detector, ``recover``; the CLI.
"""
import dataclasses
import functools
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _lm_parity import jax_model, port_model
from repro.configs import get_config as jget
from repro.models.model import build_model as jbuild
from repro.models.model import loss_fn as jloss
from repro.models.params import paths_from_tree as jpaths
from repro.train import elastic as jelastic
from repro.train import loop as jloop
from repro.train import straggler as jstraggler
from repro_torch.checkpoint.ckpt import restore_checkpoint, save_checkpoint
from repro_torch.configs import get_config
from repro_torch.kernels import ops, ref
from repro_torch.launch import train as train_cli
from repro_torch.models.model import build_model, loss_fn
from repro_torch.models.params import (load_reference_params,
                                       opt_state_from_reference,
                                       opt_state_to_reference,
                                       paths_from_tree, reference_paths,
                                       split_reference_paths)
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.train import elastic, straggler
from repro_torch.train.loop import TrainConfig, Trainer, make_train_step

FAMILIES = ["minitron-4b", "mixtral-8x22b", "deepseek-v3-671b", "zamba2-7b",
            "rwkv6-1.6b", "musicgen-large", "qwen2-vl-2b"]


def _batch(cfg, seed: int = 0, B: int = 2, S: int = 16) -> dict:
    """Seeded numpy tokens (labels = tokens, as the pipeline makes them)
    and, for the vision stub, patch embeddings."""
    rng = np.random.default_rng(seed)
    shape = (B, S, cfg.n_codebooks) if cfg.n_codebooks else (B, S)
    tok = rng.integers(0, cfg.vocab_size, shape).astype(np.int32)
    batch = {"tokens": tok, "labels": tok}
    if cfg.vision_stub:
        batch["patch_embeds"] = rng.normal(
            size=(B, cfg.n_patches, cfg.d_model)).astype(np.float32)
    return batch


def _torch_batch(batch: dict) -> dict:
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _rel_l2(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want),
                                                  1e-30))


@functools.lru_cache(maxsize=None)
def _reference_grads(arch: str):
    """(loss, {path: float32 gradient}, {path: float64 gradient}) of the
    reference's ``loss_fn`` on its float32 smoke weights and ``_batch``;
    the float64 run takes the same weights under jax x64."""
    jm, params = jax_model(arch, "float32", False)
    batch = _batch(jm.cfg)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (loss, _), grads = jax.value_and_grad(
        lambda p: jloss(jm, p, jb), has_aux=True)(params)
    g32 = {k: np.asarray(v) for k, v in jpaths(grads).items()}
    jax.config.update("jax_enable_x64", True)
    try:
        jm64 = jbuild(dataclasses.replace(jget(arch, "smoke"),
                                          dtype=jnp.float64))
        p64 = jax.tree.map(lambda a: jnp.asarray(np.asarray(a), jnp.float64),
                           params)
        jb64 = {k: jnp.asarray(v, jnp.float64 if v.dtype == np.float32
                               else v.dtype) for k, v in batch.items()}
        grads64 = jax.grad(lambda p: jloss(jm64, p, jb64)[0])(p64)
        g64 = {k: np.asarray(v) for k, v in jpaths(grads64).items()}
    finally:
        jax.config.update("jax_enable_x64", False)
    return float(loss), g32, g64


@pytest.mark.parametrize("use_kernel", [False, True],
                         ids=["plain", "autograd_function"])
@pytest.mark.parametrize("arch", FAMILIES)
def test_loss_and_grads_match_reference(arch, use_kernel):
    want_loss, g32, g64 = _reference_grads(arch)
    model = port_model(arch, "float32", use_kernel).requires_grad_(True)
    batch = _torch_batch(_batch(model.cfg))
    loss, metrics = loss_fn(model, batch)
    loss.backward()
    assert abs(loss.item() - want_loss) <= 1e-5 * max(abs(want_loss), 1.0)
    assert set(metrics) == {"ce", "aux"}
    assert loss.item() == pytest.approx(
        metrics["ce"].item() + 0.01 * metrics["aux"].item(), rel=1e-6)
    # a parameter the loss does not read (the codebook models' ``embed``
    # and ``head``) has no gradient here and a zero one in the reference
    got = reference_paths({n: (p.grad if p.grad is not None
                               else torch.zeros_like(p))
                           for n, p in model.named_parameters()})
    assert sorted(got) == sorted(g32)
    for path, want in g32.items():
        g = got[path].numpy()
        assert g.shape == want.shape and np.isfinite(g).all(), path
        tol = 1e-4 + 2 * _rel_l2(want, g64[path])
        assert _rel_l2(g, want) <= tol, (path, _rel_l2(g, want), tol)


# ------------------------------------------------------------------ #
# the kernels' autograd.Functions, with the plain version in the
# kernel's place (on the CPU the forward is the plain version too)
# ------------------------------------------------------------------ #
def _leaves(rng, shapes: dict, dtype=torch.float32) -> dict:
    return {k: torch.from_numpy(rng.normal(size=s).astype(np.float32)
                                ).to(dtype).requires_grad_(True)
            for k, s in shapes.items()}


def _direct_and_function(fn, plain, args: dict, kw: dict, grad_fn: str):
    """Gradients of ``fn`` (through its Function) and of ``plain`` by
    direct autograd, against one seeded cotangent, for every input."""
    out = fn(*args.values(), **kw)
    assert type(out.grad_fn).__name__ == grad_fn
    cot = torch.from_numpy(np.random.default_rng(9).normal(
        size=tuple(out.shape)).astype(np.float32)).to(out.dtype)
    got = torch.autograd.grad(out, list(args.values()), cot)
    want_out = plain(*args.values(), **kw)
    want = torch.autograd.grad(want_out, list(args.values()), cot)
    assert torch.equal(out, want_out)
    return got, want


@pytest.mark.parametrize("window,q_offset,Sq", [(0, 0, 12), (5, 0, 12),
                                                (0, 4, 8)])
def test_flash_attention_function_grads_equal_plain(window, q_offset, Sq):
    rng = np.random.default_rng(4)
    args = _leaves(rng, {"q": (2, Sq, 4, 16), "k": (2, 12, 2, 16),
                         "v": (2, 12, 2, 16)})
    kw = dict(causal=True, window=window, q_offset=q_offset)
    got, want = _direct_and_function(ops.flash_attention, ops.plain_attention,
                                     args, kw, "FlashAttentionGradBackward")
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    # MLA's prefill pads v to q's width: the gradient reaches v's live
    # columns through the pad and nothing else
    v = torch.randn((2, 12, 2, 8), generator=torch.Generator().manual_seed(1),
                    requires_grad=True)
    out = ops.flash_attention(args["q"], args["k"],
                              torch.nn.functional.pad(v, (0, 8)), **kw)
    (gv,) = torch.autograd.grad(out[..., :8].sum(), [v])
    vp = v.detach().requires_grad_(True)
    (wv,) = torch.autograd.grad(ops.plain_attention(
        args["q"], args["k"], torch.nn.functional.pad(vp, (0, 8)),
        **kw)[..., :8].sum(), [vp])
    assert torch.equal(gv, wv)


@pytest.mark.parametrize("L,chunk", [(16, 8), (12, 8)])
def test_ssd_scan_function_grads_equal_plain(L, chunk):
    rng = np.random.default_rng(5)
    args = _leaves(rng, {"x": (2, L, 3, 4), "dt": (2, L, 3), "A": (3,),
                         "B": (2, L, 5), "C": (2, L, 5)})
    with torch.no_grad():
        args["dt"].abs_().mul_(0.1)
        args["A"].abs_().neg_()
    got, want = _direct_and_function(ops.ssd_scan, ref.ssd_chunked_ref, args,
                                     dict(chunk=chunk), "SsdScanGradBackward")
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("L,chunk", [(16, 8), (10, 4)])
def test_rwkv6_function_grads_equal_plain(L, chunk):
    rng = np.random.default_rng(6)
    args = _leaves(rng, {"r": (2, L, 3, 4), "k": (2, L, 3, 4),
                         "v": (2, L, 3, 4), "w": (2, L, 3, 4), "u": (3, 4)})
    with torch.no_grad():
        args["w"].abs_().neg_()
    got, want = _direct_and_function(ops.rwkv6_scan, ref.rwkv6_chunked_ref,
                                     args, dict(chunk=chunk),
                                     "Rwkv6ScanGradBackward")
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_ssd_gradient_is_finite_where_the_reference_overflows():
    """At large steps a chunk's decay sums above the diagonal overflow
    float32's exp (past ~88).  The reference masks after the exp, so its
    gradient in dt and A is NaN there (0 x inf); the port masks before it.
    At chunk 8 its outputs and its x, B, C gradients equal the
    reference's; its dt gradient equals the reference's at chunk 4, the
    same function, where no decay sum overflows."""
    from repro.kernels import ref as jref
    rng = np.random.default_rng(12)
    args = _leaves(rng, {"x": (1, 16, 2, 4), "B": (1, 16, 3),
                         "C": (1, 16, 3)})
    dt = torch.full((1, 16, 2), 20.0, requires_grad=True)
    A = torch.tensor([-1.0, -0.5], requires_grad=True)
    ins = [args["x"], dt, A, args["B"], args["C"]]
    y = ref.ssd_chunked_ref(*ins, chunk=8)
    got = torch.autograd.grad(y.sum(), ins)
    assert all(bool(torch.isfinite(g).all()) for g in got)
    jins = [jnp.asarray(t.detach().numpy()) for t in ins]

    def jgrad(chunk):
        return [np.asarray(g) for g in jax.grad(
            lambda *a: jref.ssd_chunked_ref(*a, chunk=chunk).sum(),
            argnums=(0, 1, 2, 3, 4))(*jins)]
    j8, j4 = jgrad(8), jgrad(4)
    assert [bool(np.isnan(g).any()) for g in j8] == \
        [False, True, True, False, False]
    assert all(np.isfinite(g).all() for g in j4)
    np.testing.assert_allclose(
        y.detach().numpy(), np.asarray(jref.ssd_chunked_ref(*jins, chunk=8)),
        rtol=1e-5, atol=1e-6)
    for i in (0, 3, 4):
        assert _rel_l2(got[i].numpy(), j8[i]) <= 1e-5, i
    assert _rel_l2(got[1].numpy(), j4[1]) <= 1e-5
    # A's gradient sums over every position, through exp(dA_cum) down to
    # e^-160: float32 chunkings scatter it by ~1e-3 (the reference's at
    # chunks 1, 2 and 4 lie up to 9e-4 from the float64 recurrence, the
    # port's at 8 2.4e-3), so it is held to the float64 recurrence
    ins64 = [t.detach().double().requires_grad_(True) for t in ins]
    (want_A,) = torch.autograd.grad(ref.ssd_sequential_ref(*ins64)[0].sum(),
                                    [ins64[2]])
    assert _rel_l2(got[2].numpy(), want_A.numpy()) <= 5e-3


def test_functions_return_none_for_inputs_without_grad_and_refuse_state():
    """Only the inputs that require grad get one (the non-tensor
    arguments and the rest get None); a scan that would carry a state in
    or out under autograd raises, and without autograd runs as before."""
    rng = np.random.default_rng(7)
    q = torch.from_numpy(rng.normal(size=(1, 6, 2, 8)).astype(np.float32))
    k = q.clone().requires_grad_(True)
    out = ops.flash_attention(q, k, q)
    out.sum().backward()
    assert k.grad is not None and q.grad is None
    x = torch.from_numpy(rng.normal(size=(1, 8, 2, 4)).astype(np.float32))
    dt, A = torch.full((1, 8, 2), 0.1), -torch.ones(2)
    Bm = torch.from_numpy(rng.normal(size=(1, 8, 3)).astype(np.float32))
    s0 = torch.zeros((1, 2, 4, 3))
    xg = x.clone().requires_grad_(True)
    for kw in (dict(initial_state=s0), dict(return_state=True)):
        with pytest.raises(NotImplementedError, match="zero state"):
            ops.ssd_scan(xg, dt, A, Bm, Bm, chunk=4, **kw)
    with torch.no_grad():
        y, s = ops.ssd_scan(xg, dt, A, Bm, Bm, chunk=4, initial_state=s0,
                            return_state=True)
    assert y.grad_fn is None and s.shape == (1, 2, 4, 3)
    r = torch.from_numpy(rng.normal(size=(1, 6, 2, 4)).astype(np.float32))
    w, u = -torch.full((1, 6, 2, 4), 0.5), torch.ones((2, 4))
    rg = r.clone().requires_grad_(True)
    with pytest.raises(NotImplementedError, match="zero state"):
        ops.rwkv6_scan(rg, r, r, w, u, chunk=4, return_state=True)
    y = ops.rwkv6_scan(rg, r, r, w, u, chunk=4)
    (gr,) = torch.autograd.grad(y.sum(), [rg])
    assert gr.shape == r.shape


# ------------------------------------------------------------------ #
# the train step against the reference's
# ------------------------------------------------------------------ #
def _mini(remat: bool = False, dtype=torch.float32, **over):
    return dataclasses.replace(get_config("minitron-4b", "smoke"),
                               remat=remat, dtype=dtype, **over)


@functools.lru_cache(maxsize=None)
def _jit_grad(cfg):
    """The reference's jitted gradient of ``loss_fn`` for ``cfg``, made
    once (the float64 one under jax x64)."""
    model = jbuild(cfg)
    return jax.jit(jax.grad(lambda p, b: jloss(model, p, b)[0]))


def _reference_grad_noise(cfg, params, batch: dict, micro: int) -> float:
    """The reference's own float32 error against float64 (jax x64) in
    relative L2 over the whole gradient of one step: ``batch`` split into
    ``micro`` equal parts, each part's gradient averaged, at ``params``."""
    def grad(cfg, p):
        dtype = cfg.dtype
        total = 0
        for i in range(micro):
            b = {k: jnp.asarray(np.split(v, micro)[i],
                                dtype if v.dtype == np.float32 else v.dtype)
                 for k, v in batch.items()}
            g = jpaths(_jit_grad(cfg)(p, b))
            total = total + np.concatenate(
                [np.asarray(x, np.float64).ravel() for _, x in sorted(
                    g.items())])
        return total / micro
    g32 = grad(cfg, params)
    jax.config.update("jax_enable_x64", True)
    try:
        p64 = jax.tree.map(lambda a: jnp.asarray(np.asarray(a), jnp.float64),
                           params)
        g64 = grad(dataclasses.replace(cfg, dtype=jnp.float64), p64)
    finally:
        jax.config.update("jax_enable_x64", False)
    return _rel_l2(g32, g64)


@pytest.mark.parametrize("micro", [1, 2])
def test_train_steps_match_reference(micro):
    """Three steps from the reference's weights and AdamW state (carried
    over with ``opt_state_from_reference``), against its ``make_train_step``
    in float32: parameters, master and moments after each step, and the
    metrics.  Moments in float32 here, so that one rounding of bf16 does
    not hide the comparison.

    ``grad_norm`` is held to the bound ``test_loss_and_grads_match_reference``
    holds each gradient to: 1e-4 plus twice the reference's own float32
    error against float64, on the step's weights and batch.  A gap of
    relative L2 ``tol`` between the two gradients bounds the gap between
    their norms by ``tol`` of the reference's norm (triangle inequality).
    MKL's AVX-512 sgemm alone puts the port's float32 gradients ~2.5x
    farther from float64 than with every product summed exactly, and the
    norms 1.4e-5 apart; the rest of the metrics keep 1e-5."""
    jm, _ = jax_model("minitron-4b", "float32", False, remat=False)
    jt = jloop.TrainConfig(
        opt=dataclasses.replace(jloop.AdamWConfig(), moment_dtype=jnp.float32,
                                lr=1e-3),
        microbatches=micro, warmup_steps=1, total_steps=6)
    jparams, jopt, _ = jloop.init_train_state(jm, jax.random.PRNGKey(0), jt)
    tt = TrainConfig(opt=AdamWConfig(moment_dtype=torch.float32, lr=1e-3),
                     microbatches=micro, warmup_steps=1, total_steps=6)
    model = build_model(_mini(), "cpu", seed=None)
    load_reference_params(model, {k: np.asarray(v)
                                  for k, v in jpaths(jparams).items()})
    model.requires_grad_(True)
    topt = opt_state_from_reference(jopt, tt.opt, "cpu")
    jstep = jloop.make_train_step(jm, jt)
    tstep = make_train_step(model, tt)
    for i in range(3):
        batch = _batch(model.cfg, seed=20 + i, B=4)
        norm_tol = 1e-4 + 2 * _reference_grad_noise(jm.cfg, jparams, batch,
                                                     micro)
        jparams, jopt, jmet = jstep(
            jparams, jopt, {k: jnp.asarray(v) for k, v in batch.items()})
        topt, tmet = tstep(topt, _torch_batch(batch))
        for key in ("loss", "ce", "lr_scale"):
            assert float(tmet[key]) == pytest.approx(float(jmet[key]),
                                                     rel=1e-5, abs=1e-7), key
        assert float(tmet["grad_norm"]) == pytest.approx(
            float(jmet["grad_norm"]), rel=norm_tol), norm_tol
        got = reference_paths(dict(model.named_parameters()))
        state = opt_state_to_reference(topt)
        assert state["step"] == int(jopt["step"]) == i + 1
        for path, want in jpaths(jparams).items():
            np.testing.assert_allclose(got[path].detach().numpy(),
                                       np.asarray(want), rtol=2e-4,
                                       atol=2e-5, err_msg=path)
            for key in ("master", "m", "v"):
                want = np.asarray(jpaths(jopt[key])[path])
                gap = np.abs(state[key][path].numpy() - want).max()
                assert gap <= 2e-4 * np.abs(want).max(), (key, path, gap)


def test_microbatching_matches_full_batch():
    """The reference's test on the port: grad accumulation over 2
    microbatches equals the full-batch step (its rtol 2e-4, atol 2e-5)."""
    batch = _torch_batch(_batch(_mini(), seed=1, B=4))
    outs = {}
    for micro in (1, 2):
        model = build_model(_mini(), "cpu", seed=0).requires_grad_(True)
        tcfg = TrainConfig(microbatches=micro, total_steps=10, warmup_steps=2)
        opt = adamw_init(model, tcfg.opt)
        step = make_train_step(model, tcfg)
        for _ in range(3):                 # past the warmup's zero scale
            opt, metrics = step(opt, batch)
        outs[micro] = (dict(model.named_parameters()), metrics)
    for name, p in outs[1][0].items():
        np.testing.assert_allclose(p.detach().numpy(),
                                   outs[2][0][name].detach().numpy(),
                                   rtol=2e-4, atol=2e-5, err_msg=name)
    assert float(outs[1][1]["loss"]) == pytest.approx(
        float(outs[2][1]["loss"]), rel=1e-5)
    with pytest.raises(ValueError, match="microbatches"):
        make_train_step(build_model(_mini(), "cpu").requires_grad_(True),
                        TrainConfig(microbatches=3))(
            adamw_init(model, tcfg.opt), batch)


def test_training_reduces_loss():
    """The reference's test on the port (bf16, its default dtype)."""
    from repro_torch.data.pipeline import DataConfig, PipelineParams, \
        TokenPipeline
    cfg = _mini(dtype=torch.bfloat16)
    model = build_model(cfg, "cpu", seed=None)
    trainer = Trainer(model, TrainConfig(total_steps=60, warmup_steps=5),
                      seed=0)
    pipe = TokenPipeline(DataConfig(cfg.vocab_size, 8, 32, seed=0),
                         PipelineParams())
    fixed = [pipe.next_batch() for _ in range(4)]
    pipe.close()
    log = trainer.run([fixed[i % 4] for i in range(60)])
    first = np.mean([m["loss"] for m in log[:8]])
    last = np.mean([m["loss"] for m in log[-8:]])
    assert last < first - 0.05, (first, last)
    assert all(m["step_time_s"] > 0 for m in log)
    assert [m["step"] for m in log] == list(range(60))
    assert trainer.step_times == [m["step_time_s"] for m in log]


@pytest.mark.parametrize("arch", ["minitron-4b", "mixtral-8x22b",
                                  "zamba2-7b", "rwkv6-1.6b"])
def test_remat_grads_equal_no_remat(arch):
    """Activation checkpointing recomputes each layer in the backward: the
    gradients are those of the plain backward, bit for bit."""
    grads = {}
    for remat in (False, True):
        cfg = dataclasses.replace(get_config(arch, "smoke"),
                                  dtype=torch.float32, remat=remat)
        model = build_model(cfg, "cpu", seed=3).requires_grad_(True)
        loss, _ = loss_fn(model, _torch_batch(_batch(cfg, seed=4)))
        loss.backward()
        grads[remat] = {n: p.grad for n, p in model.named_parameters()}
    for name, g in grads[False].items():
        assert (g is None) == (grads[True][name] is None), name
        if g is not None:
            assert torch.equal(g, grads[True][name]), name


def test_remat_only_where_autograd_records(monkeypatch):
    """Grad mode alone does not checkpoint a layer: a serving model's
    parameters require no grad, so its forward runs each layer directly;
    once they require grad, each layer runs under the checkpoint."""
    from repro_torch.models import model as model_mod
    calls = []

    def counted(fn, *args, **kw):
        calls.append(fn)
        return fn(*args)
    monkeypatch.setattr(model_mod, "checkpoint", counted)
    cfg = _mini(remat=True)
    model = build_model(cfg, "cpu", seed=3)
    tokens = _torch_batch(_batch(cfg, seed=4))["tokens"]
    assert torch.is_grad_enabled()
    model(tokens)
    assert calls == []
    model.requires_grad_(True)
    model(tokens)
    assert len(calls) == cfg.n_layers


def _state_tree(trainer: Trainer) -> dict:
    """Parameters and AdamW state in the reference's layout, as a tree."""
    opt = opt_state_to_reference(trainer.opt_state)
    return {"params": reference_paths(trainer.params),
            "opt": {k: opt[k] for k in ("m", "v", "master")},
            "step": torch.tensor(opt["step"], dtype=torch.int32)}


def _load_state(trainer: Trainer, tree: dict) -> None:
    flat = paths_from_tree(tree)
    with torch.no_grad():
        for section, target in (("params", trainer.params),
                                ("opt.m", trainer.opt_state["m"]),
                                ("opt.v", trainer.opt_state["v"]),
                                ("opt.master", trainer.opt_state["master"])):
            pre = section + "."
            part = split_reference_paths({k[len(pre):]: v for k, v in
                                          flat.items() if k.startswith(pre)})
            assert sorted(part) == sorted(target)
            for name, t in target.items():
                t.copy_(part[name])
    trainer.opt_state["step"] = flat["step"].clone()


def test_checkpoint_resume_continues_bit_for_bit(tmp_path):
    """Save after 2 steps (parameters and AdamW state, bf16 and float32
    leaves), restore into a fresh trainer, run 2 more: the parameters equal
    those of 4 uninterrupted steps bit for bit."""
    cfg = _mini(dtype=torch.bfloat16)
    tcfg = TrainConfig(total_steps=10, warmup_steps=1)
    batches = [_batch(cfg, seed=30 + i, B=4) for i in range(4)]
    whole = Trainer(build_model(cfg, "cpu", seed=None), tcfg, seed=0)
    whole.run(batches)
    first = Trainer(build_model(cfg, "cpu", seed=None), tcfg, seed=0)
    first.run(batches[:2])
    d = str(tmp_path / "ck")
    save_checkpoint(d, 2, _state_tree(first))
    host = restore_checkpoint(d, device="cpu")
    saved = paths_from_tree(_state_tree(first))
    for k, v in paths_from_tree(host).items():
        assert v.dtype == saved[k].dtype and torch.equal(v, saved[k]), k
    resumed = Trainer(build_model(cfg, "cpu", seed=None), tcfg, seed=5)
    _load_state(resumed, host)
    resumed.run(batches[2:])
    for name, p in whole.params.items():
        assert torch.equal(p, resumed.params[name]), name
    assert [m["loss"] for m in resumed.metrics_log] == \
        [m["loss"] for m in whole.metrics_log[2:]]


def test_recover_restores_on_one_device(tmp_path):
    """One surviving rank: a (1, 1) mesh, every leaf restored as a DTensor
    whose whole value is the saved one."""
    import torch.distributed as dist
    cfg = _mini()
    trainer = Trainer(build_model(cfg, "cpu", seed=None), TrainConfig(),
                      seed=0)
    d = str(tmp_path / "ck")
    save_checkpoint(d, 1, reference_paths(trainer.params))
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        plan, mesh, tree = elastic.recover(d, trainer.model.param_axes(),
                                           [0], device="cpu")
        assert plan == elastic.MeshPlan((1, 1), ("data", "model"), 1)
        assert tuple(mesh.shape) == (1, 1)
        for name, p in reference_paths(trainer.params).items():
            assert torch.equal(tree[name].full_tensor(), p), name
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("model_parallel", [1, 4, 16])
def test_plan_mesh_matches_reference(model_parallel):
    for n in (1, 2, 3, 4, 7, 8, 15, 16, 17, 31, 32, 100, 255, 256, 512):
        got = elastic.plan_mesh(n, model_parallel=model_parallel)
        want = jelastic.plan_mesh(n, model_parallel=model_parallel)
        assert (got.shape, got.axes, got.n_devices) == \
            (want.shape, want.axes, want.n_devices), n


def test_straggler_detector_matches_reference():
    rng = np.random.default_rng(11)
    pol_t = straggler.StragglerPolicy(z_threshold=3.0, window=8,
                                      evict_after=3)
    pol_j = jstraggler.StragglerPolicy(z_threshold=3.0, window=8,
                                       evict_after=3)
    got, want = (straggler.StragglerDetector(6, pol_t),
                 jstraggler.StragglerDetector(6, pol_j))
    for step in range(20):
        times = rng.normal(1.0, 0.02, size=6)
        if step >= 5:
            times[2] *= 1.8               # a persistent straggler
        a, b = got.record(times), want.record(times)
        np.testing.assert_array_equal(a["z"], b["z"])
        np.testing.assert_array_equal(a["flagged"], b["flagged"])
        np.testing.assert_array_equal(a["evict"], b["evict"])
        assert a["slowdown"] == b["slowdown"]
        assert straggler.rebalance_buckets(8, a["slowdown"]) == \
            jstraggler.rebalance_buckets(8, b["slowdown"])
    np.testing.assert_array_equal(got.shard_weights(), want.shard_weights())
    assert 2 in got.record(times)["evict"]


# ------------------------------------------------------------------ #
# the launcher
# ------------------------------------------------------------------ #
def test_train_cli_runs_saves_and_resumes_on_the_cpu(tmp_path, capsys):
    d = str(tmp_path / "run")
    args = ["--arch", "minitron-4b", "--variant", "smoke", "--device", "cpu",
            "--steps", "4", "--global-batch", "4", "--seq", "16",
            "--ckpt-dir", d, "--ckpt-every", "2"]
    log = train_cli.main(args)
    assert len(log) == 4 and all(np.isfinite(m["loss"]) for m in log)
    assert sorted(os.listdir(d))[:2] == ["step_00000002", "step_00000004"]
    # saved in the reference's layout: stacked layers
    host = paths_from_tree(restore_checkpoint(d, device="cpu"))
    assert "layers.attn.wq" in host and "embed" in host
    assert host["layers.attn.wq"].shape[0] == get_config(
        "minitron-4b", "smoke").n_layers
    log = train_cli.main(args[:-2] + ["--ckpt-every", "100", "--steps", "1"])
    assert len(log) == 1
    out = capsys.readouterr().out
    assert "resumed from step 4" in out and "device: cpu" in out


def test_train_cli_gives_the_vision_stub_patch_embeddings(tmp_path,
                                                          monkeypatch):
    seen = []
    real = loss_fn

    def spy(model, batch):
        seen.append(batch.get("patch_embeds"))
        return real(model, batch)
    monkeypatch.setattr("repro_torch.train.loop.loss_fn", spy)
    log = train_cli.main(["--arch", "qwen2-vl-2b", "--device", "cpu",
                          "--steps", "2", "--global-batch", "2", "--seq",
                          "16", "--microbatches", "2", "--ckpt-dir",
                          str(tmp_path / "q")])
    cfg = get_config("qwen2-vl-2b", "smoke")
    assert len(log) == 2 and len(seen) == 4
    assert all(pe is not None and pe.shape == (1, cfg.n_patches, cfg.d_model)
               and pe.dtype == cfg.dtype for pe in seen)
    assert not torch.equal(seen[0], seen[2])     # drawn anew each batch
