"""Shared helpers of the parity tests that hold the port's attention-stack
language models (the dense and MoE families, DeepSeek's MLA included, and
the audio and vision-language families) to the JAX package's.

A model is built on each side from one set of weights: the reference's
``Model.init`` draws them and ``params.load_reference_params`` carries them
over.  ``run`` drives either side the same way (forward, prefill, teacher-
forced decode steps) and returns every output as float32 numpy, so one set
of comparisons serves both files.
"""
import dataclasses

import numpy as np
import torch

import jax
import jax.numpy as jnp

from repro_torch.configs import get_config
from repro_torch.models.model import build_model
from repro_torch.models.params import load_reference_params, paths_from_tree

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def jax_model(arch: str, dtype: str, use_pallas: bool, **overrides):
    from repro.configs import get_config as jget
    from repro.models.model import build_model as jbuild
    jcfg = dataclasses.replace(jget(arch, "smoke"), dtype=DTYPES[dtype][0],
                               use_pallas=use_pallas, **overrides)
    jm = jbuild(jcfg)
    params, _ = jm.init(jax.random.PRNGKey(0))
    return jm, params


def port_model(arch: str, dtype: str, use_kernel: bool, **overrides):
    """The port's model on the reference's weights (its float32 init; the
    bf16 init is the same values rounded, as the port's cast rounds
    them)."""
    _, params = jax_model(arch, "float32", False, **overrides)
    tcfg = dataclasses.replace(get_config(arch, "smoke"),
                               dtype=DTYPES[dtype][1], use_kernel=use_kernel,
                               **overrides)
    tm = build_model(tcfg, "cpu", seed=None)
    load_reference_params(tm, {k: np.asarray(v) for k, v
                               in paths_from_tree(params).items()})
    assert tm.cfg.use_kernel is use_kernel
    return tm


def f32(x):
    return (x.float().numpy() if isinstance(x, torch.Tensor)
            else np.asarray(jnp.asarray(x).astype(jnp.float32)))


def run(model, tokens: np.ndarray, S: int, steps: int, params=None,
        patch_embeds: np.ndarray | None = None) -> dict:
    """forward logits and aux on all of ``tokens`` ((B, S) or, with
    codebooks, (B, S, CB)), prefill logits on the first ``S``, ``steps``
    teacher-forced decode logits on the rest, and the cache after them, as
    float32 numpy (``len`` as int32), from either package (the JAX one when
    ``params`` is given).  ``patch_embeds`` (B, n, d) go to the forward and
    the prefill.  The cache's entries of ``layers`` keep their names (``k``,
    ``v``, ``len``; MLA: ``ckv``, ``krope``, ``len``), those of another stack
    take its name as a prefix (``dense_layers.ckv``)."""
    B = tokens.shape[0]
    jax_side = params is not None
    arr = jnp.asarray if jax_side else torch.from_numpy
    pe = None if patch_embeds is None else arr(patch_embeds)
    if jax_side:
        fwd, aux = model.forward(params, arr(tokens), pe)
        cache, _ = model.init_cache(B, S + steps + 4)
        lg, cache = model.prefill(params, arr(tokens[:, :S]), cache, pe)
    else:
        fwd, aux = model.forward(arr(tokens), pe)
        cache = model.init_cache(B, S + steps + 4)
        lg, cache = model.prefill(arr(tokens[:, :S]), cache, pe)
    out = {"forward": f32(fwd), "aux": float(aux), "prefill": f32(lg)}
    for j in range(steps):
        t = arr(tokens[:, S + j:S + j + 1])
        lg, cache = (model.decode(params, t, cache) if jax_side
                     else model.decode(t, cache))
        out[f"decode{j}"] = f32(lg)
    for stack, entries in cache.items():
        for key, val in entries.items():
            name = key if stack == "layers" else f"{stack}.{key}"
            out[name] = np.asarray(val) if key == "len" else f32(val)
    return out


CACHED = ("k", "v", "ckv", "krope")     # the cache's values, by leaf name


def _cache_keys(out: dict, leaves) -> list[str]:
    return sorted(k for k in out if k.rsplit(".", 1)[-1] in leaves)


def logit_keys(steps: int) -> list[str]:
    return ["forward", "prefill"] + [f"decode{j}" for j in range(steps)]


def err(a, b) -> float:
    return float(np.abs(a - b).max())


def clear_picks_equal(got, want, bound) -> int:
    """Greedy picks equal wherever the reference's pick is clear of the
    tolerance (best logit ahead of the second by more than 2 x bound);
    returns how many were clear."""
    two = np.sort(want, axis=-1)[..., -2:]
    clear = (two[..., 1] - two[..., 0]) > 2 * bound
    np.testing.assert_array_equal(np.argmax(got, -1)[clear],
                                  np.argmax(want, -1)[clear])
    return int(clear.sum())


def assert_float32_parity(got: dict, want: dict, steps: int) -> None:
    """Every logit within 1e-4 of max(|logits|, 1), clear greedy picks
    equal (at least 90% of picks clear), every cached value (KV or MLA's
    latents) within 1e-4 of its scale and ``len`` equal."""
    n_clear = n_all = 0
    for key in logit_keys(steps):
        bound = 1e-4 * max(float(np.abs(want[key]).max()), 1.0)
        assert err(got[key], want[key]) <= bound, (key, err(got[key],
                                                            want[key]), bound)
        n_clear += clear_picks_equal(got[key], want[key], bound)
        n_all += want[key][..., 0].size
    assert n_clear >= 0.9 * n_all
    assert _cache_keys(got, CACHED) == _cache_keys(want, CACHED)
    for key in _cache_keys(want, CACHED):
        assert got[key].shape == want[key].shape
        assert err(got[key], want[key]) <= 1e-4 * np.abs(want[key]).max(), key
    for key in _cache_keys(want, ("len",)):
        np.testing.assert_array_equal(got[key], want[key])
    assert abs(got["aux"] - want["aux"]) <= 1e-5 * max(abs(want["aux"]), 1.0)


def assert_bfloat16_as_close(got: dict, ref_bf16: dict, ref_f32: dict,
                             steps: int) -> None:
    """The port's bf16 outputs no farther from the reference's float32
    ones than the reference's own bf16 outputs are: 1.5x per logit row set
    (forward, prefill, each decode step), 1.25x on the RMS over all."""
    keys = logit_keys(steps)
    for key in keys:
        ours, theirs = err(got[key], ref_f32[key]), err(ref_bf16[key],
                                                         ref_f32[key])
        assert np.isfinite(got[key]).all()
        assert ours <= 1.5 * theirs, (key, ours, theirs)

    def rms(d):
        return np.sqrt(np.mean(np.concatenate(
            [(d[k] - ref_f32[k]).ravel() for k in keys]) ** 2))
    assert rms(got) <= 1.25 * rms(ref_bf16), (rms(got), rms(ref_bf16))
    for key in _cache_keys(ref_f32, ("len",)):
        np.testing.assert_array_equal(got[key], ref_f32[key])


def prefill_decode_consistency(arch: str, n_decode: int = 3) -> None:
    """decode(t), decode(t + 1), ... after prefill(t tokens) match the full
    forward at those positions (``tests/test_arch_smoke.py``'s check, in
    float32), and ``len`` counts every token.  The tolerance is 1e-4 of the
    logits' scale, not that test's 5%: in float32 on one framework the
    routes differ only in the order of sums (and the smoke MoE's capacity
    drops nothing), and a position read as a view of the first layer's
    ``len``, which roped every later layer at pos + 1, must fail it.
    ``len`` counts every token in every layer of every stack.  Tokens are
    (B, S, CB) with codebooks; with the vision stub, seeded patch
    embeddings go to the forward and the prefill."""
    cfg = dataclasses.replace(get_config(arch, "smoke"), dtype=torch.float32)
    model = build_model(cfg, "cpu", seed=1)
    S = 12
    rng = np.random.default_rng(1)
    toks = torch.from_numpy(rng.integers(
        0, cfg.vocab_size,
        (2, S + n_decode) + ((cfg.n_codebooks,) if cfg.n_codebooks else ())))
    pe = (torch.from_numpy(patch_embeds(rng, 2, cfg))
          if cfg.vision_stub else None)
    full, _ = model.forward(toks, pe)
    cache = model.init_cache(2, S + n_decode + 2)
    lg_pre, cache = model.prefill(toks[:, :S], cache, pe)
    tol = 1e-4 * max(float(full.abs().max()), 1.0)
    assert float((lg_pre - full[:, S - 1:S]).abs().max()) < tol
    for j in range(n_decode):
        lg, cache = model.decode(toks[:, S + j:S + j + 1], cache)
        assert float((lg - full[:, S + j:S + j + 1]).abs().max()) < tol, j
    lens = torch.cat([stack["len"].flatten() for stack in cache.values()])
    assert lens.tolist() == [S + n_decode] * cfg.n_layers


def patch_embeds(rng: np.random.Generator, batch: int, cfg) -> np.ndarray:
    """(batch, cfg.n_patches, d_model) float32 patch embeddings at the
    embedding table's scale, 0.02."""
    return rng.normal(0.0, 0.02, (batch, cfg.n_patches, cfg.d_model)
                      ).astype(np.float32)


# the reference unrolled, so that its top_k sees each layer's values
UNROLLED = {"scan_layers": False, "remat": False}


def moe_calls(cfg, steps: int) -> int:
    """MoE routings of one ``run``: each MoE layer in the forward, the
    prefill and each decode step."""
    dense = cfg.first_k_dense if cfg.n_experts else cfg.n_layers
    return (cfg.n_layers - dense) * (2 + steps)


def pinned_bf16(monkeypatch, arch: str, toks: np.ndarray, S: int,
                steps: int, kernels: bool):
    """(the port's bf16 run, the reference's bf16 run, the reference's
    float32 run) of ``run(.., toks, S, steps)``, every MoE layer of the two
    bf16 runs taking the experts (ids and order) that the float32 run's
    ``jax.lax.top_k`` chose at that call; gates are the run's own
    probabilities at those experts, renormalised as ``moe_forward`` does.
    Routing is a discrete function of bf16-rounded activations, and each
    framework's bf16 run sends some tokens to another expert than float32
    does, near-ties that fall either way, not the same tokens: pinned, the
    bf16 arithmetic alone is compared."""
    from repro_torch.models import moe as tmoe_mod
    top_k, route = jax.lax.top_k, tmoe_mod._route
    chosen = []

    def recording(probs, k):
        v, i = top_k(probs, k)
        chosen.append(np.asarray(i))
        return v, i

    monkeypatch.setattr(jax.lax, "top_k", recording)
    jm, params = jax_model(arch, "float32", kernels, **UNROLLED)
    ref_f32 = run(jm, toks, S, steps, params)
    assert len(chosen) == moe_calls(jm.cfg, steps)

    calls = iter(chosen)

    def pinned_jax(probs, k):
        i = jnp.asarray(next(calls))
        return jnp.take_along_axis(probs, i, axis=-1), i

    monkeypatch.setattr(jax.lax, "top_k", pinned_jax)
    jm, params = jax_model(arch, "bfloat16", kernels, **UNROLLED)
    ref_bf16 = run(jm, toks, S, steps, params)
    monkeypatch.setattr(jax.lax, "top_k", top_k)

    calls = iter(chosen)

    def pinned_port(p, xt, cfg):
        probs, _, _ = route(p, xt, cfg)
        i = torch.from_numpy(next(calls).copy()).long()
        v = probs.gather(-1, i)
        return probs, v / torch.clamp(v.sum(-1, keepdim=True), min=1e-9), i

    monkeypatch.setattr(tmoe_mod, "_route", pinned_port)
    got = run(port_model(arch, "bfloat16", kernels, **UNROLLED), toks, S,
              steps)
    assert next(calls, None) is None
    return got, ref_bf16, ref_f32
