"""Shared helpers of the parity tests that hold the port's attention-stack
language models (the dense and MoE families) to the JAX package's.

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


def run(model, tokens: np.ndarray, S: int, steps: int, params=None) -> dict:
    """forward logits and aux on all of ``tokens``, prefill logits on the
    first ``S``, ``steps`` teacher-forced decode logits on the rest, and
    the KV cache after them (``k``, ``v``, ``len``), as float32 numpy, from
    either package (the JAX one when ``params`` is given)."""
    B = tokens.shape[0]
    jax_side = params is not None
    arr = jnp.asarray if jax_side else torch.from_numpy
    if jax_side:
        fwd, aux = model.forward(params, arr(tokens))
        cache, _ = model.init_cache(B, S + steps + 4)
        lg, cache = model.prefill(params, arr(tokens[:, :S]), cache)
    else:
        fwd, aux = model.forward(arr(tokens))
        cache = model.init_cache(B, S + steps + 4)
        lg, cache = model.prefill(arr(tokens[:, :S]), cache)
    out = {"forward": f32(fwd), "aux": float(aux), "prefill": f32(lg)}
    for j in range(steps):
        t = arr(tokens[:, S + j:S + j + 1])
        lg, cache = (model.decode(params, t, cache) if jax_side
                     else model.decode(t, cache))
        out[f"decode{j}"] = f32(lg)
    for key in ("k", "v"):
        out[key] = f32(cache["layers"][key])
    out["len"] = np.asarray(cache["layers"]["len"])
    return out


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
    equal (at least 90% of picks clear), the KV cache within 1e-4 of its
    scale and ``len`` equal."""
    n_clear = n_all = 0
    for key in logit_keys(steps):
        bound = 1e-4 * max(float(np.abs(want[key]).max()), 1.0)
        assert err(got[key], want[key]) <= bound, (key, err(got[key],
                                                            want[key]), bound)
        n_clear += clear_picks_equal(got[key], want[key], bound)
        n_all += want[key][..., 0].size
    assert n_clear >= 0.9 * n_all
    for key in ("k", "v"):
        assert got[key].shape == want[key].shape
        assert err(got[key], want[key]) <= 1e-4 * np.abs(want[key]).max(), key
    np.testing.assert_array_equal(got["len"], want["len"])
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
    np.testing.assert_array_equal(got["len"], ref_f32["len"])


def prefill_decode_consistency(arch: str, n_decode: int = 3) -> None:
    """decode(t), decode(t + 1), ... after prefill(t tokens) match the full
    forward at those positions (``tests/test_arch_smoke.py``'s check, in
    float32), and ``len`` counts every token.  The tolerance is 1e-4 of the
    logits' scale, not that test's 5%: in float32 on one framework the
    routes differ only in the order of sums (and the smoke MoE's capacity
    drops nothing), and a position read as a view of layer 0's ``len``,
    which roped every later layer at pos + 1, must fail it."""
    cfg = dataclasses.replace(get_config(arch, "smoke"), dtype=torch.float32)
    model = build_model(cfg, "cpu", seed=1)
    S = 12
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, S + n_decode)))
    full, _ = model.forward(toks)
    cache = model.init_cache(2, S + n_decode + 2)
    lg_pre, cache = model.prefill(toks[:, :S], cache)
    tol = 1e-4 * max(float(full.abs().max()), 1.0)
    assert float((lg_pre - full[:, S - 1:S]).abs().max()) < tol
    for j in range(n_decode):
        lg, cache = model.decode(toks[:, S + j:S + j + 1], cache)
        assert float((lg - full[:, S + j:S + j + 1]).abs().max()) < tol, j
    assert cache["layers"]["len"].flatten().tolist() == \
        [S + n_decode] * cfg.n_layers
