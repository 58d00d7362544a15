"""The port's optimizer package (``repro_torch.optim``) against the JAX
package's (``repro.optim``), on seeded numpy inputs.

- ``cosine_schedule`` at every step 0..N, to 1e-7 (both compute in
  float32; the two frameworks' ``cos`` may differ in the last place).
- ``global_norm`` to 1e-6 relative: the reference adds one float32 sum a
  leaf in sorted path order, as the port does, but a leaf's own sum is
  taken in another order.  ``clip_by_global_norm``'s leaves to the same.
- The int8 codecs: q equal, scale to 1e-7 relative; ties round half to
  even in both.
- ``adamw_update``: 5 steps on a seeded tree with ``moment_dtype`` bf16 and
  float32, with the schedule's scale, to 1e-6 relative (the same float32
  operations in the same order, leaf by leaf).
"""
import dataclasses

import numpy as np
import pytest
import torch
from torch import nn

import jax.numpy as jnp

from repro.models.params import paths_from_tree as jpaths
from repro.models.params import tree_from_paths as jtree
from repro.optim import adamw as jadamw
from repro.optim import grad_utils as jgu
from repro.optim import schedule as jsched
from repro_torch.optim import adamw as tadamw
from repro_torch.optim import grad_utils as tgu
from repro_torch.optim import schedule as tsched

SHAPES = {"embed": (48, 16), "layers.attn.wq": (3, 16, 4, 8),
          "layers.ln1": (3, 16), "ln_f": (16,), "head": (16, 48)}


def _tree(seed: int, scale: float = 1.0) -> dict[str, np.ndarray]:
    rng = np.random.default_rng(seed)
    return {k: (scale * rng.normal(size=s)).astype(np.float32)
            for k, s in SHAPES.items()}


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


@pytest.mark.parametrize("warmup,total,floor", [(100, 10_000, 0.1),
                                                (3, 12, 0.1), (0, 7, 0.0),
                                                (5, 5, 0.25)])
def test_cosine_schedule_matches_reference(warmup, total, floor):
    steps = np.arange(0, total + 4)
    kw = dict(warmup=warmup, total=total, floor=floor)
    want = np.array([float(jsched.cosine_schedule(s, **kw)) for s in steps])
    got = np.array([float(tsched.cosine_schedule(int(s), **kw))
                    for s in steps])
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-7)
    # a step tensor on the device keeps the schedule there, in float32
    out = tsched.cosine_schedule(torch.tensor(2, dtype=torch.int32), **kw)
    assert out.dtype == torch.float32 and out.shape == ()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_global_norm_and_clip_match_reference(dtype):
    flat = _tree(1, scale=0.3)
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "float32" else (
        jnp.bfloat16, torch.bfloat16)
    jt = jtree({k: jnp.asarray(v).astype(jdt) for k, v in flat.items()})
    tt = {k: torch.from_numpy(v).to(tdt) for k, v in flat.items()}
    assert _rel(tgu.global_norm(tt), jgu.global_norm(jt)) <= 1e-6
    # nested dicts are flattened to the same paths
    assert _rel(tgu.global_norm(jtree(tt)), jgu.global_norm(jt)) <= 1e-6
    for max_norm in (0.5, 1e6):           # clipped, and left as it is
        jc, jn = jgu.clip_by_global_norm(jt, max_norm)
        tc, tn = tgu.clip_by_global_norm(tt, max_norm)
        assert _rel(tn, jn) <= 1e-6
        jc = jpaths(jc)
        assert sorted(tc) == sorted(jc)
        for k in jc:
            assert tc[k].dtype == tdt
            assert _rel(tc[k].float().numpy(),
                        np.asarray(jc[k].astype(jnp.float32))) <= 1e-6, k


def test_global_norm_of_a_module_reads_its_parameters():
    m = nn.Sequential(nn.Linear(4, 3), nn.Linear(3, 2))
    want = torch.sqrt(sum(torch.sum(p.detach() ** 2) for p in m.parameters()))
    assert _rel(tgu.global_norm(m), want) <= 1e-6


def test_int8_codecs_match_reference():
    rng = np.random.default_rng(2)
    x = rng.normal(size=(16, 32)).astype(np.float32)
    # exact ties at the scale: 127 * k / 2 over max 127 rounds half to even
    x[0, :8] = np.array([0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 3.5, 127.0],
                        np.float32)
    xj, xt = jnp.asarray(x), torch.from_numpy(x)
    # a scale of exactly 1 (up to its 1e-12) puts the ties at .5
    s_j, s_t = jnp.float32(1.0), torch.tensor(1.0)
    for kw_j, kw_t in ((dict(), dict()), (dict(scale=s_j), dict(scale=s_t))):
        qj, sj = jgu.quantize_int8(xj, **kw_j)
        qt, st = tgu.quantize_int8(xt, **kw_t)
        assert qt.dtype == torch.int8
        np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
        assert _rel(st, sj) <= 1e-7
        assert _rel(tgu.dequantize_int8(qt, st),
                    jgu.dequantize_int8(qj, sj)) <= 1e-7
    assert tgu.quantize_int8(xt, scale=s_t)[0][0, :6].tolist() == \
        [0, 2, 2, 0, -2, -2]
    for axis in (None, 0, 1, (0, 1)):
        assert _rel(tgu.int8_scale(xt, axis=axis),
                    jgu.int8_scale(xj, axis=axis)) <= 1e-7


def _adamw_pair(moment: str, **over):
    jm, tm = (jnp.bfloat16, torch.bfloat16) if moment == "bf16" else (
        jnp.float32, torch.float32)
    return (jadamw.AdamWConfig(moment_dtype=jm, **over),
            tadamw.AdamWConfig(moment_dtype=tm, **over))


@pytest.mark.parametrize("moment", ["bf16", "float32"])
def test_adamw_update_matches_reference(moment):
    jcfg, tcfg = _adamw_pair(moment, lr=1e-2)
    p0 = _tree(3)
    jp = jtree({k: jnp.asarray(v) for k, v in p0.items()})
    jst = jadamw.adamw_init(jp, jcfg)
    tp = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
    tst = tadamw.adamw_init(tp, tcfg)
    assert tst["m"]["embed"].dtype == tcfg.moment_dtype
    assert tst["master"]["embed"].dtype == torch.float32
    for step in range(5):
        g = _tree(10 + step, scale=0.1)
        jscale = jsched.cosine_schedule(jst["step"], warmup=2, total=5)
        tscale = tsched.cosine_schedule(tst["step"], warmup=2, total=5)
        jp, jst = jadamw.adamw_update(
            jtree({k: jnp.asarray(v) for k, v in g.items()}), jst, jp, jcfg,
            jscale)
        _, tst = tadamw.adamw_update(
            {k: torch.from_numpy(v) for k, v in g.items()}, tst, tp, tcfg,
            tscale)
    assert int(tst["step"]) == int(jst["step"]) == 5
    for key in ("m", "v", "master"):
        jf = jpaths(jst[key])
        for k in SHAPES:
            assert tst[key][k].dtype == (tcfg.master_dtype if key == "master"
                                         else tcfg.moment_dtype)
            assert _rel(tst[key][k].float().numpy(),
                        np.asarray(jf[k].astype(jnp.float32))) <= 1e-6, (key, k)
    jf = jpaths(jp)
    for k in SHAPES:
        assert _rel(tp[k].numpy(), np.asarray(jf[k])) <= 1e-6, k


def test_adamw_writes_in_place_in_the_parameters_dtype():
    """The parameters keep their tensors (a later decode graph needs fixed
    addresses) and their dtype; the master stays float32."""
    model = nn.Linear(8, 4).to(torch.bfloat16).requires_grad_(True)
    cfg = tadamw.AdamWConfig(lr=0.1)
    st = tadamw.adamw_init(model, cfg)
    ptrs = {n: p.data_ptr() for n, p in model.named_parameters()}
    state_ptrs = {(k, n): t.data_ptr() for k in ("m", "v", "master")
                  for n, t in st[k].items()}
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    grads = {n: torch.ones_like(p) for n, p in model.named_parameters()}
    params, st = tadamw.adamw_update(grads, st, model, cfg)
    for n, p in model.named_parameters():
        assert p.data_ptr() == ptrs[n] and p.dtype == torch.bfloat16
        assert params[n] is p
        assert not torch.equal(p, before[n])
        assert torch.equal(p, st["master"][n].to(torch.bfloat16))
    assert all(st[k][n].data_ptr() == ptr for (k, n), ptr in state_ptrs.items())
    assert int(st["step"]) == 1


def test_adamw_init_abstract_is_meta():
    model = nn.Linear(8, 4)
    cfg = dataclasses.replace(tadamw.AdamWConfig(), moment_dtype=torch.float32)
    st = tadamw.adamw_init(model, cfg, abstract=True)
    for key in ("m", "v", "master"):
        for n, p in model.named_parameters():
            t = st[key][n]
            assert t.device.type == "meta" and t.shape == p.shape
            assert t.dtype == (cfg.master_dtype if key == "master"
                               else cfg.moment_dtype)
    assert st["step"].device.type == "meta" and st["step"].dtype == torch.int32
    # the reference's abstract state has the same shapes and dtypes
    jst = jadamw.adamw_init({"w": jnp.zeros((4, 8))},
                            jadamw.AdamWConfig(moment_dtype=jnp.float32),
                            abstract=True)
    assert jst["m"]["w"].shape == tuple(st["m"]["weight"].shape)
