"""The port's RWKV6 path against the JAX package's, and its kernel on the card.

On the CPU, inputs made with numpy from a seed:

- the plain twins in ``repro_torch.kernels.ref`` (``rwkv6_chunked_ref``,
  ``rwkv6_decode_step``, ``rwkv6_sequential_ref``) against
  ``repro.kernels.ref``: ragged L (padded with w = 0, r = k = 0), an
  initial state with the final state, L = 1 at chunk 1 (decode's call),
  K = V = 16 (the smoke config) and 64 (the full one);
- ``ops.rwkv6_scan`` (whose CPU route is the twin) against the reference's
  ``ops.rwkv6_scan(use_pallas=True)``, i.e. ``rwkv6_pallas`` in interpret
  mode.  That kernel takes no initial state and cannot pad with
  ``return_state``, so those cases are held to the oracle above only;
- ``rwkv6_time_mix`` and ``rwkv6_channel_mix`` on carried-over weights,
  with and without carried token-shift and WKV states;
- the rwkv6 smoke model (2 layers, d_model 64, chunk 8) through
  ``load_reference_params``: ``forward``, ``prefill`` and 4 ``decode``
  steps in float32 and bfloat16, prefill also against the reference's
  Pallas route; the port's prefill/decode consistency; the seeded init of
  the RWKV leaves; ``launch.serve`` for ``rwkv6-1.6b`` on the CPU.

Also on the CPU, ``_wkv_kernel_order``: the card kernel's arithmetic in
plain torch (its cumsum by 16-lane scans, the split or direct form a chunk
at a time, its partial sums and their order) against the reference's
chunked and token-by-token oracles, and its need of the direct form past
the cutoff.

On the card (``cuda`` marker): ``rwkv6_cuda`` against its twin.

Tolerances.  Float32: the twins repeat the reference's operations with
sums in another order, so 1e-4 (the WKV terms pass through exp of
within-chunk cumsums and sums over up to 64 channels); the Pallas kernel
in interpret mode is held to that too, and in bf16 to 2e-2 of the output's
scale (``tests/test_kernels.py``'s bf16 bound for its scans).  The model's
logits in float32 to 1e-4 of their scale; in bf16 the two frameworks round
at other places, so the port's bf16 logits are held to the reference's
float32 ones, no farther than the reference's own bf16 run (1.5x per
logit row, 1.25x on the RMS over all rows, as for zamba2).  The
prefill/decode consistency check has ``tests/test_arch_smoke.py``'s 5% of
the logits' scale.  On the card the kernel splits each pair's decay
across the operands as the twin does, but takes it directly,
exp(wcum_{t-1} - wcum_s), in a chunk whose |cumsum of w| passes 64; both
accumulate in float32 in another order, so 1e-4 of the output's scale plus
2^-20 of max|wcum| for the decays' float32 sensitivity, and in bf16 the
output's rounding (2^-8 of the scale, with margin 2^-6).  The kernel's
order in plain torch is held to the same float32 bound.
"""
import dataclasses

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from _port_parity import interpret_reference_lm_kernels
from repro_torch.configs import get_config
from repro_torch.kernels import ops, ref
from repro_torch.launch import serve as tserve
from repro_torch.models import rwkv as trwkv
from repro_torch.models.model import build_model
from repro_torch.models.params import (
    InitCtx, load_reference_params, paths_from_tree,
)


@pytest.fixture(scope="module")
def jax_pkg():
    """The JAX package's oracles, ops and models; imported here, so that
    the card tests also run on a machine that has the port but no jax:
    ``python -m pytest -q -m cuda tests/test_torch_rwkv.py``."""
    from types import SimpleNamespace

    pytest.importorskip("jax")

    import jax
    import jax.numpy as jnp
    from repro.kernels import ops as jops
    from repro.kernels import ref as jref
    return SimpleNamespace(jax=jax, jnp=jnp, ref=jref, ops=jops)


@pytest.fixture
def cuda():
    """The card; skips where there is none (decided at run time)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _np(x):
    return (x.float().numpy() if isinstance(x, torch.Tensor)
            else np.asarray(x, np.float32))


def _close(got, want, tol):
    np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=tol)


def _wkv_np(B, L, H, K, V, seed, init=False):
    """r, k, v, w, u (and s0) as numpy float32: w the model's decays,
    -exp(lora) clamped to [-4, -1e-4]."""
    rng = np.random.default_rng(seed)
    out = {name: rng.normal(size=(B, L, H, K)).astype(np.float32)
           for name in ("r", "k")}
    out["v"] = rng.normal(size=(B, L, H, V)).astype(np.float32)
    out["w"] = np.clip(-np.exp(1.5 * rng.normal(size=(B, L, H, K))),
                       -4.0, -1e-4).astype(np.float32)
    out["u"] = (0.5 * rng.normal(size=(H, K))).astype(np.float32)
    if init:
        out["s0"] = rng.normal(size=(B, H, K, V)).astype(np.float32)
    return out


def _jax_args(jnp, inp, dtype="float32"):
    dt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    return tuple(jnp.asarray(inp[n], dt) for n in "rkv") + (
        jnp.asarray(inp["w"]), jnp.asarray(inp["u"], dt))


def _torch_args(inp, dtype="float32", device="cpu"):
    dt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    return tuple(torch.from_numpy(inp[n]).to(device, dt) for n in "rkv") + (
        torch.from_numpy(inp["w"]).to(device),
        torch.from_numpy(inp["u"]).to(device, dt))


# ------------------------------- twins -------------------------------- #
TWIN_CASES = [
    # (B, L, H, K, V, chunk, init)
    (2, 32, 3, 16, 16, 8, False),        # the smoke config's head and chunk
    (1, 37, 2, 16, 16, 8, True),         # ragged L, initial state
    (2, 50, 2, 64, 64, 16, True),        # the full config's head, ragged
    (1, 48, 2, 64, 64, 16, False),       # the full config, L % chunk == 0
    (3, 1, 4, 64, 64, 1, True),          # decode: L = 1, chunk 1
    (2, 1, 2, 16, 16, 1, False),         # decode from a zero state
    (1, 21, 2, 16, 32, 8, True),         # K != V
]


@pytest.mark.parametrize("case", TWIN_CASES)
def test_rwkv6_chunked_twin_matches_reference(jax_pkg, case):
    B, L, H, K, V, chunk, init = case
    inp = _wkv_np(B, L, H, K, V, seed=L * H + K, init=init)
    jnp = jax_pkg.jnp
    s0j = jnp.asarray(inp["s0"]) if init else None
    s0t = torch.from_numpy(inp["s0"]) if init else None
    yj, sj = jax_pkg.ref.rwkv6_chunked_ref(
        *_jax_args(jnp, inp), chunk=chunk, initial_state=s0j,
        return_state=True)
    yt, st = ref.rwkv6_chunked_ref(*_torch_args(inp), chunk=chunk,
                                   initial_state=s0t, return_state=True)
    assert yt.shape == (B, L, H, V) and st.shape == (B, H, K, V)
    assert st.dtype == torch.float32 and yt.dtype == torch.float32
    _close(yt, yj, 1e-4)
    _close(st, sj, 1e-4)
    only_y = ref.rwkv6_chunked_ref(*_torch_args(inp), chunk=chunk,
                                   initial_state=s0t)
    assert torch.equal(only_y, yt)


def test_rwkv6_chunked_twin_keeps_the_dtypes(jax_pkg):
    """bf16 r, k, v, u and f32 w: y comes back in bf16 and the state in
    f32, within bf16 rounding of the reference."""
    inp = _wkv_np(2, 20, 2, 16, 16, seed=5, init=True)
    jnp = jax_pkg.jnp
    yj, sj = jax_pkg.ref.rwkv6_chunked_ref(
        *_jax_args(jnp, inp, "bfloat16"), chunk=8,
        initial_state=jnp.asarray(inp["s0"]), return_state=True)
    yt, st = ref.rwkv6_chunked_ref(*_torch_args(inp, "bfloat16"), chunk=8,
                                   initial_state=torch.from_numpy(inp["s0"]),
                                   return_state=True)
    assert yt.dtype == torch.bfloat16 and st.dtype == torch.float32
    scale = float(np.abs(_np(yj)).max())
    assert float(np.abs(_np(yt) - _np(yj)).max()) <= 2 ** -7 * scale
    _close(st, sj, 1e-4)


@pytest.mark.parametrize("init", [False, True])
@pytest.mark.parametrize("K", [16, 64])
def test_rwkv6_sequential_and_decode_step_match_reference(jax_pkg, K, init):
    inp = _wkv_np(2, 19, 2, K, K, seed=K + 7, init=init)
    jnp = jax_pkg.jnp
    s0j = jnp.asarray(inp["s0"]) if init else None
    s0t = torch.from_numpy(inp["s0"]) if init else None
    yj, sj = jax_pkg.ref.rwkv6_sequential_ref(*_jax_args(jnp, inp),
                                              initial_state=s0j)
    yt, st = ref.rwkv6_sequential_ref(*_torch_args(inp), initial_state=s0t)
    _close(yt, yj, 1e-4)
    _close(st, sj, 1e-4)
    # one decode step from the carried state
    args_j, args_t = _jax_args(jnp, inp), _torch_args(inp)
    y1j, n1j = jax_pkg.ref.rwkv6_decode_step(
        sj, *(a[:, 0] for a in args_j[:4]), args_j[4])
    y1t, n1t = ref.rwkv6_decode_step(
        st, *(a[:, 0] for a in args_t[:4]), args_t[4])
    _close(y1t, y1j, 1e-4)
    _close(n1t, n1j, 1e-4)
    # the chunked twin agrees with the sequential one
    for chunk in (1, 8):
        yc, sc = ref.rwkv6_chunked_ref(*_torch_args(inp), chunk=chunk,
                                       initial_state=s0t, return_state=True)
        _close(yc, yt, 1e-4)
        _close(sc, st, 1e-4)


@pytest.mark.parametrize("chunk", [16, 20, 23, 32])
def test_split_decay_overflows_past_chunk_22_as_the_reference_does(jax_pkg,
                                                                   chunk):
    """With every w at the model's clamp (-4), the oracle's split decay
    k exp(-wcum) passes float32's e^88.7 once the chunk passes 22; the twin
    copies the oracle, finite below and not from 23 on.  (At 22 the
    reference's products already reach float32's subnormals, which XLA on
    the CPU flushes to zero.  The model's chunk is 16; the kernel takes
    each pair's decay directly and has no such limit: its card test at
    chunks 32 and 64.)"""
    inp = _wkv_np(1, 64, 2, 16, 16, seed=9)
    inp["w"] = np.full_like(inp["w"], -4.0)
    yj = jax_pkg.ref.rwkv6_chunked_ref(*_jax_args(jax_pkg.jnp, inp),
                                       chunk=chunk)
    yt = ref.rwkv6_chunked_ref(*_torch_args(inp), chunk=chunk)
    ys, _ = ref.rwkv6_sequential_ref(*_torch_args(inp))
    finite = chunk <= 22
    assert bool(np.isfinite(np.asarray(yj)).all()) is finite
    assert bool(torch.isfinite(yt).all()) is finite
    if finite:
        _close(yt, ys, 1e-4)
        _close(yt, yj, 1e-4)


# ----------------------- the kernel's order of sums ---------------------- #
SPLIT_CUT = 64.0    # the largest |total| the kernel takes in the split form


def _w_pattern(w, mode, chunk):
    """The decays of a case: the model's random range (None), every w at
    the clamp (-4: |total| = 4 chunk), or chunks that alternate between
    -3.5 everywhere (even chunks) and the random range shrunk to [-1, 0)
    (odd chunks)."""
    if mode == "clamp":
        return np.full_like(w, -4.0)
    if mode == "straddle":
        out = np.maximum(w, -1.0)
        even = (np.arange(w.shape[1]) // chunk) % 2 == 0
        out[:, even] = -3.5
        return out
    return w


def _wkv_kernel_order(r, k, v, w, u, *, chunk, initial_state=None,
                      force_split=False):
    """``csrc/rwkv6.cu``'s arithmetic in plain torch float32, with its
    order of sums (mul and add rounded apart where the kernel fuses them):

    - the cumsum of w by 16-row blocks, each a Hillis-Steele scan (steps
      1, 2, 4, 8) plus the blocks before it; total is the scan's last row;
    - per (batch, head) chunk the split form where every |total| over K is
      at most SPLIT_CUT (``force_split``: always), else the direct form;
    - A below the diagonal and the bonus as four partial sums, quarter q
      over k = 4 (q + 4 i) + 0..3 in that order, reduced (q0 + q1) +
      (q2 + q3);
    - y as four partial sums, quarter q over k = q mod 4 ascending and then
      s = q mod 4 ascending below 4 (t // 4) + 4, reduced (q0 + q2) +
      (q1 + q3);
    - S = exp(total) S, then k_tail[s]^T v[s] added row by row.

    Returns y (float32), the final state and the number of (batch, head)
    chunks that took the direct form."""
    f32 = torch.float32
    r, k, v, w = (t.to(f32) for t in (r, k, v, w))
    u = u.to(f32)
    Bsz, L, H, K = r.shape
    V = v.shape[-1]
    K4 = -(-K // 4) * 4
    qp = -(-chunk // 4) * 4
    n_chunks = -(-L // chunk)

    def rows(x, width):      # (B, H, n_chunks, qp, width): zero past L, K4
        x = F.pad(x, (0, width - x.shape[-1], 0, 0, 0, n_chunks * chunk - L))
        x = x.reshape(Bsz, n_chunks, chunk, H, width).permute(0, 3, 1, 2, 4)
        return F.pad(x, (0, 0, 0, qp - chunk))
    rc, kc, wc_in = rows(r, K4), rows(k, K4), rows(w, K4)
    vc = rows(v, V)
    u4 = F.pad(u, (0, K4 - K))                                  # (H, K4)
    S = (torch.zeros((Bsz, H, K4, V), dtype=f32) if initial_state is None
         else F.pad(initial_state.to(f32), (0, 0, 0, K4 - K)))
    ys, n_direct = [], 0
    rr = torch.arange(qp)
    lower = rr[:, None] > rr[None, :]                           # s < t
    for c in range(n_chunks):
        Lc = min(chunk, L - c * chunk)
        rw, kw, vw, ww = (x[:, :, c] for x in (rc, kc, vc, wc_in))
        # cumsum: 16-row blocks, a Hillis-Steele scan each, plus the carry
        blocks, carry = [], torch.zeros((Bsz, H, 1, K4), dtype=f32)
        for rb in range(0, qp, 16):
            x = F.pad(ww[:, :, rb:rb + 16], (0, 0, 0, 16 - min(16, qp - rb)))
            for d in (1, 2, 4, 8):
                x = torch.cat([x[:, :, :d], x[:, :, d:] + x[:, :, :-d]], 2)
            x = x + carry
            carry = x[:, :, 15:16]
            blocks.append(x)
        wcum = torch.cat(blocks, 2)[:, :, :qp]
        total = carry                                            # (B,H,1,K4)
        safe = total.abs() <= SPLIT_CUT
        ri = rw * torch.exp(wcum - ww)
        kt = kw * torch.exp(total - wcum)
        kn = kw * torch.exp(-wcum)
        if not force_split:
            kn = torch.where(safe, kn, torch.zeros(()))
        direct = ~safe.all(-1) & (not force_split)               # (B,H,1)
        n_direct += int(direct.sum())
        # A: four partial sums over K, quarter q taking k = 4 (q + 4 i) + j
        split_p = torch.zeros((4, Bsz, H, qp, qp), dtype=f32)
        direct_p = torch.zeros_like(split_p)
        bonus_p = torch.zeros((4, Bsz, H, qp), dtype=f32)
        for i in range(0, K4, 16):
            for j in range(4):
                for q in range(4):
                    kk = i + 4 * q + j
                    if kk >= K4:
                        continue
                    split_p[q] = split_p[q] + (ri[..., :, None, kk]
                                               * kn[..., None, :, kk])
                    decay = torch.exp((wcum[..., :, None, kk]
                                       - ww[..., :, None, kk])
                                      - wcum[..., None, :, kk])
                    direct_p[q] = direct_p[q] + (rw[..., :, None, kk]
                                                 * kw[..., None, :, kk]) * decay
                    bonus_p[q] = bonus_p[q] + (rw[..., kk] * u4[:, kk, None]
                                               ) * kw[..., kk]
        reduce4 = (lambda p: (p[0] + p[1]) + (p[2] + p[3]))
        A = torch.where(direct[..., None], reduce4(direct_p), reduce4(split_p))
        A = torch.where(lower, A, torch.zeros(()))
        A = A + torch.diag_embed(reduce4(bonus_p))
        live = rr < Lc
        A = torch.where(live[:, None] & live[None, :], A, torch.zeros(()))
        # y: four partial sums, quarter q over k = q mod 4, then s = q mod 4
        part = torch.zeros((4, Bsz, H, qp, V), dtype=f32)
        for kk in range(K4):
            part[kk % 4] = part[kk % 4] + ri[..., :, kk, None] * S[..., None, kk, :]
        s_end = torch.clamp(4 * (rr // 4) + 4, max=Lc)           # per row t
        for s in range(qp):
            add = A[..., :, s, None] * vw[..., None, s, :]
            part[s % 4] = part[s % 4] + torch.where(
                (s < s_end)[:, None], add, torch.zeros(()))
        ys.append(((part[0] + part[2]) + (part[1] + part[3]))[:, :, :Lc])
        # the state: decay, then the chunk's rows in order
        S = S * torch.exp(total).transpose(-1, -2)
        for s in range(Lc):
            S = S + kt[..., s, :, None] * vw[..., s, None, :]
    y = torch.cat(ys, 2).permute(0, 2, 1, 3)                     # (B,L,H,V)
    return y, S[:, :, :K], n_direct


EMU_CASES = [
    # (B, L, H, K, V, chunk, init, w): each (batch, head) chunk's form is
    # checked too -- the model's decays at chunk <= 16 never leave the split
    (2, 37, 2, 16, 16, 8, True, None),        # ragged, initial state
    (1, 50, 2, 64, 64, 16, True, None),       # the full head, ragged
    (2, 3, 2, 64, 64, 1, True, None),         # decode's chunk 1
    (1, 48, 2, 64, 64, 16, False, "clamp"),   # |total| = 64: all split
    (1, 70, 2, 16, 16, 20, True, "straddle"), # direct and split in turn
    (1, 29, 2, 6, 10, 8, True, None),         # K, V not multiples of 4
]


@pytest.mark.parametrize("case", EMU_CASES)
def test_kernel_order_matches_reference(jax_pkg, case):
    """The kernel's arithmetic (its order of sums, the split and direct
    forms at the cutoff) against the JAX package's chunked oracle and its
    token-by-token oracle, in float32: 1e-4 of the scale for the order of
    sums, plus 2^-20 of max |wcum| for the decays' float32 sensitivity (the
    card tests' tolerance)."""
    B, L, H, K, V, chunk, init, wmode = case
    inp = _wkv_np(B, L, H, K, V, seed=L + K + chunk, init=init)
    inp["w"] = _w_pattern(inp["w"], wmode, chunk)
    s0 = torch.from_numpy(inp["s0"]) if init else None
    y, s, n_direct = _wkv_kernel_order(*_torch_args(inp), chunk=chunk,
                                       initial_state=s0)
    n_chunks = -(-L // chunk)
    assert n_direct == (B * H * ((n_chunks + 1) // 2) if wmode == "straddle"
                        else 0)
    assert torch.isfinite(y).all() and torch.isfinite(s).all()
    jnp = jax_pkg.jnp
    s0j = jnp.asarray(inp["s0"]) if init else None
    for name, (yj, sj) in (
            ("chunked", jax_pkg.ref.rwkv6_chunked_ref(
                *_jax_args(jnp, inp), chunk=chunk, initial_state=s0j,
                return_state=True)),
            ("sequential", jax_pkg.ref.rwkv6_sequential_ref(
                *_jax_args(jnp, inp), initial_state=s0j))):
        for got, want in ((y, yj), (s, sj)):
            want = _np(want)
            tol = (1e-4 + 2 ** -20 * 4 * chunk) * np.abs(want).max()
            assert np.abs(_np(got) - want).max() <= tol, name


@pytest.mark.parametrize("force_split", [False, True])
def test_kernel_order_needs_the_direct_form_past_the_cutoff(force_split):
    """At w = -4 and chunk 24 (|total| = 96) the split form's exp(-wcum)
    passes float32's range: the kernel's order, which takes the direct form
    there, stays finite and matches the token-by-token oracle; forced to
    split, it does not."""
    inp = _wkv_np(1, 48, 2, 16, 16, seed=4, init=True)
    inp["w"] = np.full_like(inp["w"], -4.0)
    s0 = torch.from_numpy(inp["s0"])
    y, s, n_direct = _wkv_kernel_order(*_torch_args(inp), chunk=24,
                                       initial_state=s0,
                                       force_split=force_split)
    if force_split:
        assert not torch.isfinite(y).all()
        return
    assert n_direct == 2 * 2
    ys, ss = ref.rwkv6_sequential_ref(*_torch_args(inp), initial_state=s0)
    for got, want in ((y, ys), (s, ss)):
        tol = (1e-4 + 2 ** -20 * 96) * float(want.abs().max())
        assert float((got - want).abs().max()) <= tol


PALLAS_CASES = [
    # (B, L, H, K, chunk, return_state, dtype): the Pallas kernel takes no
    # initial state, and pads a ragged L only without return_state
    (2, 64, 2, 16, 16, False, "float32"),
    (1, 48, 3, 64, 16, True, "float32"),
    (1, 40, 2, 16, 8, True, "float32"),
    (2, 37, 2, 16, 8, False, "float32"),       # ragged, padded
    (1, 32, 2, 64, 16, False, "bfloat16"),
]


@pytest.mark.parametrize("case", PALLAS_CASES)
def test_rwkv6_scan_dispatch_matches_pallas_interpret(jax_pkg, monkeypatch,
                                                      case):
    B, L, H, K, chunk, rs, dtype = case
    interpret_reference_lm_kernels(monkeypatch)
    inp = _wkv_np(B, L, H, K, K, seed=L + K)
    want = jax_pkg.ops.rwkv6_scan(*_jax_args(jax_pkg.jnp, inp, dtype),
                                  chunk=chunk, return_state=rs,
                                  use_pallas=True)
    got = ops.rwkv6_scan(*_torch_args(inp, dtype), chunk=chunk,
                         return_state=rs)
    if rs:
        (got, st), (want, sw) = got, want
        _close(st, sw, 1e-4)
    assert got.dtype == (torch.bfloat16 if dtype == "bfloat16"
                         else torch.float32)
    if dtype == "bfloat16":
        scale = float(np.abs(_np(want)).max())
        assert float(np.abs(_np(got) - _np(want)).max()) <= 2e-2 * scale
    else:
        _close(got, want, 1e-4)


def test_pallas_route_cannot_take_what_decode_and_ragged_prefill_need(
        jax_pkg, monkeypatch):
    """The reason the cases above skip the initial state and the padded
    final state: the reference's Pallas kernel refuses both, which the
    port's kernel takes (its card test below)."""
    interpret_reference_lm_kernels(monkeypatch)
    inp = _wkv_np(1, 12, 2, 16, 16, seed=3, init=True)
    args = _jax_args(jax_pkg.jnp, inp)
    with pytest.raises(AssertionError, match="initial_state"):
        jax_pkg.ops.rwkv6_scan(*args, chunk=1,
                               initial_state=jax_pkg.jnp.asarray(inp["s0"]),
                               use_pallas=True)
    with pytest.raises(NotImplementedError, match="padded"):
        jax_pkg.ops.rwkv6_scan(*args, chunk=8, return_state=True,
                               use_pallas=True)


# ------------------------------- layers ------------------------------- #
def _layer_pair(jax_pkg, seed=0):
    """One RWKV6 block's weights from the reference's init, in both
    packages (float32 smoke config)."""
    jnp = jax_pkg.jnp
    from repro.configs import get_config as jget
    from repro.models import rwkv as jrwkv
    from repro.models.params import InitCtx as JCtx
    jcfg = dataclasses.replace(jget("rwkv6-1.6b", "smoke"), dtype=jnp.float32)
    cfg = dataclasses.replace(get_config("rwkv6-1.6b", "smoke"),
                              dtype=torch.float32, use_kernel=False)
    p = jrwkv.rwkv6_init(jcfg, JCtx(key=jax_pkg.jax.random.PRNGKey(seed),
                                    dtype=jnp.float32, abstract=False), "t")
    blk = trwkv.rwkv6_init(cfg, InitCtx(torch.float32, torch.device("cpu")))
    for name, arr in p.items():
        getattr(blk, name).copy_(torch.from_numpy(np.array(arr)))
    return jrwkv, jcfg, p, cfg, blk


@pytest.mark.parametrize("carried", [False, True])
def test_time_and_channel_mix_match_reference(jax_pkg, carried):
    jnp = jax_pkg.jnp
    jrwkv, jcfg, p, cfg, blk = _layer_pair(jax_pkg)
    rng = np.random.default_rng(11 + carried)
    B, L, d = 2, 13, cfg.d_model
    H, K = trwkv.rwkv6_heads(cfg), cfg.head_dim
    x = rng.normal(size=(B, L, d)).astype(np.float32)
    kw_j, kw_t = {}, {}
    if carried:
        sh = rng.normal(size=(B, d)).astype(np.float32)
        wkv = rng.normal(size=(B, H, K, K)).astype(np.float32)
        kw_j = dict(shift_state=jnp.asarray(sh), wkv_state=jnp.asarray(wkv))
        kw_t = dict(shift_state=torch.from_numpy(sh),
                    wkv_state=torch.from_numpy(wkv))
    oj, fj, lj = jrwkv.rwkv6_time_mix(p, jnp.asarray(x), jcfg,
                                      return_state=True, **kw_j)
    ot, ft, lt = trwkv.rwkv6_time_mix(blk, torch.from_numpy(x), cfg,
                                      return_state=True, **kw_t)
    _close(ot, oj, 1e-4)
    _close(ft, fj, 1e-4)
    _close(lt, lj, 0)
    assert torch.equal(trwkv.rwkv6_time_mix(blk, torch.from_numpy(x), cfg,
                                            **kw_t), ot)
    ckw_j = {"shift_state": kw_j["shift_state"]} if carried else {}
    ckw_t = {"shift_state": kw_t["shift_state"]} if carried else {}
    cj, clj = jrwkv.rwkv6_channel_mix(p, jnp.asarray(x), jcfg,
                                      return_state=True, **ckw_j)
    ct, clt = trwkv.rwkv6_channel_mix(blk, torch.from_numpy(x), cfg,
                                      return_state=True, **ckw_t)
    _close(ct, cj, 1e-4)
    _close(clt, clj, 0)


def test_decay_stays_in_the_clamped_range(jax_pkg):
    """``_decay`` gives w in [-rwkv_w_clamp, -1e-4], float32, as the
    reference's does on the same input."""
    jnp = jax_pkg.jnp
    jrwkv, jcfg, p, cfg, blk = _layer_pair(jax_pkg, seed=2)
    x = (4.0 * np.random.default_rng(4).normal(
        size=(2, 9, cfg.d_model))).astype(np.float32)
    wj = jrwkv._decay(p, jnp.asarray(x), jcfg.rwkv_w_clamp)
    wt = trwkv._decay(blk, torch.from_numpy(x), cfg.rwkv_w_clamp)
    assert wt.dtype == torch.float32
    assert float(wt.min()) >= -cfg.rwkv_w_clamp and float(wt.max()) <= -1e-4
    _close(wt, wj, 1e-5)


# ------------------------------- model -------------------------------- #
B, S, STEPS = 2, 16, 4         # S a multiple of the smoke chunk (8): the
                               # Pallas kernel pads no L with a final state
TOKENS = np.random.default_rng(0).integers(0, 256, (B, S + STEPS))


def _jax_model(jax_pkg, dtype: str, use_pallas: bool):
    from repro.configs import get_config as jget
    from repro.models.model import build_model as jbuild
    jnp = jax_pkg.jnp
    jcfg = dataclasses.replace(
        jget("rwkv6-1.6b", "smoke"), use_pallas=use_pallas,
        dtype=jnp.bfloat16 if dtype == "bfloat16" else jnp.float32)
    jm = jbuild(jcfg)
    params, _ = jm.init(jax_pkg.jax.random.PRNGKey(0))
    return jm, params


def _port_model(jax_pkg, dtype: str, use_kernel: bool):
    """The port's model on the reference's weights (its float32 init)."""
    _, params = _jax_model(jax_pkg, "float32", False)
    tcfg = dataclasses.replace(
        get_config("rwkv6-1.6b", "smoke"), use_kernel=use_kernel,
        dtype=torch.bfloat16 if dtype == "bfloat16" else torch.float32)
    tm = build_model(tcfg, "cpu", seed=None)
    load_reference_params(tm, {k: np.asarray(v) for k, v
                               in paths_from_tree(params).items()})
    return tm


def _run(jax_pkg, model, params=None, decode: bool = True):
    """forward logits, prefill logits, STEPS teacher-forced decode logits
    (``decode``) and the cache after them, as float32 numpy, from either
    package."""
    jnp = jax_pkg.jnp
    jax_side = params is not None
    arr = jnp.asarray if jax_side else torch.from_numpy
    f32 = (lambda a: np.asarray(a.astype(jnp.float32))) if jax_side else _np
    fwd = (model.forward(params, arr(TOKENS)) if jax_side
           else model.forward(arr(TOKENS)))[0]
    if jax_side:
        cache, _ = model.init_cache(B, S + STEPS)
        lg, cache = model.prefill(params, arr(TOKENS[:, :S]), cache)
    else:
        cache = model.init_cache(B, S + STEPS)
        lg, cache = model.prefill(arr(TOKENS[:, :S]), cache)
    out = {"forward": f32(fwd), "prefill": f32(lg)}
    for j in range(STEPS if decode else 0):
        t = arr(TOKENS[:, S + j:S + j + 1])
        lg, cache = (model.decode(params, t, cache) if jax_side
                     else model.decode(t, cache))
        out[f"decode{j}"] = f32(lg)
    for key in ("wkv", "shift_t", "shift_c"):
        out[key] = f32(cache["layers"][key])
    return out


_REFERENCE = {}


def _reference(jax_pkg, dtype: str, use_pallas: bool = False):
    """The JAX model's outputs, computed once per (dtype, route); the
    Pallas route without decode, whose first step it refuses."""
    key = (dtype, use_pallas)
    if key not in _REFERENCE:
        _REFERENCE[key] = _run(jax_pkg, *_jax_model(jax_pkg, dtype,
                                                    use_pallas),
                               decode=not use_pallas)
    return _REFERENCE[key]


def _err(a, b):
    return float(np.abs(a - b).max())


LOGITS = ["forward", "prefill"] + [f"decode{j}" for j in range(STEPS)]


@pytest.mark.parametrize("kernels", [False, True], ids=["oracles", "kernels"])
def test_rwkv6_smoke_matches_reference_float32(jax_pkg, kernels):
    """The reference on its oracles; the port on both of its routes (on the
    CPU both are the twin)."""
    want = _reference(jax_pkg, "float32")
    got = _run(jax_pkg, _port_model(jax_pkg, "float32", kernels))
    for key in LOGITS:
        bound = 1e-4 * max(float(np.abs(want[key]).max()), 1.0)
        assert _err(got[key], want[key]) <= bound, key
        np.testing.assert_array_equal(np.argmax(got[key], -1),
                                      np.argmax(want[key], -1))
    for key in ("wkv", "shift_t", "shift_c"):
        assert _err(got[key], want[key]) <= 1e-4 * max(
            float(np.abs(want[key]).max()), 1.0), key


def test_rwkv6_smoke_prefill_matches_reference_pallas_interpret(
        jax_pkg, monkeypatch):
    """``forward`` and ``prefill`` against the reference with its Pallas
    kernel in interpret mode (decode is held to its oracle route above:
    the Pallas kernel asserts on the carried state)."""
    interpret_reference_lm_kernels(monkeypatch)
    want = _reference(jax_pkg, "float32", use_pallas=True)
    got = _run(jax_pkg, _port_model(jax_pkg, "float32", True), decode=False)
    for key in ("forward", "prefill", "wkv", "shift_t", "shift_c"):
        bound = 1e-4 * max(float(np.abs(want[key]).max()), 1.0)
        assert _err(got[key], want[key]) <= bound, key


def test_rwkv6_smoke_bfloat16_as_close_as_the_reference(jax_pkg):
    """In bf16 the port is held to the reference's float32 outputs, no
    farther from them than the reference's own bf16 run, with zamba2's
    margins (1.5x per logit row, 1.25x on the RMS over all rows)."""
    f32 = _reference(jax_pkg, "float32")
    ref_bf16 = _reference(jax_pkg, "bfloat16")
    got = _run(jax_pkg, _port_model(jax_pkg, "bfloat16", False))
    for key in LOGITS:
        ours, theirs = _err(got[key], f32[key]), _err(ref_bf16[key], f32[key])
        assert np.isfinite(got[key]).all()
        assert ours <= 1.5 * theirs, (key, ours, theirs)

    def rms(d):
        return np.sqrt(np.mean(np.concatenate(
            [(d[k] - f32[k]).ravel() for k in LOGITS]) ** 2))
    assert rms(got) <= 1.25 * rms(ref_bf16), (rms(got), rms(ref_bf16))


def test_rwkv6_prefill_decode_consistency_on_the_port():
    """Decoding token by token from an empty cache gives the prefill's
    last logits, and decode(t) after prefill(t - 1 tokens) matches the
    full forward (``tests/test_arch_smoke.py``'s check, in float32)."""
    cfg = dataclasses.replace(get_config("rwkv6-1.6b", "smoke"),
                              dtype=torch.float32)
    model = build_model(cfg, "cpu", seed=1)
    toks = torch.from_numpy(np.random.default_rng(1).integers(0, 256, (2, 13)))
    full, aux = model.forward(toks)
    assert float(aux) == 0.0
    scale = float(full.abs().max())
    tol = 0.05 * max(scale, 1.0)
    cache = model.init_cache(2, 16)
    lg_pre, cache = model.prefill(toks[:, :12], cache)
    lg_dec, cache = model.decode(toks[:, 12:13], cache)
    assert float((lg_pre - full[:, 11:12]).abs().max()) < tol
    assert float((lg_dec - full[:, 12:13]).abs().max()) < tol
    # token by token from the zero state
    step_cache = model.init_cache(2, 16)
    for t in range(12):
        lg, step_cache = model.decode(toks[:, t:t + 1], step_cache)
    assert float((lg - lg_pre).abs().max()) < 1e-4 * max(scale, 1.0)
    layers = model.init_cache(2, 16)["layers"]
    _, pre_cache = model.prefill(toks[:, :12], model.init_cache(2, 16))
    # each state within 1e-5 of its own scale: the chunked prefill and the
    # step-by-step decode sum the WKV state in another float32 order
    for key in ("wkv", "shift_t", "shift_c"):
        assert layers[key].shape == step_cache["layers"][key].shape
        want = _np(pre_cache["layers"][key])
        np.testing.assert_allclose(
            _np(step_cache["layers"][key]), want, rtol=0,
            atol=1e-5 * max(float(np.abs(want).max()), 1.0))


def test_rwkv6_prefill_ignores_the_incoming_cache():
    """As the reference's: a prefill starts from zero shift and WKV states,
    whatever the cache it is given holds, and overwrites them."""
    cfg = dataclasses.replace(get_config("rwkv6-1.6b", "smoke"),
                              dtype=torch.float32)
    model = build_model(cfg, "cpu", seed=2)
    toks = torch.from_numpy(np.random.default_rng(2).integers(0, 256, (2, 9)))
    clean, c1 = model.prefill(toks, model.init_cache(2, 9))
    dirty = model.init_cache(2, 9)
    for t in dirty["layers"].values():
        t.fill_(3.0)
    again, c2 = model.prefill(toks, dirty)
    assert torch.equal(clean, again)
    for key in c1["layers"]:
        assert torch.equal(c1["layers"][key], c2["layers"][key])


def test_rwkv6_init_follows_the_reference_rule(jax_pkg):
    """The RWKV leaves of the stack: w_base zeros, mu_* and ln* ones, u and
    every matrix normal with std 1/sqrt(n_layers) (u's scale 0.1 dropped,
    as the reference's ``stack_leaf`` drops it); the reference's own init
    shows the same spreads.  Seeded: the same seed gives the same
    weights."""
    jnp = jax_pkg.jnp
    from repro.configs import get_config as jget
    from repro.models.model import build_model as jbuild
    cfg = dataclasses.replace(get_config("rwkv6-1.6b", "full"), n_layers=24,
                              d_model=256, n_heads=4, head_dim=64, d_ff=512,
                              vocab_size=512, dtype=torch.float32)
    model = build_model(cfg, "cpu", seed=3)
    jcfg = dataclasses.replace(jget("rwkv6-1.6b", "full"), d_model=256,
                               n_heads=4, head_dim=64, d_ff=512,
                               vocab_size=512, dtype=jnp.float32)
    jflat = paths_from_tree(jbuild(jcfg).init(
        jax_pkg.jax.random.PRNGKey(3))[0])
    own = dict(model.named_parameters())
    n = cfg.n_layers

    def stacked(rest):
        return torch.stack([own[f"layers.{i}.{rest}"] for i in range(n)])
    for rest in ("time.u", "time.w_r", "time.w_o", "time.w_lora_a",
                 "time.w_lora_b", "time.w_ck", "time.w_cv", "time.w_cr"):
        for got in (stacked(rest).std().item(),
                    float(np.std(np.asarray(jflat[f"layers.{rest}"])))):
            assert abs(got * np.sqrt(n) - 1) < 0.15, (rest, got)
    for rest, value in (("time.w_base", 0.0), ("time.mu_r", 1.0),
                        ("time.mu_ck", 1.0), ("time.ln_x", 1.0),
                        ("ln1", 1.0), ("ln2", 1.0)):
        assert torch.equal(stacked(rest),
                           torch.full_like(stacked(rest), value)), rest
        assert np.all(np.asarray(jflat[f"layers.{rest}"]) == value), rest
    for path, std in (("embed", 0.02), ("head", 0.02)):
        port = own["embedding" if path == "embed" else path]
        assert abs(port.std().item() / std - 1) < 0.15, path
    again = build_model(cfg, "cpu", seed=3)
    assert all(torch.equal(p, q) for p, q in zip(model.parameters(),
                                                 again.parameters()))
    assert sorted(own) == sorted(
        f"layers.{i}.{k.partition('.')[2]}" if k.startswith("layers.")
        else ("embedding" if k == "embed" else k)
        for k in jflat for i in (range(n) if k.startswith("layers.") else [0]))


def test_rwkv6_cache_layout_matches_reference(jax_pkg):
    jnp = jax_pkg.jnp
    from repro.configs import get_config as jget
    from repro.models.model import build_model as jbuild
    cache, _ = jbuild(jget("rwkv6-1.6b", "smoke")).init_cache(3, 10)
    model = build_model(get_config("rwkv6-1.6b", "smoke"), "cpu")
    ours = model.init_cache(3, 10)
    assert sorted(ours) == ["layers"]
    for key, arr in cache["layers"].items():
        t = ours["layers"][key]
        assert tuple(t.shape) == arr.shape, key
        assert str(t.dtype)[6:] == str(arr.dtype), key
        assert not t.any()
    assert str(cache["layers"]["wkv"].dtype) == "float32"
    assert cache["layers"]["shift_t"].dtype == jnp.bfloat16


def test_rwkv6_serve_runs_end_to_end_on_the_cpu(capsys):
    res = tserve.main(["--arch", "rwkv6-1.6b", "--variant", "smoke",
                       "--device", "cpu", "--batch", "2", "--prompt-len", "9",
                       "--tokens", "4"])
    out = capsys.readouterr().out
    assert "arch=rwkv6-1.6b-smoke batch=2: prefill" in out
    assert "tok/s" in out and "device: cpu" in out
    assert res.tokens.shape == (2, 4) and len(res.decode_ms) == 3
    assert ((res.tokens >= 0) & (res.tokens < 256)).all()
    assert res.cache["layers"]["wkv"].abs().sum() > 0


# ------------------------------ the card ------------------------------ #
def _card_inputs(case, dtype, device):
    """A case is (B, L, H, K, V, chunk, init) and optionally the decays'
    pattern (``_w_pattern``) as its 8th element."""
    B, L, H, K, V, chunk, init = case[:7]
    inp = _wkv_np(B, L, H, K, V, seed=B + L + H + K + V + chunk, init=init)
    inp["w"] = _w_pattern(inp["w"], case[7] if len(case) > 7 else None, chunk)
    args = _torch_args(inp, "bfloat16" if dtype == torch.bfloat16
                       else "float32", device)
    s0 = torch.from_numpy(inp["s0"]).to(device) if init else None
    return args, s0


def _card_tol(y_ref, dtype, chunk):
    """1e-4 of the scale plus the decays' sensitivity (|wcum| <= 4 chunk),
    or bf16's rounding with margin."""
    base = 2 ** -6 if dtype == torch.bfloat16 else 1e-4
    return (base + 2 ** -20 * 4 * chunk) * y_ref.float().abs().max()


CARD_CASES = [
    # (B, L, H, K, V, chunk, init)
    (2, 64, 4, 16, 16, 8, False),        # the smoke config
    (1, 37, 3, 64, 64, 16, True),        # ragged L, initial state
    (8, 1, 32, 64, 64, 1, True),         # decode at the serve shape
    (2, 300, 4, 64, 32, 16, True),       # K != V
    (1, 5, 2, 8, 8, 16, True),           # one chunk, shorter than the chunk
    (2, 2000, 32, 64, 64, 16, True),     # the ragged case of chip_smoke.py
    (2, 200, 4, 64, 64, 16, True, "clamp"),      # w = -4: |total| = 64, split
    (2, 200, 4, 64, 64, 20, True, "straddle"),   # direct and split in turn
    (1, 300, 32, 64, 64, 16, False),     # B = 1 at the serve width
    (3, 300, 32, 64, 64, 16, True),      # B = 3 at the serve width
    (2, 100, 3, 64, 36, 16, True),       # V not a multiple of y's 32-column
                                         # warps (nor, in bf16, of 8)
    (1, 70, 2, 24, 42, 8, True),         # K != V, V not a multiple of 4
    (1, 50, 2, 5, 7, 3, True),           # K not a multiple of 4: the
                                         # stage's zeroed columns past K
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", CARD_CASES)
def test_rwkv6_kernel_matches_plain_on_card(cuda, case, dtype):
    from repro_torch.kernels import rwkv6
    chunk = case[5]
    args, s0 = _card_inputs(case, dtype, cuda)
    before = rwkv6.launches
    y, s = ops.rwkv6_scan(*args, chunk=chunk, initial_state=s0,
                          return_state=True)
    torch.cuda.synchronize()
    assert rwkv6.launches == before + 1 and y.dtype == dtype
    yr, sr = ref.rwkv6_chunked_ref(*args, chunk=chunk, initial_state=s0,
                                   return_state=True)
    assert (y.float() - yr.float()).abs().max() <= _card_tol(yr, dtype, chunk)
    assert (s - sr).abs().max() <= _card_tol(sr, torch.float32, chunk)
    assert torch.equal(ops.rwkv6_scan(*args, chunk=chunk, initial_state=s0),
                       y)


@pytest.mark.cuda
@pytest.mark.parametrize("chunk", [32, 64])
def test_rwkv6_kernel_takes_chunks_the_split_decay_cannot(cuda, chunk):
    """At |w| up to 4 a chunk of 32 or more overflows the twin's split
    decay (exp(-wcum) reaches e^128); the kernel's direct decay does not,
    and agrees with the token-by-token oracle."""
    case = (1, 100, 2, 64, 64, chunk, True)
    args, s0 = _card_inputs(case, torch.float32, cuda)
    y, s = ops.rwkv6_scan(*args, chunk=chunk, initial_state=s0,
                          return_state=True)
    ys, ss = ref.rwkv6_sequential_ref(*args, initial_state=s0)
    assert torch.isfinite(y).all() and torch.isfinite(s).all()
    assert (y - ys).abs().max() <= _card_tol(ys, torch.float32, chunk)
    assert (s - ss).abs().max() <= _card_tol(ss, torch.float32, chunk)


@pytest.mark.cuda
def test_rwkv6_kernel_refuses_what_it_does_not_take_on_card(cuda):
    from repro_torch.kernels.rwkv6 import rwkv6_cuda
    z = torch.zeros((1, 4, 2, 65), device=cuda)
    with pytest.raises(ValueError, match="K, V <= 64"):
        rwkv6_cuda(z, z, z, z, torch.zeros((2, 65), device=cuda))
    z = torch.zeros((1, 4, 2, 16), device=cuda)
    u = torch.zeros((2, 16), device=cuda)
    with pytest.raises(ValueError, match="chunk"):
        rwkv6_cuda(z, z, z, z, u, chunk=65)
    with pytest.raises(TypeError, match="float32 w"):
        rwkv6_cuda(z, z, z, z.double(), u)
    with pytest.raises(TypeError, match="one dtype"):
        rwkv6_cuda(z.bfloat16(), z, z, z, u)
    with pytest.raises(ValueError, match="grad"):
        rwkv6_cuda(z.clone().requires_grad_(), z, z, z, u)
    with pytest.raises(ValueError, match="shapes"):
        rwkv6_cuda(z, z, z, z, u, initial_state=torch.zeros(
            (1, 2, 16, 8), device=cuda))
