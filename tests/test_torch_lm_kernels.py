"""The LM stack's kernels and layers in the port against the JAX package.

On the CPU: the plain-torch twins in ``repro_torch.kernels.ref`` (attention,
the blocked attention, the chunked and sequential SSD, the one-token SSD
step) and ``ops.decode_attention`` against ``repro.kernels.ref`` /
``repro.kernels.ops`` in float32; the port's dispatch (``ops.flash_attention``
and ``ops.ssd_scan``, whose CPU route is the plain version) against the
Pallas kernels in interpret mode at ``tests/test_kernels.py``'s shapes; and
the layer twins (``rms_norm``, ``apply_rope``, ``_causal_conv``, one Mamba2
and one GQA block) on the same weights.  On the card (``cuda`` marker): the
hand-written CUDA kernels against their plain versions.

Tolerances, float32: the twins repeat the reference's operations, with
sums taken in another order (the SSD's four-operand einsums are contracted
pairwise), so 2e-5 (attention, norms, rope) and 1e-4 (SSD, whose terms
pass through exp and sums over 16-256 steps); against the Pallas kernels
``tests/test_kernels.py``'s own tolerances (attention 2e-5 / bf16 2e-2,
SSD 1e-4 / bf16 5e-2).  On the card, float32: the kernel keeps float32
probabilities and differs from the plain version only in the order of
sums, 1e-4 of max |v|.  bf16: the kernel runs its products on the tensor
cores and rounds p to bf16 as the operand of P V, as the plain version
does (the reference oracle's ``probs.astype(v.dtype)``); what is left is
the order of sums, exp2 with the scale folded in, and the output's rounding
to bf16, bounded at 2^-6 of max |v|.  ``_tensor_core_order`` repeats the
kernel's arithmetic on the CPU (64-key tiles over the kernel's tile range,
scores in float32 from bf16 operands, float32 running max, rescale and l,
p rounded to bf16 only as the operand of P V, a float32 accumulator) and
is held to the JAX reference in float32 and to the port's plain version
within the same 2^-6 of max |v|.  Element by element, against attention
in float32 on the same bf16-valued inputs, both the emulation and the card
kernel stay within BF16_GAP_C = 3 units of 2^-8 |want| + 2^-9 max |want|
over the element's row: p's rounding moves an element by about 2^-8 of its
row's output scale, the output's rounding by 2^-8 of itself.  At 2048
keys the sound order reads 1.35 units; the same order with its
accumulator or its scores kept in bf16 reads 6.05 or 4.86, and one with a
late rescale dropped hundreds, so the bound tells them apart
(``test_bf16_gap_tells_the_kernel_order_from_faulty_ones``).  The SSD
kernels accumulate in float32 in another order than the plain version's
batched products: 1e-4 of the output's scale in float32, and in bf16 the
output's rounding (2^-8 of the scale, with margin 2^-6); the final state,
float32 in both, to 1e-4 of its scale.  The bf16 SSD kernel runs its
products on the tensor cores; each float32 operand (the weights
G = (C.B^T) decay dt, the entering state, each update term w x) goes in
as two bf16 halves, hi + lo, so ~2^-17 of it is lost, and y is rounded to
bf16.  ``_ssd_tensor_core_order`` repeats that arithmetic on the CPU, and
it and the card kernel are held, element by element, to the float32 plain
route on the same bf16-valued inputs within SSD_GAP_C = 2 units of
2^-8 |want| + 2^-9 max |want| over a head's P outputs + 2^-20 mag
(``_ssd_gap``), mag the plain SSD of |x|, |B|, |C|: y's rounding is at
most 1 unit, and the two-half operands (~2^-17 of each term) and float32's
rounding of C.B^T and the sums (~2^-24) err in proportion to mag, which
matters where a sum's terms cancel, as they do on real activations.  The
sound order reads 0.44-0.66 units over the CPU cases; the same order with O kept in bf16 reads 8.12 where many keys
reach each output (slow decays), and without the state update's lo half
its state misses 1e-4 twentyfold
(``test_ssd_gates_tell_the_kernel_order_from_faulty_ones``).  The split-KV
decode kernel keeps float32 products, p and sums, so it differs from
``ops.decode_attention`` only in the order of its sums: ``_split_kv_order``
repeats its chunks and their log-sum-exp merge on the CPU within the
decode test's 2e-5 of the JAX reference, a tolerance that a chunk dropped,
a max not rescaled or keys past n_valid fail.  On the card the kernel is
held to the plain attention in float64 by chip_smoke.py's ``decode_gap``:
element by element, beyond a bf16 output's own rounding, within
``DECODE_GAP_C`` units of 2^-24 of the size of the terms P V sums plus
what float32's rounding of the scores moves the output by, a gate that
the same order with p or the scores rounded to bf16 fails at
minitron-4b's shape (``test_decode_gap_tells_the_kernel_order_from_*``).
"""
import functools
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.kernels import ops, ref
from repro_torch.models import attention as tattn
from repro_torch.models import ssm as tssm
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import apply_rope, rms_norm, rope_freqs
from repro_torch.models.params import InitCtx


@pytest.fixture(scope="module")
def jax_pkg():
    """The JAX package's oracles and Pallas kernels; imported here, so that
    the card tests also run on a machine that has the port but no jax:
    ``python -m pytest -q -m cuda tests/test_torch_lm_kernels.py``."""
    from types import SimpleNamespace

    pytest.importorskip("jax")

    from repro.kernels import ops as jops
    from repro.kernels import ref as jref
    from repro.kernels.flash_attention import flash_attention_pallas
    from repro.kernels.ssm_scan import ssd_pallas
    import jax.numpy as jnp
    return SimpleNamespace(ref=jref, ops=jops, fa=flash_attention_pallas,
                           ssd=ssd_pallas, jnp=jnp)


@pytest.fixture
def cuda():
    """The card; skips where there is none (decided at run time)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _np(x):
    return np.asarray(x, np.float32) if not isinstance(x, torch.Tensor) \
        else x.float().numpy()


def _both(a, dtype="float32"):
    """The same values as a jax array and a torch tensor (bf16 rounds the
    float32 values the same way in both)."""
    import jax.numpy as jnp
    a = np.asarray(a, np.float32)
    if dtype == "bfloat16":
        return jnp.asarray(a, jnp.bfloat16), torch.from_numpy(a).bfloat16()
    return jnp.asarray(a), torch.from_numpy(a)


def _close(got, want, tol):
    np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=tol)


# ----------------------------- attention ----------------------------- #
ATTN_REF_CASES = [
    # (B, Sq, Sk, Hq, Hkv, D, causal, window, q_offset)
    (1, 16, 16, 4, 2, 8, True, 0, 0),
    (2, 12, 20, 6, 2, 16, True, 0, 8),       # GQA, q_offset = Sk - Sq
    (1, 24, 24, 2, 2, 8, True, 5, 0),        # sliding window
    (1, 10, 30, 4, 1, 8, False, 0, 0),       # non-causal
    (1, 9, 13, 2, 1, 16, True, 4, 30),       # rows that see no key
    (1, 7, 11, 3, 3, 112, True, 3, 4),       # zamba2's head_dim, ragged
]


@pytest.mark.parametrize("case", ATTN_REF_CASES)
def test_attention_ref_twin_matches_reference(jax_pkg, case):
    B, Sq, Sk, Hq, Hkv, D, causal, window, qo = case
    rng = np.random.default_rng(sum(case[:6]))
    jq, tq = _both(rng.normal(size=(B, Sq, Hq, D)))
    jk, tk = _both(rng.normal(size=(B, Sk, Hkv, D)))
    jv, tv = _both(rng.normal(size=(B, Sk, Hkv, D)))
    want = jax_pkg.ref.attention_ref(jq, jk, jv, causal=causal,
                                     window=window, q_offset=qo)
    got = ref.attention_ref(tq, tk, tv, causal=causal, window=window,
                            q_offset=qo)
    assert got.shape == (B, Sq, Hq, D) and got.dtype == torch.float32
    _close(got, want, 2e-5)


@pytest.mark.parametrize("case", [
    (1, 32, 64, 4, 2, 8, True, 0, 32, 16, 16),
    (2, 64, 64, 2, 2, 16, True, 12, 0, 32, 16),
    (1, 32, 32, 4, 4, 8, False, 0, 0, 8, 32),
])
def test_attention_blocked_twin_matches_reference(jax_pkg, case):
    B, Sq, Sk, Hq, Hkv, D, causal, window, qo, bq, bk = case
    rng = np.random.default_rng(Sq + Sk + D)
    jq, tq = _both(rng.normal(size=(B, Sq, Hq, D)))
    jk, tk = _both(rng.normal(size=(B, Sk, Hkv, D)))
    jv, tv = _both(rng.normal(size=(B, Sk, Hkv, D)))
    kw = dict(causal=causal, window=window, q_offset=qo, bq=bq, bk=bk)
    want = jax_pkg.ref.attention_blocked(jq, jk, jv, **kw)
    got = ref.attention_blocked(tq, tk, tv, **kw)
    _close(got, want, 2e-5)
    with pytest.raises(ValueError, match="Sq % bq"):
        ref.attention_blocked(tq[:, :-1], tk, tv, **kw)


def test_plain_attention_switches_to_blocked_above_2048_keys(jax_pkg,
                                                             monkeypatch):
    """The CPU route keeps the reference's switch: above 2048 keys the
    blocked loop, which must then agree with the reference's route."""
    rng = np.random.default_rng(5)
    Sq, Sk = 128, 3072
    jq, tq = _both(rng.normal(size=(1, Sq, 2, 16)))
    jk, tk = _both(rng.normal(size=(1, Sk, 1, 16)))
    jv, tv = _both(rng.normal(size=(1, Sk, 1, 16)))
    calls = []
    monkeypatch.setattr(ref, "attention_blocked", functools.partial(
        lambda f, *a, **k: calls.append(1) or f(*a, **k),
        ref.attention_blocked))
    got = ops.flash_attention(tq, tk, tv, q_offset=Sk - Sq)
    want = jax_pkg.ops.flash_attention(jq, jk, jv, q_offset=Sk - Sq)
    assert calls == [1]
    assert ops.BLOCKED_ATTENTION_THRESHOLD == jax_pkg.ops.BLOCKED_ATTENTION_THRESHOLD
    _close(got, want, 2e-5)


ATTN_PALLAS_CASES = [   # tests/test_kernels.py's shapes
    (1, 128, 128, 4, 2, 64, True, 0, "float32"),
    (2, 256, 256, 4, 4, 128, True, 0, "float32"),
    (1, 128, 128, 8, 2, 64, True, 64, "float32"),
    (1, 128, 256, 4, 2, 64, False, 0, "float32"),
    (1, 256, 256, 2, 1, 128, True, 128, "float32"),
    (2, 128, 128, 4, 2, 64, True, 0, "bfloat16"),
]


@pytest.mark.parametrize("case", ATTN_PALLAS_CASES)
def test_flash_attention_dispatch_matches_pallas_interpret(jax_pkg, case):
    B, Sq, Sk, Hq, Hkv, D, causal, window, dtype = case
    rng = np.random.default_rng(Sq * Hq + D)
    jq, tq = _both(rng.normal(size=(B, Sq, Hq, D)), dtype)
    jk, tk = _both(rng.normal(size=(B, Sk, Hkv, D)), dtype)
    jv, tv = _both(rng.normal(size=(B, Sk, Hkv, D)), dtype)
    want = jax_pkg.fa(jq, jk, jv, causal=causal, window=window,
                      q_offset=Sk - Sq, interpret=True)
    got = ops.flash_attention(tq, tk, tv, causal=causal, window=window,
                              q_offset=Sk - Sq)
    assert got.dtype == tq.dtype
    _close(got, want, 2e-2 if dtype == "bfloat16" else 2e-5)


@pytest.mark.parametrize("L_valid", [1, 5, 12])
def test_decode_attention_matches_reference(jax_pkg, L_valid):
    jnp = jax_pkg.jnp
    rng = np.random.default_rng(L_valid)
    B, L, Hq, Hkv, D = 2, 12, 4, 2, 8
    jq, tq = _both(rng.normal(size=(B, 1, Hq, D)))
    jk, tk = _both(rng.normal(size=(B, L, Hkv, D)))
    jv, tv = _both(rng.normal(size=(B, L, Hkv, D)))
    valid = np.arange(L)[None, :] < L_valid
    want = jax_pkg.ops.decode_attention(jq, jk, jv, jnp.asarray(valid))
    got = ops.decode_attention(tq, tk, tv, torch.from_numpy(valid))
    _close(got, want, 2e-5)


def _tensor_core_order(q, k, v, *, causal, window, q_offset, bk=64,
                       fault=None):
    """The bf16 tensor-core kernel's arithmetic in plain torch: per 64-query
    tile, the kernel's range of 64-key tiles; S in float32 from the bf16
    operands, in log2 units (scale * log2(e) folded in, the masked value
    -1e30 as it is, a key past Sk at -inf); float32 running max, rescale and
    l from the float32 p; p rounded to bf16 only as the operand of P V;
    float32 O, divided by max(l, 1e-30) and rounded to bf16.  ``fault``
    makes it a kernel the bounds must reject: "o" keeps the accumulator in
    bf16, "s" the scores, "rescale" skips the accumulator's rescale on each
    query tile's last key tile."""
    B, Sq, Hq, D = q.shape
    _, Sk, Hkv, _ = k.shape
    g = Hq // Hkv
    bq, neg = 64, -1e30
    scale_log2 = np.float32(1.0 / np.sqrt(D) * np.log2(np.e))
    n_tiles = -(-Sk // bk)
    pad = n_tiles * bk - Sk

    def heads(x):   # (B, S, H, D) -> (B, Hq, S + pad, D) float32, zero rows
        x = x.float().repeat_interleave(Hq // x.shape[2], dim=2)
        return torch.nn.functional.pad(x.transpose(1, 2), (0, 0, 0, pad))
    qh = q.float().transpose(1, 2)
    kh, vh = heads(k), heads(v)
    out = torch.empty((B, Hq, Sq, D))
    kpos_all = torch.arange(n_tiles * bk)
    for q0 in range(0, Sq, bq):
        rows = min(bq, Sq - q0)
        qpos = torch.arange(rows) + q_offset + q0
        lo, hi = int(qpos[0]), int(qpos[-1])
        t_begin, t_end = 0, n_tiles
        if not ((causal and lo < 0) or (window > 0 and hi - window + 1 > Sk - 1)):
            if causal:
                t_end = min(t_end, hi // bk + 1)
            if window > 0 and lo - window + 1 > 0:
                t_begin = (lo - window + 1) // bk
        m = torch.full((B, Hq, rows), neg)
        l = torch.zeros((B, Hq, rows))
        acc = torch.zeros((B, Hq, rows, D))
        for t in range(t_begin, t_end):
            ks = slice(t * bk, (t + 1) * bk)
            s = qh[:, :, q0:q0 + rows] @ kh[:, :, ks].transpose(-1, -2)
            if fault == "s":
                s = s.bfloat16().float()
            s = s * scale_log2
            kpos = kpos_all[ks]
            seen = torch.ones((rows, bk), dtype=torch.bool)
            if causal:
                seen &= kpos[None, :] <= qpos[:, None]
            if window > 0:
                seen &= kpos[None, :] > qpos[:, None] - window
            s = torch.where(seen, s, torch.tensor(neg))
            s = torch.where(kpos < Sk, s, torch.tensor(-float("inf")))
            m_new = torch.maximum(m, s.amax(-1))
            p = torch.exp2(s - m_new[..., None])
            alpha = torch.exp2(m - m_new)
            l = alpha * l + p.sum(-1)
            if fault == "rescale" and t == t_end - 1:
                alpha = torch.ones_like(alpha)
            acc = alpha[..., None] * acc + p.bfloat16().float() @ vh[:, :, ks]
            if fault == "o":
                acc = acc.bfloat16().float()
            m = m_new
        out[:, :, q0:q0 + rows] = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.transpose(1, 2).bfloat16()


TC_CPU_CASES = ATTN_REF_CASES + [   # the card cases, cut to the CPU's size
    # (B, Sq, Sk, Hq, Hkv, D, causal, window, q_offset)
    (1, 70, 90, 4, 2, 24, True, 0, 20),      # D not a multiple of 16
    (2, 65, 130, 6, 3, 40, True, 32, 65),    # D = 40, window across tiles
    (1, 5, 5, 2, 1, 64, True, 0, 0),         # Sk < one tile
    (1, 33, 5, 2, 2, 64, False, 0, 0),
    (2, 1, 200, 8, 2, 128, True, 0, 199),    # Sq = 1, the dense families' D
    (1, 100, 100, 6, 2, 112, True, 0, 0),    # three q heads per kv head
    (1, 70, 80, 2, 1, 32, True, 0, -20),     # rows before every key
    (1, 130, 300, 4, 4, 256, True, 0, 170),  # D = 256
    (1, 150, 150, 2, 1, 64, True, 40, 0),
    (1, 256, 256, 2, 2, 112, True, 0, 0),    # zamba2's prefill, cut
]


def _tc_inputs(case):
    """q, k, v in bf16 from a numpy seed."""
    B, Sq, Sk, Hq, Hkv, D = case[:6]
    rng = np.random.default_rng(sum(case[:6]) + 16)
    return [torch.from_numpy(rng.normal(size=s).astype(np.float32)).bfloat16()
            for s in ((B, Sq, Hq, D), (B, Sk, Hkv, D), (B, Sk, Hkv, D))]


BF16_GAP_C = 3.0   # units of _bf16_gap; the module docstring says why


def _bf16_gap(got, want):
    """max |got - want| / (2^-8 |want| + 2^-9 max |want| of its row)."""
    want = want.float()
    unit = 2 ** -8 * want.abs() + 2 ** -9 * want.abs().amax(-1, keepdim=True)
    return ((got.float() - want).abs() / unit).max().item()


@pytest.mark.parametrize("case", TC_CPU_CASES)
def test_tensor_core_order_matches_reference(jax_pkg, case):
    """The bf16 kernel's rounding points stay within 2^-6 of max |v| of the
    JAX reference in float32 on the same (bf16-valued) inputs, and within
    BF16_GAP_C units of it element by element."""
    causal, window, qo = case[6:]
    tq, tk, tv = _tc_inputs(case)
    jq, jk, jv = (jax_pkg.jnp.asarray(_np(t)) for t in (tq, tk, tv))
    want = jax_pkg.ref.attention_ref(jq, jk, jv, causal=causal,
                                     window=window, q_offset=qo)
    got = _tensor_core_order(tq, tk, tv, causal=causal, window=window,
                             q_offset=qo)
    assert got.shape == tq.shape and got.dtype == torch.bfloat16
    tol = 2 ** -6 * tv.float().abs().max().item()
    assert np.abs(_np(got) - np.asarray(want)).max() <= tol
    assert _bf16_gap(got, torch.from_numpy(np.asarray(want))) <= BF16_GAP_C


@pytest.mark.parametrize("case", TC_CPU_CASES)
def test_tensor_core_order_matches_plain_attention(case):
    """... and of the port's plain version on the same bf16 inputs, the
    bound the card holds the kernel to."""
    causal, window, qo = case[6:]
    tq, tk, tv = _tc_inputs(case)
    kw = dict(causal=causal, window=window, q_offset=qo)
    got = _tensor_core_order(tq, tk, tv, **kw)
    want = ops.plain_attention(tq, tk, tv, **kw)
    tol = 2 ** -6 * tv.float().abs().max()
    assert (got.float() - want.float()).abs().max() <= tol


@pytest.mark.parametrize("fault", [None, "o", "s", "rescale"])
def test_bf16_gap_tells_the_kernel_order_from_faulty_ones(fault):
    """At zamba2's head width and 2048 keys (the rows where a bf16
    accumulator's rounding piles up), the kernel's order stays within
    BF16_GAP_C of attention in float32, and the same order with its
    accumulator or scores kept in bf16, or a rescale dropped, does not."""
    case = (1, 2048, 2048, 4, 2, 112)
    tq, tk, tv = _tc_inputs(case)
    kw = dict(causal=True, window=0, q_offset=0)
    got = _tensor_core_order(tq, tk, tv, fault=fault, **kw)
    gap = _bf16_gap(got, ops.plain_attention(tq.float(), tk.float(),
                                             tv.float(), **kw))
    assert (gap <= BF16_GAP_C) == (fault is None), gap


# ------------------------- split-KV decode --------------------------- #
def _split_kv_order(q, k, v, n_valid, *, chunk, fault=None, rounded=None):
    """The split-KV decode kernel's arithmetic in plain torch, float32: per
    chunk of ``chunk`` keys of the valid prefix, s = q k / sqrt(D), the
    chunk's max m, p = exp(s - m), l = sum p and o = p v; then the chunks
    merged by log-sum-exp, o = sum_c w_c o_c / sum_c w_c l_c with
    w_c = exp(m_c - max m).  ``fault`` makes it a kernel the tolerance must
    reject: "drop" leaves the last chunk out, "rescale" merges without
    w_c, "past" reads every slot of the cache.  ``rounded`` makes it one
    that keeps less than float32: "p" rounds p to bf16 where it meets v,
    "s" rounds the scores to bf16."""
    B, _, Hq, D = q.shape
    L, Hkv = k.shape[1], k.shape[2]
    n = L if fault == "past" else n_valid
    qh = q.float().reshape(B, Hkv, Hq // Hkv, D)
    kh, vh = k.float().transpose(1, 2), v.float().transpose(1, 2)
    sqrt_d = torch.sqrt(torch.tensor(D, dtype=torch.float32))
    ms, ls, os_ = [], [], []
    for c0 in range(0, n, chunk):
        keys = slice(c0, min(c0 + chunk, n))
        s = qh @ kh[:, :, keys].transpose(-1, -2) / sqrt_d   # (B, Hkv, g, n_c)
        if rounded == "s":
            s = s.bfloat16().float()
        m = s.amax(-1)
        p = torch.exp(s - m[..., None])
        ms.append(m)
        ls.append(p.sum(-1))
        os_.append((p.bfloat16().float() if rounded == "p" else p)
                   @ vh[:, :, keys])
    if fault == "drop":
        del ms[-1], ls[-1], os_[-1]
    m = torch.stack(ms)
    w = torch.ones_like(m) if fault == "rescale" else torch.exp(m - m.amax(0))
    o = (w[..., None] * torch.stack(os_)).sum(0) / (w * torch.stack(ls)).sum(0)[..., None]
    return o.reshape(B, 1, Hq, D).to(q.dtype)


SPLIT_CHUNK = 64                      # the kernel's narrowest chunk
SPLIT_L = 3 * SPLIT_CHUNK + 20        # reserved slots: three chunks and a ragged one
SPLIT_N_VALID = {"one key": 1, "a chunk less one": SPLIT_CHUNK - 1,
                 "a chunk": SPLIT_CHUNK, "a chunk and one": SPLIT_CHUNK + 1,
                 "every slot": SPLIT_L}


def _split_inputs(B, L, Hq, Hkv, D, seed):
    """q and the caches, bf16 values held in float32 (the card's inputs:
    their products are exact in float32)."""
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.normal(size=s).astype(np.float32)
                             ).bfloat16().float()
            for s in ((B, 1, Hq, D), (B, L, Hkv, D), (B, L, Hkv, D))]


@pytest.mark.parametrize("D", [64, 112, 128])
@pytest.mark.parametrize("g", [1, 3, 6])
@pytest.mark.parametrize("n_valid", list(SPLIT_N_VALID))
def test_split_kv_order_matches_reference(jax_pkg, n_valid, g, D):
    """The split-KV order, chunks merged by log-sum-exp, against the JAX
    reference's ``decode_attention`` over the prefix [0, n_valid), within
    ``test_decode_attention_matches_reference``'s 2e-5."""
    n = SPLIT_N_VALID[n_valid]
    tq, tk, tv = _split_inputs(2, SPLIT_L, 2 * g, 2, D, n + 7 * g + D)
    jq, jk, jv = (jax_pkg.jnp.asarray(_np(t)) for t in (tq, tk, tv))
    valid = np.arange(SPLIT_L)[None, :] < n
    want = jax_pkg.ops.decode_attention(jq, jk, jv, jax_pkg.jnp.asarray(valid))
    got = _split_kv_order(tq, tk, tv, n, chunk=SPLIT_CHUNK)
    _close(got, want, 2e-5)


@pytest.mark.parametrize("fault", [None, "drop", "rescale", "past"])
def test_split_kv_tolerance_tells_the_order_from_faulty_merges(fault):
    """Over two whole chunks and a ragged one, of a cache with slots past
    n_valid, the same 2e-5 against the plain version passes the kernel's
    order and fails a chunk dropped, the running max not rescaled, and
    keys past n_valid read."""
    n, g, D = 2 * SPLIT_CHUNK + 17, 3, 128
    tq, tk, tv = _split_inputs(2, SPLIT_L, 2 * g, 2, D, 33)
    want = ops.decode_attention(tq, tk, tv,
                                torch.arange(SPLIT_L)[None, :] < n)
    got = _split_kv_order(tq, tk, tv, n, chunk=SPLIT_CHUNK, fault=fault)
    ok = np.allclose(_np(got), _np(want), atol=2e-5, rtol=2e-5)
    assert ok == (fault is None)


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rounded", [None, "p", "s"])
def test_decode_gap_tells_the_kernel_order_from_bf16_roundings(rounded,
                                                                out_dtype):
    """chip_smoke.py's gate for the split-KV kernel (``decode_gap`` against
    float64, ``DECODE_GAP_C``), which the card tests apply too, at
    minitron-4b's decode shape a request (3,076 slots, 2,150 valid, 24 q
    heads over 8 kv heads of 128, the kernel's 256-key chunks): it passes
    the kernel's order with float32 p and scores, in a float32 output and
    in a bf16 one, and fails the same order with p, or the scores, rounded
    to bf16."""
    cs = _chip_smoke()
    n = 2150
    tq, tk, tv = _split_inputs(2, 3076, 24, 8, 128, 61)
    got = _split_kv_order(tq, tk, tv, n, chunk=256, rounded=rounded)
    ok = _decode_gap_ok(got.to(out_dtype), tq, tk, tv, n)
    assert ok == (rounded is None)


@pytest.mark.parametrize("rounded", [None, "p", "s"])
def test_chip_smoke_decode_order_is_the_emulated_order(rounded):
    """chip_smoke.py's split-KV order, whose bf16 roundings are its card
    controls, reads as this file's emulation under ``decode_gap``: within
    a unit where it passes, and past the gate where it fails."""
    cs = _chip_smoke()
    n = 2 * 256 + 41
    tq, tk, tv = _split_inputs(2, 700, 24, 8, 128, 62)
    want = cs.decode_float64(tq, tk, tv, n)
    ours = cs.decode_gap(_split_kv_order(tq, tk, tv, n, chunk=256,
                                         rounded=rounded), *want)
    theirs = cs.decode_gap(cs._decode_order(tq, tk, tv, n, 256, rounded),
                           *want)
    if rounded is None:
        assert abs(ours - theirs) <= 1.0 and theirs <= cs.DECODE_GAP_C
    else:
        assert min(ours, theirs) > cs.DECODE_GAP_C


@pytest.mark.parametrize("B,L,Hkv,n_sm,chunk", [
    (64, 3076, 8, 132, 256),    # minitron-4b's decode pool: 6,656 blocks
    (8, 4096, 8, 132, 256),     # 1,024 blocks
    (3, 4096, 8, 132, 128),     # 384 blocks at 256 keys: too few
    (1, 2048, 8, 132, 64),      # one request: as many as it gives
    (1, 20, 2, 132, 64),
])
def test_split_chunk_fills_the_card(B, L, Hkv, n_sm, chunk):
    from repro_torch.kernels.decode_attention import split_chunk
    assert split_chunk(B, L, Hkv, n_sm) == chunk


@pytest.mark.parametrize("window", [0, 6])
def test_gqa_decode_takes_the_prefix_dispatch_under_use_kernel(monkeypatch,
                                                                window):
    """A decode step goes through ``ops.decode_attention_prefix`` once,
    with the count of valid slots (the ring's too, once full) and the
    config's ``use_kernel``, and on the CPU both settings give the plain
    route's output bit for bit."""
    calls = []
    monkeypatch.setattr(ops, "decode_attention_prefix", functools.partial(
        lambda f, q, k, v, n, *, use_kernel: calls.append(
            (int(n), use_kernel)) or f(q, k, v, n, use_kernel=use_kernel),
        ops.decode_attention_prefix))
    x = torch.from_numpy(np.random.default_rng(23).normal(
        size=(2, 8, _cfg().d_model)).astype(np.float32))
    outs = {}
    for use_kernel in (False, True):
        cfg = _cfg(sliding_window=window, use_kernel=use_kernel)
        blk = tattn.gqa_init(cfg, InitCtx(torch.float32, torch.device("cpu")))
        _fill(blk, 21)
        cache = tattn.gqa_cache_init(cfg, 2, 12, device="cpu")
        pos = torch.arange(8).repeat(2, 1)
        tattn.gqa_prefill(blk, x, cfg, pos, cache)
        outs[use_kernel] = [
            tattn.gqa_decode(blk, x[:, i:i + 1], cfg,
                             torch.full((2, 1), 8 + i), cache)[0]
            for i in range(3)]
    L = 6 if window else 12
    assert calls == [(min(9 + i, L), use_kernel) for use_kernel in
                     (False, True) for i in range(3)]
    for a, b in zip(outs[False], outs[True]):
        assert torch.equal(a, b)


# ------------------------------ SSD ---------------------------------- #
def _ssd_inputs(B, L, H, P, N, seed, dtype="float32", init=False):
    rng = np.random.default_rng(seed)
    out = {
        "x": _both(rng.normal(size=(B, L, H, P)), dtype),
        "dt": _both(rng.uniform(0.01, 0.2, (B, L, H))),
        "A": _both(-rng.uniform(0.5, 2.0, (H,))),
        "B": _both(rng.normal(size=(B, L, N))),
        "C": _both(rng.normal(size=(B, L, N))),
    }
    if init:
        out["s0"] = _both(rng.normal(size=(B, H, P, N)))
    return out


def _args(inp, side):
    i = 0 if side == "jax" else 1
    return (inp["x"][i], inp["dt"][i], inp["A"][i], inp["B"][i], inp["C"][i])


SSD_REF_CASES = [
    # (B, L, H, P, N, chunk, init)
    (2, 64, 4, 8, 16, 16, False),
    (1, 80, 2, 8, 16, 32, True),             # ragged L, initial state
    (2, 37, 3, 4, 8, 8, True),               # ragged, several chunks
    (1, 20, 2, 16, 8, 64, False),            # one ragged chunk
]


@pytest.mark.parametrize("case", SSD_REF_CASES)
def test_ssd_chunked_twin_matches_reference(jax_pkg, case):
    B, L, H, P, N, chunk, init = case
    inp = _ssd_inputs(B, L, H, P, N, seed=L + H, init=init)
    s0 = inp["s0"] if init else (None, None)
    yj, sj = jax_pkg.ref.ssd_chunked_ref(*_args(inp, "jax"), chunk=chunk,
                                         initial_state=s0[0],
                                         return_state=True)
    yt, st = ref.ssd_chunked_ref(*_args(inp, "torch"), chunk=chunk,
                                 initial_state=s0[1], return_state=True)
    assert yt.shape == (B, L, H, P) and st.shape == (B, H, P, N)
    assert st.dtype == torch.float32
    _close(yt, yj, 1e-4)
    _close(st, sj, 1e-4)
    only_y = ref.ssd_chunked_ref(*_args(inp, "torch"), chunk=chunk,
                                 initial_state=s0[1])
    assert torch.equal(only_y, yt)


@pytest.mark.parametrize("init", [False, True])
def test_ssd_sequential_and_decode_step_match_reference(jax_pkg, init):
    inp = _ssd_inputs(2, 24, 3, 4, 8, seed=7, init=init)
    s0 = inp["s0"] if init else (None, None)
    yj, sj = jax_pkg.ref.ssd_sequential_ref(*_args(inp, "jax"),
                                            initial_state=s0[0])
    yt, st = ref.ssd_sequential_ref(*_args(inp, "torch"), initial_state=s0[1])
    _close(yt, yj, 1e-4)
    _close(st, sj, 1e-4)
    # the chunked twin agrees with the sequential one
    yc, sc = ref.ssd_chunked_ref(*_args(inp, "torch"), chunk=8,
                                 initial_state=s0[1], return_state=True)
    _close(yc, yt, 1e-4)
    _close(sc, st, 1e-4)


SSD_PALLAS_CASES = [    # tests/test_kernels.py's shapes
    (2, 64, 4, 8, 16, 16, "float32"),
    (1, 128, 2, 16, 32, 32, "float32"),
    (1, 96, 3, 8, 8, 32, "float32"),
    (2, 80, 2, 8, 16, 32, "float32"),
    (1, 64, 4, 8, 16, 16, "bfloat16"),
]


@pytest.mark.parametrize("case", SSD_PALLAS_CASES)
def test_ssd_scan_dispatch_matches_pallas_interpret(jax_pkg, case):
    B, L, H, P, N, chunk, dtype = case
    inp = _ssd_inputs(B, L, H, P, N, seed=L * H, dtype=dtype)
    want = jax_pkg.ssd(*_args(inp, "jax"), chunk=chunk, interpret=True)
    got = ops.ssd_scan(*_args(inp, "torch"), chunk=chunk)
    assert got.dtype == inp["x"][1].dtype
    _close(got, want, 5e-2 if dtype == "bfloat16" else 1e-4)


def _ssd_tensor_core_order(x, dt, A, Bm, Cm, *, chunk, initial_state=None,
                           fault=None):
    """The bf16 tensor-core SSD kernel's arithmetic in plain torch, on
    bf16-valued x, B, C.  Per chunk: the float32 cumsum of dt * A; per
    64-row query sub-block the inter term exp(cum[q]) C[q] S^T with the
    entering state as two bf16 halves (hi = bf16(S), lo = bf16(S - hi));
    per 64-key sub-block at or below the diagonal C[q] B[k]^T in float32,
    G = that * exp(cum[q] - cum[k]) dt[k] where k <= q, split the same way,
    and O += G_hi x[k] + G_lo x[k] in float32; y rounded to bf16.  The
    state update S = exp(cum[end]) S + hi^T B + lo^T B, with w x
    (w[k] = exp(cum[end] - cum[k]) dt[k]) split the same way.  ``fault`` makes it a kernel the
    gates must reject: "o" keeps O in bf16 (rounded after the inter term
    and after every 16 keys, an mma's depth), "lo" drops the state update's
    lo half.  Returns (y in bf16, the final state in float32).  (The kernel
    takes some decays as exp(cum[q] - cum[g]) exp(cum[g] - cum[k]); that
    moves G by float32 roundings, far below the bf16 halves here.)"""
    Bsz, L, H, P = x.shape
    dev = x.device
    xh = x.float().permute(0, 2, 1, 3)            # (B, H, L, P)
    dth = dt.float().permute(0, 2, 1)             # (B, H, L)
    Bf, Cf = Bm.float()[:, None], Cm.float()[:, None]   # (B, 1, L, N)
    S = (torch.zeros((Bsz, H, P, Bm.shape[-1]), device=dev)
         if initial_state is None else initial_state.float().clone())
    y = torch.empty((Bsz, H, L, P), device=dev)
    bq, bk = 64, 16 if fault == "o" else 64

    def halves(v):
        hi = v.bfloat16().float()
        return hi, (v - hi).bfloat16().float()
    for t0 in range(0, L, chunk):
        Lc = min(chunk, L - t0)
        d = dth[..., t0:t0 + Lc]
        cum = torch.cumsum(d * A.float()[None, :, None], -1)
        s_hi, s_lo = halves(S)
        for q0 in range(0, Lc, bq):
            rows = slice(q0, min(q0 + bq, Lc))
            Cq = Cf[:, :, t0 + rows.start:t0 + rows.stop]
            acc = (Cq @ s_hi.transpose(-1, -2) + Cq @ s_lo.transpose(-1, -2)) \
                * torch.exp(cum[..., rows])[..., None]
            if fault == "o":
                acc = acc.bfloat16().float()
            qpos = torch.arange(rows.start, rows.stop, device=dev)
            for k0 in range(0, rows.stop, bk):
                ks = slice(k0, min(k0 + bk, Lc))
                s = Cq @ Bf[:, :, t0 + ks.start:t0 + ks.stop].transpose(-1, -2)
                seen = (torch.arange(ks.start, ks.stop, device=dev)[None, :]
                        <= qpos[:, None])
                dec = cum[..., rows, None] - cum[..., None, ks]
                G = torch.where(seen, s * torch.exp(torch.where(seen, dec, 0.0))
                                * d[..., None, ks], 0.0)
                g_hi, g_lo = halves(G)
                acc = acc + (g_hi @ xh[..., t0 + ks.start:t0 + ks.stop, :]
                             + g_lo @ xh[..., t0 + ks.start:t0 + ks.stop, :])
                if fault == "o":
                    acc = acc.bfloat16().float()
            y[..., t0 + rows.start:t0 + rows.stop, :] = acc
        w = torch.exp(cum[..., -1:] - cum) * d
        hi, lo = halves(w[..., None] * xh[..., t0:t0 + Lc, :])
        Bk = Bf[:, :, t0:t0 + Lc]
        upd = hi.transpose(-1, -2) @ Bk
        if fault != "lo":
            upd = upd + lo.transpose(-1, -2) @ Bk
        S = S * torch.exp(cum[..., -1])[..., None, None] + upd
    return y.permute(0, 2, 1, 3).bfloat16(), S


# y's element-wise gate in bf16 (ssd_gap); the module docstring says why 2
SSD_GAP_C = 2.0


def _ssd_magnitude(x, dt, A, Bm, Cm, *, chunk, initial_state=None):
    """The plain SSD of |x|, |B|, |C| and |S_0|: at each output the sum of
    the magnitudes of its terms (|C[q]|.|B[k]| decay dt[k] |x[k]| and the
    inter term's), the scale of float32's rounding of C.B^T and the sums."""
    return ref.ssd_chunked_ref(
        x.float().abs(), dt, A, Bm.float().abs(), Cm.float().abs(),
        chunk=chunk,
        initial_state=None if initial_state is None else initial_state.abs())


def _ssd_gap(got, want, mag):
    """max |got - want| / (2^-8 |want| + 2^-9 max |want| of its P outputs
    + 2^-20 mag), ``mag`` from ``_ssd_magnitude``."""
    want = want.float()
    unit = (2 ** -8 * want.abs() + 2 ** -9 * want.abs().amax(-1, keepdim=True)
            + 2 ** -20 * mag)
    return ((got.float() - want).abs() / unit).max().item()


SSD_TC_CPU_CASES = [s[:6] + (False,) for s in SSD_PALLAS_CASES] + [
    # the card's bf16 cases, cut to the CPU's size: (B, L, H, P, N, chunk, init)
    (1, 200, 2, 8, 8, 16, True),             # P = N = 8
    (1, 130, 2, 24, 24, 48, False),          # P, N not multiples of 16
    (1, 300, 2, 40, 8, 100, True),           # chunk not a multiple of 64
    (1, 700, 1, 24, 8, 1024, False),         # L < chunk
    (1, 1, 2, 64, 64, 256, True),            # L = 1
    (1, 50, 2, 40, 24, 1024, True),
    (1, 90, 2, 12, 20, 32, True),            # rows not 16-byte aligned
    (1, 33, 2, 5, 3, 16, False),             # odd P and N
    (1, 512, 2, 64, 64, 256, False),         # zamba2's head, cut
]


def _ssd_bf16_inputs(case, dt_range=(0.01, 0.2)):
    """x, dt, A, B, C and the initial state (or None), x, B and C in bf16,
    from a numpy seed."""
    B, L, H, P, N, chunk, init = case
    rng = np.random.default_rng(sum(case[:6]) + 17)

    def t(a):
        return torch.from_numpy(np.asarray(a, np.float32))
    x = t(rng.normal(size=(B, L, H, P))).bfloat16()
    dt = t(rng.uniform(*dt_range, (B, L, H)))
    A = t(-rng.uniform(0.5, 2.0, (H,)))
    Bm = t(rng.normal(size=(B, L, N))).bfloat16()
    Cm = t(rng.normal(size=(B, L, N))).bfloat16()
    s0 = t(rng.normal(size=(B, H, P, N))) if init else None
    return x, dt, A, Bm, Cm, s0


@pytest.mark.parametrize("case", SSD_TC_CPU_CASES)
def test_ssd_tensor_core_order_matches_reference(jax_pkg, case):
    """The bf16 SSD kernel's rounding points stay within 2^-6 of y's scale
    of the JAX reference in float32 on the same bf16-valued inputs, within
    SSD_GAP_C units of it element by element, and its final state within
    1e-4 of the state's scale."""
    x, dt, A, Bm, Cm, s0 = _ssd_bf16_inputs(case)
    jnp = jax_pkg.jnp
    want, want_s = jax_pkg.ref.ssd_chunked_ref(
        *(jnp.asarray(_np(t)) for t in (x, dt, A, Bm, Cm)), chunk=case[5],
        initial_state=None if s0 is None else jnp.asarray(_np(s0)),
        return_state=True)
    got, got_s = _ssd_tensor_core_order(x, dt, A, Bm, Cm, chunk=case[5],
                                        initial_state=s0)
    assert got.shape == x.shape and got.dtype == torch.bfloat16
    want, want_s = np.asarray(want), np.asarray(want_s)
    assert np.abs(_np(got) - want).max() <= 2 ** -6 * np.abs(want).max()
    mag = _ssd_magnitude(x, dt, A, Bm, Cm, chunk=case[5], initial_state=s0)
    assert _ssd_gap(got, torch.from_numpy(want.copy()), mag) <= SSD_GAP_C
    assert np.abs(_np(got_s) - want_s).max() <= 1e-4 * np.abs(want_s).max()


@pytest.mark.parametrize("case", SSD_TC_CPU_CASES)
def test_ssd_tensor_core_order_matches_plain_version(case):
    """... and the port's plain version on the same bf16 inputs within the
    bounds the card holds the kernel to."""
    x, dt, A, Bm, Cm, s0 = _ssd_bf16_inputs(case)
    kw = dict(chunk=case[5], initial_state=s0, return_state=True)
    got, got_s = _ssd_tensor_core_order(x, dt, A, Bm, Cm, chunk=case[5],
                                        initial_state=s0)
    want, want_s = ref.ssd_chunked_ref(x, dt, A, Bm, Cm, **kw)
    scale = want.float().abs().max()
    assert (got.float() - want.float()).abs().max() <= 2 ** -6 * scale
    assert (got_s - want_s).abs().max() <= 1e-4 * want_s.abs().max()


# the gates' controls: (B, L, H, P, N, chunk, init) and dt's range
SSD_SLOW_DECAY = ((1, 2048, 2, 64, 64, 1024, True), (1e-4, 1e-3))
SSD_RANDOM_DECAY = ((1, 512, 2, 64, 64, 256, False), (0.01, 0.2))


@pytest.mark.parametrize("fault,inputs", [
    (None, SSD_SLOW_DECAY), (None, SSD_RANDOM_DECAY),
    ("o", SSD_SLOW_DECAY), ("lo", SSD_RANDOM_DECAY)])
def test_ssd_gates_tell_the_kernel_order_from_faulty_ones(fault, inputs):
    """The kernel's order passes y's ssd_gap and the state's 1e-4 gate; the
    same order with O kept in bf16 fails ssd_gap, and without the state
    update's lo half fails the state's gate.  A bf16 O rounds one partial
    sum per 16 keys, which shows where many keys reach each output: with
    dt * A of at most 2e-3 a whole 1024-step chunk contributes (with the
    random cases' dt * A of up to 0.4 a few keys do, and a bf16 O reads
    about as the sound order does).  A dropped lo half shows where the
    chunk's update, not a slowly decaying initial state, makes the state."""
    case, dt_range = inputs
    x, dt, A, Bm, Cm, s0 = _ssd_bf16_inputs(case, dt_range=dt_range)
    got, got_s = _ssd_tensor_core_order(x, dt, A, Bm, Cm, chunk=case[5],
                                        initial_state=s0, fault=fault)
    want, want_s = ref.ssd_chunked_ref(x.float(), dt, A, Bm.float(),
                                       Cm.float(), chunk=case[5],
                                       initial_state=s0, return_state=True)
    gap = _ssd_gap(got, want, _ssd_magnitude(x, dt, A, Bm, Cm, chunk=case[5],
                                             initial_state=s0))
    state_err = ((got_s - want_s).abs().max() / want_s.abs().max()).item()
    assert (gap <= SSD_GAP_C) == (fault != "o"), gap
    assert (state_err <= 1e-4) == (fault != "lo"), state_err


def _chip_smoke():
    import importlib
    import sys
    root = str(Path(__file__).resolve().parents[1])
    if root not in sys.path:
        sys.path.insert(0, root)
    return importlib.import_module("chip_smoke")


@pytest.mark.parametrize("fault", [None, "o"])
def test_chip_smoke_ssd_order_is_the_emulated_order(fault):
    """chip_smoke.py's kernel order (its witness on the serve path's
    activations) and bf16-O order (its on-card control) repeat this file's
    exactly, and its ssd_gap is this file's _ssd_gap."""
    cs = _chip_smoke()
    case, dt_range = SSD_SLOW_DECAY
    case = (1, 300, 2) + case[3:5] + (128, True)
    x, dt, A, Bm, Cm, s0 = _ssd_bf16_inputs(case, dt_range=dt_range)
    kw = dict(chunk=case[5], initial_state=s0)
    got = cs._ssd_order(x, dt, A, Bm, Cm, o_bf16=fault == "o", **kw)
    want, _ = _ssd_tensor_core_order(x, dt, A, Bm, Cm, fault=fault, **kw)
    assert torch.equal(got, want)
    y32 = ref.ssd_chunked_ref(x.float(), dt, A, Bm.float(), Cm.float(), **kw)
    mag = _ssd_magnitude(x, dt, A, Bm, Cm, **kw)
    assert cs.ssd_gap(got, y32, mag) == _ssd_gap(got, y32, mag)


@pytest.mark.parametrize("L,chunk", [(512, 256), (300, 128)])
def test_chip_smoke_ssd_float64_matches_reference(jax_pkg, L, chunk):
    """chip_smoke.py's float64 witness for one (batch, head) agrees with
    the JAX reference in float32 to 1e-5 of y's scale."""
    cs = _chip_smoke()
    x, dt, A, Bm, Cm, _ = _ssd_bf16_inputs((1, L, 2, 16, 8, chunk, False))
    jnp = jax_pkg.jnp
    want = np.asarray(jax_pkg.ref.ssd_chunked_ref(
        *(jnp.asarray(_np(t)) for t in (x, dt, A, Bm, Cm)), chunk=chunk))
    for h in range(2):
        got = cs._ssd_float64(x[0, :, h], dt[0, :, h], A[h].item(), Bm[0],
                              Cm[0], chunk).numpy()
        assert np.abs(got - want[0, :, h]).max() <= \
            1e-5 * np.abs(want[0, :, h]).max()


# ------------------------------ layers -------------------------------- #
def test_rms_norm_and_rope_match_reference(jax_pkg):
    jnp = jax_pkg.jnp
    from repro.models import layers as jl
    rng = np.random.default_rng(3)
    jx, tx = _both(rng.normal(size=(2, 5, 64)) * 3.0)
    jw, tw = _both(rng.normal(size=(64,)))
    _close(rms_norm(tx, tw, 1e-5), jl.rms_norm(jx, jw, 1e-5), 2e-5)
    np.testing.assert_array_equal(rope_freqs(112, 1e4), jl.rope_freqs(112, 1e4))
    # zamba2's head_dim 112: two 56-wide halves, not a power of two
    jq, tq = _both(rng.normal(size=(2, 7, 3, 112)))
    pos = rng.integers(0, 4096, (2, 7))
    got = apply_rope(tq, torch.from_numpy(pos), 1e4)
    want = jl.apply_rope(jq, jnp.asarray(pos), 1e4)
    _close(got, want, 2e-5 * 4096)   # angles up to 4096 rad in float32
    jb, tb = _both(rng.normal(size=(2, 7, 3, 112)), "bfloat16")
    gb = apply_rope(tb, torch.from_numpy(pos[:, :7] % 64), 1e4)
    wb = jl.apply_rope(jb, jnp.asarray(pos[:, :7] % 64), 1e4)
    assert gb.dtype == torch.bfloat16
    _close(gb, wb, 2e-2)


def test_causal_conv_matches_reference(jax_pkg):
    from repro.models import ssm as jssm
    rng = np.random.default_rng(4)
    jx, tx = _both(rng.normal(size=(2, 9, 12)))
    jw, tw = _both(rng.normal(size=(4, 12)))
    jb, tb = _both(rng.normal(size=(12,)))
    _close(tssm._causal_conv(tx, tw, tb), jssm._causal_conv(jx, jw, jb), 2e-5)


def _cfg(dtype=torch.float32, **kw):
    base = dict(name="t", family="hybrid", n_layers=2, d_model=32, n_heads=4,
                n_kv_heads=2, d_ff=64, vocab_size=64, ssm_state=8,
                ssm_head_dim=8, ssm_expand=2, ssm_chunk=8,
                hybrid_attn_every=2, rope_theta=1e4, dtype=dtype,
                use_kernel=False)
    base.update(kw)
    return ModelConfig(**base)


def _jcfg(cfg):
    import jax.numpy as jnp
    from repro.models.config import ModelConfig as JConfig
    kw = {f: getattr(cfg, f) for f in ("name", "family", "n_layers", "d_model",
                                       "n_heads", "n_kv_heads", "d_ff",
                                       "vocab_size", "ssm_state",
                                       "ssm_head_dim", "ssm_expand",
                                       "ssm_chunk", "hybrid_attn_every",
                                       "rope_theta", "sliding_window")}
    return JConfig(**kw, dtype=jnp.float32)


def _fill(module, seed):
    """Random weights for a block, returned as {name: numpy} too."""
    rng = np.random.default_rng(seed)
    vals = {}
    with torch.no_grad():
        for name, p in module.named_parameters():
            a = (rng.normal(size=p.shape) * 0.3).astype(np.float32)
            if name in ("A_log", "dt_bias"):
                a = a * 0.5
            p.copy_(torch.from_numpy(a))
            vals[name] = a
    return vals


def test_mamba2_block_matches_reference(jax_pkg):
    jnp = jax_pkg.jnp
    from repro.models import ssm as jssm
    cfg = _cfg()
    jcfg = _jcfg(cfg)
    blk = tssm.mamba2_init(cfg, InitCtx(torch.float32, torch.device("cpu")))
    p = {k: jnp.asarray(v) for k, v in _fill(blk, 11).items()}
    rng = np.random.default_rng(12)
    jx, tx = _both(rng.normal(size=(2, 13, cfg.d_model)))
    oj, sj, cj = jssm.mamba2_forward(p, jx, jcfg, return_state=True)
    ot, st, ct = tssm.mamba2_forward(blk, tx, cfg, return_state=True)
    _close(ot, oj, 1e-4)
    _close(st, sj, 1e-4)
    _close(ct, cj, 1e-5)
    jx1, tx1 = _both(rng.normal(size=(2, 1, cfg.d_model)))
    oj, sj2, cj2 = jssm.mamba2_decode(p, jx1, jcfg, sj, cj)
    ot, st2, ct2 = tssm.mamba2_decode(blk, tx1, cfg, st, ct)
    _close(ot, oj, 1e-4)
    _close(st2, sj2, 1e-4)
    _close(ct2, cj2, 1e-5)


@pytest.mark.parametrize("window", [0, 6])
def test_gqa_block_matches_reference(jax_pkg, window):
    jnp = jax_pkg.jnp
    from repro.models import attention as ja
    from repro.models.params import InitCtx as JCtx
    cfg = _cfg(sliding_window=window)
    jcfg = _jcfg(cfg)
    blk = tattn.gqa_init(cfg, InitCtx(torch.float32, torch.device("cpu")))
    p = {k: jnp.asarray(v) for k, v in _fill(blk, 21).items()}
    rng = np.random.default_rng(22)
    S = 10
    jx, tx = _both(rng.normal(size=(2, S, cfg.d_model)))
    pos = np.tile(np.arange(S), (2, 1))
    _close(tattn.gqa_forward(blk, tx, cfg, torch.from_numpy(pos)),
           ja.gqa_forward(p, jx, jcfg, jnp.asarray(pos)), 2e-5)
    jcache = ja.gqa_cache_init(jcfg, JCtx(key=None, dtype=jnp.float32,
                                          abstract=False), "c", 2, S + 4)
    tcache = tattn.gqa_cache_init(cfg, 2, S + 4, device="cpu")
    oj, jcache = ja.gqa_prefill(p, jx, jcfg, jnp.asarray(pos), jcache)
    ot, tcache = tattn.gqa_prefill(blk, tx, cfg, torch.from_numpy(pos), tcache)
    _close(ot, oj, 2e-5)
    for key in ("k", "v", "len"):
        _close(tcache[key], jcache[key], 2e-5)
    for step in range(3):
        jx1, tx1 = _both(rng.normal(size=(2, 1, cfg.d_model)))
        p1 = np.full((2, 1), S + step)
        oj, jcache = ja.gqa_decode(p, jx1, jcfg, jnp.asarray(p1), jcache)
        ot, tcache = tattn.gqa_decode(blk, tx1, cfg, torch.from_numpy(p1),
                                      tcache)
        _close(ot, oj, 2e-5)
        for key in ("k", "v", "len"):
            _close(tcache[key], jcache[key], 2e-5)


# ------------------------------ bindings ------------------------------ #
@pytest.mark.parametrize("module,symbol", [
    ("flash_attention", "flash_attention_launch"),
    ("ssm_scan", "ssd_scan_launch"),
    ("rwkv6", "rwkv6_launch"),
    ("decode_attention", "decode_attention_launch")])
def test_ctypes_binding_matches_the_c_signature(module, symbol):
    """Each wrapper's ``argtypes`` follow its kernel's ``extern "C"``
    signature, parameter for parameter (the sources compile only on the
    card's machine, so this is where a wrong binding shows first)."""
    import ctypes
    import importlib
    import re

    from repro_torch.kernels import _build
    mod = importlib.import_module(f"repro_torch.kernels.{module}")
    src = "\n".join((_build.CSRC / f"{name}.cu").read_text()
                    for name in _build.SOURCES)
    sig = re.search(r'extern "C" int ' + symbol + r"\(([^)]*)\)", src)
    assert sig is not None
    params = [p.strip() for p in sig.group(1).split(",")]
    want = {"long long": ctypes.c_longlong, "float": ctypes.c_float,
            "int": ctypes.c_int}

    def kind(param):
        if "*" in param:
            return ctypes.c_void_p
        return want[param.rsplit(" ", 1)[0].replace("const ", "")]
    assert [kind(p) for p in params] == mod.ARGTYPES



def test_bf16_instance_binding_matches_the_c_signature():
    """The KD-forcing entry point's ``argtypes`` follow its ``extern "C"``
    signature, the instance query takes nothing, and ``BF16_INSTANCES``
    are the compiled ones."""
    import ctypes
    import re

    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa
    src = (_build.CSRC / "flash_attention.cu").read_text()
    sig = re.search(r'extern "C" int flash_attention_launch_bf16_instance'
                    r"\(([^)]*)\)", src)
    params = [p.strip() for p in sig.group(1).split(",")]
    want = {"long long": ctypes.c_longlong, "float": ctypes.c_float,
            "int": ctypes.c_int}
    kinds = [ctypes.c_void_p if "*" in p else
             want[p.rsplit(" ", 1)[0].replace("const ", "")] for p in params]
    assert kinds == fa.INSTANCE_ARGTYPES
    assert re.search(r'extern "C" int flash_attention_last_instance\(void\)',
                     src)
    assert fa.BF16_INSTANCES == tuple(int(n) for n in re.findall(
        r"case (\d+): return tc::launch<\1>", src))

# ------------------------------ the card ------------------------------ #
CARD_ATTN_CASES = [
    # (B, Sq, Sk, Hq, Hkv, D, causal, window, q_offset)
    (1, 128, 128, 4, 2, 64, True, 0, 0),
    (2, 100, 300, 24, 8, 128, True, 256, 200),   # GQA, window, ragged
    (1, 77, 77, 2, 1, 112, False, 0, 0),
    (1, 40, 50, 2, 2, 8, True, 16, 10),
    (1, 64, 64, 2, 2, 256, True, 0, 0),
    (1, 10, 10, 2, 2, 16, True, 4, 100),          # rows that see no key
    (2, 300, 300, 4, 4, 112, True, 0, 0),
    (1, 70, 90, 4, 2, 24, True, 0, 20),           # D not a multiple of 16
    (2, 65, 130, 6, 3, 40, True, 32, 65),
    (1, 5, 5, 2, 1, 64, True, 0, 0),              # Sk < one tile
    (1, 33, 5, 2, 2, 64, False, 0, 0),
    (2, 1, 200, 8, 2, 128, True, 0, 199),         # Sq = 1
    (1, 100, 100, 6, 2, 112, True, 0, 0),         # Hq / Hkv = 3
    (1, 70, 80, 2, 1, 32, True, 0, -20),          # rows before every key
    (1, 130, 300, 4, 4, 256, True, 0, 170),       # D = 256: registers
    (2, 2048, 2048, 8, 8, 112, True, 0, 0),       # zamba2's prefill rows
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", CARD_ATTN_CASES)
def test_flash_attention_kernel_matches_plain_on_card(cuda, case, dtype):
    from repro_torch.kernels import flash_attention as fa
    B, Sq, Sk, Hq, Hkv, D, causal, window, qo = case
    g = torch.Generator(device=cuda).manual_seed(sum(case[:6]))
    q, k, v = (torch.randn(s, generator=g, device=cuda).to(dtype)
               for s in ((B, Sq, Hq, D), (B, Sk, Hkv, D), (B, Sk, Hkv, D)))
    before = fa.launches
    got = ops.flash_attention(q, k, v, causal=causal, window=window,
                              q_offset=qo)
    torch.cuda.synchronize()
    assert fa.launches == before + 1 and got.dtype == dtype
    want = ops.plain_attention(q, k, v, causal=causal, window=window,
                               q_offset=qo)
    tol = (2 ** -6 if dtype == torch.bfloat16 else 1e-4) * v.abs().max()
    assert (got.float() - want.float()).abs().max() <= tol
    if dtype == torch.bfloat16:
        want = ops.plain_attention(q.float(), k.float(), v.float(),
                                   causal=causal, window=window, q_offset=qo)
        assert _bf16_gap(got, want) <= BF16_GAP_C


@pytest.mark.cuda
@pytest.mark.parametrize("case", CARD_ATTN_CASES)
def test_flash_attention_bf16_kernel_matches_f32_kernel_on_card(cuda, case):
    """The tensor-core bf16 kernel against the CUDA-core float32 kernel on
    the same (bf16-valued) inputs: the two kernels' arithmetic, directly,
    within 2^-6 of max |v| and BF16_GAP_C units element by element."""
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    B, Sq, Sk, Hq, Hkv, D, causal, window, qo = case
    g = torch.Generator(device=cuda).manual_seed(sum(case[:6]) + 1)
    q, k, v = (torch.randn(s, generator=g, device=cuda).bfloat16()
               for s in ((B, Sq, Hq, D), (B, Sk, Hkv, D), (B, Sk, Hkv, D)))
    kw = dict(causal=causal, window=window, q_offset=qo)
    got = flash_attention_cuda(q, k, v, **kw)
    want = flash_attention_cuda(q.float(), k.float(), v.float(), **kw)
    torch.cuda.synchronize()
    tol = 2 ** -6 * v.float().abs().max()
    assert (got.float() - want).abs().max() <= tol
    assert _bf16_gap(got, want) <= BF16_GAP_C



# MLA's q-k width 192 (128 + 64 RoPE), served by the KD = 12 instance:
# (B, Sq, Sk, Hq, Hkv, D, causal, window, q_offset)
CARD_MLA_CASES = [
    (2, 300, 300, 8, 8, 192, True, 0, 0),         # the serve path's form
    (2, 100, 300, 12, 4, 192, True, 256, 200),    # GQA, window, ragged
    (1, 77, 130, 4, 4, 192, False, 0, 0),         # not causal, ragged
    (1, 70, 80, 4, 2, 192, True, 0, -20),         # rows before every key
    (2, 1, 200, 8, 8, 192, True, 0, 199),         # Sq = 1
    (1, 2048, 2048, 4, 4, 192, True, 0, 0),       # the serve path's rows
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", CARD_MLA_CASES)
def test_flash_attention_kd12_instance_on_card(cuda, case):
    """D = 192 runs the KD = 12 instance (no zero columns): held to the
    plain version in bf16 (2^-6 of max |v|), to the float32 plain route
    element by element (BF16_GAP_C), and to the padded KD = 16 instance
    on the same inputs, which computes the same sums plus exact zeros (a
    zero column adds 0 to every score and is never stored): equal bit for
    bit."""
    from repro_torch.kernels import flash_attention as fa
    B, Sq, Sk, Hq, Hkv, D, causal, window, qo = case
    g = torch.Generator(device=cuda).manual_seed(sum(case[:6]) + 2)
    q, k, v = (torch.randn(s, generator=g, device=cuda).bfloat16()
               for s in ((B, Sq, Hq, D), (B, Sk, Hkv, D), (B, Sk, Hkv, D)))
    kw = dict(causal=causal, window=window, q_offset=qo)
    got = fa.flash_attention_cuda(q, k, v, **kw)
    torch.cuda.synchronize()
    assert fa.last_instance() == 12
    padded = fa.flash_attention_cuda(q, k, v, instance=16, **kw)
    torch.cuda.synchronize()
    assert fa.last_instance() == 16
    assert torch.equal(got, padded)
    want = ops.plain_attention(q, k, v, **kw)
    assert (got.float() - want.float()).abs().max() <= \
        2 ** -6 * v.float().abs().max()
    want = ops.plain_attention(q.float(), k.float(), v.float(), **kw)
    assert _bf16_gap(got, want) <= BF16_GAP_C


@pytest.mark.cuda
def test_flash_attention_instance_is_refused_where_it_does_not_fit(cuda):
    """Each head width runs the narrowest instance that holds it but for
    112 and 192, which run unpadded; a forced instance must hold D and be
    bfloat16."""
    from repro_torch.kernels import flash_attention as fa
    for D, kd in ((8, 1), (24, 2), (48, 4), (64, 4), (112, 7), (128, 8),
                  (144, 16), (192, 12), (200, 16), (256, 16)):
        q = torch.zeros((1, 8, 2, D), device=cuda, dtype=torch.bfloat16)
        fa.flash_attention_cuda(q, q, q)
        torch.cuda.synchronize()
        assert fa.last_instance() == kd, D
    for bad in (8, 7, 3):
        with pytest.raises(ValueError, match="instance"):
            fa.flash_attention_cuda(q[..., :192].contiguous(),
                                    q[..., :192].contiguous(),
                                    q[..., :192].contiguous(), instance=bad)
    with pytest.raises(ValueError, match="instance"):
        fa.flash_attention_cuda(q.float(), q.float(), q.float(), instance=16)

def _card_ssd_inputs(cuda, case, dtype, seed):
    """x, dt, A, B, C (x, B, C in ``dtype``) and an initial state or None
    for ``case`` = (B, L, H, P, N, chunk, init[, dt's range]), on the card
    from ``seed``; dt in [0.01, 0.2] unless the case names its range."""
    B, L, H, P, N, chunk, init = case[:7]
    lo, hi = case[7] if len(case) > 7 else (0.01, 0.2)
    g = torch.Generator(device=cuda).manual_seed(seed)
    x = torch.randn((B, L, H, P), generator=g, device=cuda).to(dtype)
    Bm = torch.randn((B, L, N), generator=g, device=cuda).to(dtype)
    Cm = torch.randn((B, L, N), generator=g, device=cuda).to(dtype)
    dt = torch.rand((B, L, H), generator=g, device=cuda) * (hi - lo) + lo
    A = -(torch.rand((H,), generator=g, device=cuda) * 1.5 + 0.5)
    s0 = torch.randn((B, H, P, N), generator=g, device=cuda) if init else None
    return x, dt, A, Bm, Cm, s0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", [
    (2, 64, 4, 8, 16, 16, False), (1, 80, 2, 8, 16, 32, True),
    (1, 300, 3, 64, 64, 256, True), (2, 2000, 4, 64, 64, 256, True),
    (1, 50, 2, 16, 8, 1024, True)])
def test_ssd_scan_kernel_matches_plain_on_card(cuda, case, dtype):
    from repro_torch.kernels import ssm_scan
    chunk = case[5]
    x, dt, A, Bm, Cm, s0 = _card_ssd_inputs(cuda, case, dtype,
                                            case[1] + case[2])
    before = ssm_scan.launches
    y, s = ops.ssd_scan(x, dt, A, Bm, Cm, chunk=chunk, initial_state=s0,
                        return_state=True)
    torch.cuda.synchronize()
    assert ssm_scan.launches == before + 1 and y.dtype == dtype
    yr, sr = ref.ssd_chunked_ref(x, dt, A, Bm, Cm, chunk=chunk,
                                 initial_state=s0, return_state=True)
    scale = yr.float().abs().max()
    tol = (2 ** -6 if dtype == torch.bfloat16 else 1e-4) * scale
    assert (y.float() - yr.float()).abs().max() <= tol
    assert (s - sr).abs().max() <= 1e-4 * sr.abs().max()
    assert torch.equal(ops.ssd_scan(x, dt, A, Bm, Cm, chunk=chunk,
                                    initial_state=s0), y)
    if dtype == torch.bfloat16:   # and element by element, against float32
        kw = dict(chunk=chunk, initial_state=s0)
        want = ref.ssd_chunked_ref(x.float(), dt, A, Bm.float(), Cm.float(),
                                   **kw)
        mag = _ssd_magnitude(x, dt, A, Bm, Cm, **kw)
        assert _ssd_gap(y, want, mag) <= SSD_GAP_C


# zamba2's full width and chunk at slow decays (dt * A below 2e-3): every
# key of a chunk reaches each output, where a bf16 accumulator shows
CARD_SSD_SLOW_DECAY = (2, 2048, 112, 64, 64, 256, True, SSD_SLOW_DECAY[1])
CARD_SSD_BF16_CASES = [
    # the shapes the tensor-core kernel masks or pads: (B, L, H, P, N,
    # chunk, init)
    (1, 200, 3, 8, 8, 16, True),             # P = N = 8, chunk 16
    (2, 130, 2, 24, 24, 48, False),          # P, N not multiples of 16
    (1, 300, 2, 40, 8, 100, True),           # chunk not a multiple of 64
    (1, 700, 2, 24, 8, 1024, False),         # L < chunk
    (2, 1, 3, 64, 64, 256, True),            # L = 1
    (1, 50, 2, 40, 24, 1024, True),
    (1, 90, 2, 12, 20, 32, True),            # rows not 16-byte aligned
    (1, 33, 2, 5, 3, 16, False),             # odd P and N
    (2, 2048, 4, 64, 64, 256, False),        # zamba2's head and chunk
    (2, 2000, 4, 64, 64, 256, True),         # ragged, initial state
    CARD_SSD_SLOW_DECAY,
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", CARD_SSD_BF16_CASES)
def test_ssd_scan_bf16_kernel_matches_plain_on_card(cuda, case):
    """The tensor-core kernel at the shapes it masks or pads, against the
    plain version on the same bf16 inputs (2^-6 of y's scale, the final
    state to 1e-4 of its scale) and against the plain route in float32
    element by element (ssd_gap); repeated calls are equal."""
    from repro_torch.kernels import ssm_scan
    x, dt, A, Bm, Cm, s0 = _card_ssd_inputs(cuda, case, torch.bfloat16,
                                            sum(case[:6]))
    kw = dict(chunk=case[5], initial_state=s0)
    before = ssm_scan.launches
    y, s = ops.ssd_scan(x, dt, A, Bm, Cm, return_state=True, **kw)
    torch.cuda.synchronize()
    assert ssm_scan.launches == before + 1 and y.dtype == torch.bfloat16
    yr, sr = ref.ssd_chunked_ref(x, dt, A, Bm, Cm, return_state=True, **kw)
    assert (y.float() - yr.float()).abs().max() <= \
        2 ** -6 * yr.float().abs().max()
    assert (s - sr).abs().max() <= 1e-4 * sr.abs().max()
    want = ref.ssd_chunked_ref(x.float(), dt, A, Bm.float(), Cm.float(), **kw)
    mag = _ssd_magnitude(x, dt, A, Bm, Cm, **kw)
    assert _ssd_gap(y, want, mag) <= SSD_GAP_C
    assert torch.equal(ops.ssd_scan(x, dt, A, Bm, Cm, **kw), y)


@pytest.mark.cuda
@pytest.mark.parametrize("case", CARD_SSD_BF16_CASES)
def test_ssd_scan_bf16_kernel_matches_f32_kernel_on_card(cuda, case):
    """The tensor-core bf16 kernel against the CUDA-core float32 kernel on
    the same (bf16-valued) inputs: the two kernels' arithmetic, directly,
    within 2^-6 of y's scale and SSD_GAP_C units element by element, the
    final states within 1e-4 of their scale."""
    from repro_torch.kernels.ssm_scan import ssd_scan_cuda
    x, dt, A, Bm, Cm, s0 = _card_ssd_inputs(cuda, case, torch.bfloat16,
                                            sum(case[:6]) + 1)
    kw = dict(chunk=case[5], initial_state=s0, return_state=True)
    y, s = ssd_scan_cuda(x, dt, A, Bm, Cm, **kw)
    want, want_s = ssd_scan_cuda(x.float(), dt, A, Bm.float(), Cm.float(),
                                 **kw)
    torch.cuda.synchronize()
    assert (y.float() - want).abs().max() <= 2 ** -6 * want.abs().max()
    mag = _ssd_magnitude(x, dt, A, Bm, Cm, chunk=case[5], initial_state=s0)
    assert _ssd_gap(y, want, mag) <= SSD_GAP_C
    assert (s - want_s).abs().max() <= 1e-4 * want_s.abs().max()


@pytest.mark.cuda
def test_ssd_gap_rejects_a_bf16_accumulator_on_card(cuda):
    """At zamba2's full width and chunk and slow decays, the kernel passes
    ssd_gap and the kernel's order with O kept in bf16, run on the card,
    fails it: the gate's power at the serve shape's width."""
    from repro_torch.kernels.ssm_scan import ssd_scan_cuda
    case = CARD_SSD_SLOW_DECAY
    x, dt, A, Bm, Cm, s0 = _card_ssd_inputs(cuda, case, torch.bfloat16, 11)
    kw = dict(chunk=case[5], initial_state=s0)
    y = ssd_scan_cuda(x, dt, A, Bm, Cm, **kw)
    want = ref.ssd_chunked_ref(x.float(), dt, A, Bm.float(), Cm.float(), **kw)
    mag = _ssd_magnitude(x, dt, A, Bm, Cm, **kw)
    assert _ssd_gap(y, want, mag) <= SSD_GAP_C
    fault, _ = _ssd_tensor_core_order(x, dt, A, Bm, Cm, fault="o", **kw)
    assert _ssd_gap(fault, want, mag) > SSD_GAP_C


@pytest.mark.cuda
@pytest.mark.parametrize("P,N", [(64, 64), (24, 8)])
def test_ssd_scan_bf16_kernel_takes_unaligned_rows_on_card(cuda, P, N):
    """x, B and C that start one element past a 16-byte boundary go
    through the kernel's plain loads and give the same bits as aligned
    copies through its cp.async copies."""
    from repro_torch.kernels.ssm_scan import ssd_scan_cuda
    case = (2, 300, 3, P, N, 128, True)
    x, dt, A, Bm, Cm, s0 = _card_ssd_inputs(cuda, case, torch.bfloat16, 5)

    def shifted(t):   # the same values at an address 2 bytes past aligned
        buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=cuda)
        view = buf[1:].view(t.shape)
        view.copy_(t)
        assert view.data_ptr() % 16 == 2
        return view
    kw = dict(chunk=case[5], initial_state=s0, return_state=True)
    y, s = ssd_scan_cuda(x, dt, A, Bm, Cm, **kw)
    y1, s1 = ssd_scan_cuda(shifted(x), dt, A, shifted(Bm), shifted(Cm), **kw)
    torch.cuda.synchronize()
    assert torch.equal(y, y1) and torch.equal(s, s1)


@pytest.mark.cuda
def test_lm_kernels_refuse_what_they_do_not_take_on_card(cuda):
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.kernels.ssm_scan import ssd_scan_cuda
    q = torch.zeros((1, 8, 2, 12), device=cuda)
    with pytest.raises(ValueError, match="multiple of 8"):
        flash_attention_cuda(q, q, q)
    q = torch.zeros((1, 8, 3, 16), device=cuda)
    with pytest.raises(ValueError, match="Hq % Hkv"):
        flash_attention_cuda(q, q[:, :, :2], q[:, :, :2])
    with pytest.raises(ValueError, match="grad"):
        flash_attention_cuda(q.requires_grad_(), q, q)
    q = torch.zeros((1 + 1 * 8 * 2 * 16,), device=cuda).bfloat16()
    with pytest.raises(ValueError, match="16-byte aligned"):
        flash_attention_cuda(*(q[1:].view(1, 8, 2, 16),) * 3)
    x = torch.zeros((1, 8, 2, 65), device=cuda)
    dt = torch.zeros((1, 8, 2), device=cuda)
    A = torch.zeros((2,), device=cuda)
    Bm = torch.zeros((1, 8, 16), device=cuda)
    with pytest.raises(ValueError, match="P <= 64"):
        ssd_scan_cuda(x, dt, A, Bm, Bm)
    with pytest.raises(TypeError, match="float32 dt"):
        ssd_scan_cuda(x[..., :8], dt.double(), A, Bm, Bm)


# (B, L, Hq, Hkv, D, n_valid)
CARD_DECODE_CASES = [
    (64, 3076, 24, 8, 128, 2150),   # minitron-4b's decode pool
    (8, 4096, 32, 32, 112, 3000),   # zamba2-7b's shared block
    (8, 4096, 12, 2, 128, 1),       # qwen2-vl-2b, one key
    (8, 2048, 32, 32, 64, 2048),    # musicgen-large, every slot
    (4, 4096, 48, 8, 128, 4096),    # mixtral-8x22b's sliding-window ring, full
    (2, 300, 16, 1, 256, 257),      # D = 256, g = 16: two blocks a kv head
    (1, 100, 5, 1, 8, 65),          # D = 8, g = 5, one request
    (3, 1000, 10, 2, 40, 0),        # no slot valid: each weighs the same
    (3, 1000, 10, 2, 40, 2000),     # n_valid past L counts as L
]


def _card_decode_inputs(cuda, case, dtype, seed):
    B, L, Hq, Hkv, D = case[:5]
    g = torch.Generator(device=cuda).manual_seed(seed)
    return [torch.randn(s, generator=g, device=cuda).to(dtype)
            for s in ((B, 1, Hq, D), (B, L, Hkv, D), (B, L, Hkv, D))]


def _decode_gap_ok(got, q, k, v, n_valid):
    """Within chip_smoke.py's gate (``decode_gap``) of the plain decode
    attention in float64 on the same inputs: float32 sums in another
    order, and for bf16 the output's one rounding."""
    cs = _chip_smoke()
    f64 = torch.float64
    q, k, v = (t.to(f64) for t in (q, k, v))
    valid = torch.arange(k.shape[1], device=q.device)[None, :] < n_valid
    want = ref.decode_attention_ref(q, k, v, valid, dtype=f64)
    unit = cs.decode_unit(q, k, v, n_valid, want)
    return cs.decode_gap(got, want, unit) <= cs.DECODE_GAP_C


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", CARD_DECODE_CASES)
def test_decode_attention_kernel_matches_plain_on_card(cuda, case, dtype):
    """The split-KV kernel through ``ops.decode_attention_prefix`` against
    the plain decode attention in float64 on the same inputs
    (``_decode_gap_ok``)."""
    from repro_torch.kernels import decode_attention as da
    n = case[5]
    q, k, v = _card_decode_inputs(cuda, case, dtype, sum(case))
    n_valid = torch.tensor([n], dtype=torch.int32, device=cuda)
    before = da.launches
    got = ops.decode_attention_prefix(q, k, v, n_valid, use_kernel=True)
    torch.cuda.synchronize()
    assert da.launches == before + 1 and got.dtype == dtype
    assert _decode_gap_ok(got, q, k, v, n)


@pytest.mark.cuda
@pytest.mark.parametrize("heads", [(2, 2), (7, 1)])
def test_decode_attention_kernel_takes_a_narrowed_cache_on_card(cuda, heads):
    """A split rank's kv heads are a ``narrow`` of its cache: the kernel
    reads them by their strides, with the result of the same heads copied
    out, bit for bit, and within the plain version's gate."""
    from repro_torch.kernels.decode_attention import decode_attention_cuda
    h0, n_h = heads
    q, k, v = _card_decode_inputs(cuda, (8, 2100, 24, 8, 128), torch.bfloat16,
                                  41)
    q = q[:, :, :3 * n_h]
    ks, vs = k.narrow(2, h0, n_h), v.narrow(2, h0, n_h)
    assert not ks.is_contiguous()
    n_valid = torch.tensor([1999], dtype=torch.int32, device=cuda)
    got = decode_attention_cuda(q, ks, vs, n_valid)
    copied = decode_attention_cuda(q, ks.contiguous(), vs.contiguous(),
                                   n_valid)
    torch.cuda.synchronize()
    assert torch.equal(got, copied)
    assert _decode_gap_ok(got, q, ks, vs, 1999)


@pytest.mark.cuda
def test_decode_attention_kernel_replays_in_a_cuda_graph_on_card(cuda):
    """Captured once, replayed after ``n_valid`` changed in place: equal to
    the eager call at each count, and nothing waits for the card on the way
    (``set_sync_debug_mode("error")`` raises on a synchronising call)."""
    q, k, v = _card_decode_inputs(cuda, (8, 1000, 24, 8, 128),
                                  torch.bfloat16, 43)
    n_valid = torch.tensor([300], dtype=torch.int32, device=cuda)
    run = functools.partial(ops.decode_attention_prefix, use_kernel=True)
    run(q, k, v, n_valid)   # builds and loads it
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    replays, eager = [], []
    try:
        with torch.cuda.graph(graph):   # its entry synchronises, by design
            torch.cuda.set_sync_debug_mode("error")
            out = run(q, k, v, n_valid)
        for n in (777, 1, 1000):
            n_valid.fill_(n)
            graph.replay()
            replays.append(out.clone())
            eager.append(run(q, k, v, torch.full((1,), n, dtype=torch.int32,
                                                 device=cuda)))
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    for a, b in zip(replays, eager):
        assert torch.equal(a, b)
    assert not torch.equal(replays[0], replays[1])


@pytest.mark.cuda
def test_decode_attention_kernel_refuses_what_it_does_not_take_on_card(cuda):
    from repro_torch.kernels.decode_attention import decode_attention_cuda
    q, k, v = _card_decode_inputs(cuda, (1, 64, 4, 2, 16), torch.bfloat16, 1)
    n = torch.ones((1,), dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError, match="int32"):
        decode_attention_cuda(q, k, v, n.long())
    with pytest.raises(ValueError, match="multiple"):
        decode_attention_cuda(q[..., :12], k[..., :12], v[..., :12], n)
    with pytest.raises(ValueError, match="Hq % Hkv"):
        decode_attention_cuda(q[:, :, :3], k, v, n)
    with pytest.raises(ValueError, match="16-byte aligned"):
        decode_attention_cuda(q[..., :8], k[..., 4:12], v[..., 4:12], n)
    with pytest.raises(TypeError, match="one dtype"):
        decode_attention_cuda(q.float(), k, v, n)
