"""Plain-torch versions of the hand-written kernels.

Each function here computes exactly what its CUDA kernel computes, in the
same order of operations, with ordinary tensor ops.  They are the CPU route
of ``kernels.ops`` and the yardstick the kernels are held to on the card;
nothing on the main path calls them when a card is present.
``take_columns`` is the gather they share with ``core.batched``'s plain
scoring ops.

The LM stack's twins (attention, the Mamba2 SSD scan and the RWKV6 WKV
scan) follow the JAX
package's oracles op for op, so that they are the port's oracle as those
are the reference's: ``attention_ref`` keeps the oracle's rounding of the
probabilities to ``v``'s dtype before the product with v, which the kernel
(like the Pallas kernel) does not do.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


# --------------------------------------------------------------------- #
# batched natural-cubic-spline fit (the additive refit's hot path)
# --------------------------------------------------------------------- #
def nat_spline_fit_ref(x: torch.Tensor, Y: torch.Tensor) -> torch.Tensor:
    """Natural-cubic-spline coefficients for many rows via a Thomas solve.

    x: (N,) strictly increasing knots; Y: (R, N) values.  Returns
    (R, N-1, 4) local coefficients a + b t + c t^2 + d t^3 in ``Y``'s dtype.
    The tridiagonal system for the interior second derivatives is shared
    across rows, so the forward-elimination factors depend on ``x`` only and
    the substitution sweeps run vectorized over all R rows.
    """
    Y = torch.atleast_2d(Y)
    dtype = Y.dtype
    x = x.to(device=Y.device, dtype=dtype)
    R, n = Y.shape
    if n == 1:
        return torch.cat([Y[:, :, None], Y.new_zeros((R, 1, 3))], dim=-1)
    if n == 2:
        slope = (Y[:, 1] - Y[:, 0]) / (x[1] - x[0])
        zero = Y.new_zeros((R,))
        return torch.stack([Y[:, 0], slope, zero, zero], dim=-1)[:, None, :]
    h = x[1:] - x[:-1]                                    # (N-1,)
    m = n - 2
    # interior system over M_1..M_{n-2}; natural boundary M_0 = M_{n-1} = 0
    sub = h[:-1]                                          # a_j, a_0 unused
    diag = 2.0 * (h[:-1] + h[1:])
    sup = h[1:]                                           # c_{m-1} unused
    rhs = 6.0 * ((Y[:, 2:] - Y[:, 1:-1]) / h[1:]
                 - (Y[:, 1:-1] - Y[:, :-2]) / h[:-1])     # (R, m)
    cps = [sup[0] / diag[0]]
    dps = [rhs[:, 0] / diag[0]]
    for j in range(1, m):
        denom = diag[j] - sub[j] * cps[j - 1]
        cps.append(sup[j] / denom)
        dps.append((rhs[:, j] - sub[j] * dps[j - 1]) / denom)
    interior = [dps[m - 1]]
    for j in range(m - 2, -1, -1):
        interior.insert(0, dps[j] - cps[j] * interior[0])
    zero = Y.new_zeros((R,))
    M = torch.stack([zero] + interior + [zero], dim=1)    # (R, N)
    a = Y[:, :-1]
    b = (Y[:, 1:] - Y[:, :-1]) / h - h * (2.0 * M[:, :-1] + M[:, 1:]) / 6.0
    c = M[:, :-1] / 2.0
    d = (M[:, 1:] - M[:, :-1]) / (6.0 * h)
    return torch.stack([a, b, c, d], dim=-1)


# --------------------------------------------------------------------- #
# batched nearest-centroid assignment (offline clustering hot loop)
# --------------------------------------------------------------------- #
def column_dots(X: torch.Tensor, C: torch.Tensor) -> torch.Tensor:
    """``X @ C.T`` for X (N, d) and C (M, d), summed over d in one fixed
    order, so that two equal centroids give equal columns.  A BLAS product
    promises no such thing: a vectorised kernel may round one column of a
    tile differently from another, and then a tie between equal centroids
    goes to the later one.  d is the feature count (4), so the d passes
    over (N, M) cost what the product did."""
    out = X[:, :1] * C[None, :, 0]
    for j in range(1, X.shape[1]):
        out = out + X[:, j:j + 1] * C[None, :, j]
    return out


def cluster_assign_ref(X: torch.Tensor, C: torch.Tensor
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """Nearest-centroid assignment for many points at once.

    X: (N, d) points; C: (M, d) centroids, both float32.  Returns (labels
    (N,) int32, min squared distance (N,) float32), the distance expanded as
    ``max(|x|^2 - 2 x.c + |c|^2, 0)`` and the label the first index of the
    minimum: each centroid's terms are computed alike (``column_dots``), as
    the CUDA kernel computes them one centroid at a time.
    """
    X = X.to(torch.float32)
    C = C.to(torch.float32)
    x2 = (X * X).sum(-1, keepdim=True)                    # (N, 1)
    c2 = column_dots(C, C).diagonal()[None, :]            # (1, M)
    d2 = torch.clamp(x2 - 2.0 * column_dots(X, C) + c2, min=0.0)  # (N, M)
    return torch.argmin(d2, dim=1).to(torch.int32), torch.amin(d2, dim=1)


# --------------------------------------------------------------------- #
# batched transfer-surface selection (fleet admission)
# --------------------------------------------------------------------- #
def take_columns(values: torch.Tensor, flat_idx: torch.Tensor) -> torch.Tensor:
    """``values[:, flat_idx]`` with the JAX package's gather semantics.

    values: (S, G); flat_idx: (K,) integer indices.  Returns (S, K).  As in
    ``jnp.take``'s default mode, an index in [-G, 0) counts from the end
    and an index outside [-G, G) reads NaN instead of raising (a raising
    gather on a CUDA tensor would be a device-side assert).
    """
    G = values.shape[1]
    i = flat_idx.to(torch.int64)
    i = torch.where(i < 0, i + G, i)
    ok = (i >= 0) & (i < G)
    got = values[:, torch.where(ok, i, torch.zeros_like(i))]
    return torch.where(ok[None, :], got, torch.full_like(got, float("nan")))


def batched_predict_argmax_ref(values: torch.Tensor, idx: torch.Tensor
                               ) -> tuple[torch.Tensor, torch.Tensor]:
    """Score candidate points on stacked surface lattices and pick the best.

    values: (S, G) flattened integer-lattice surface values; idx: (B, P)
    flat candidate indices.  Returns (best (B, S) float32, argk (B, S)
    int32): for every request x surface pair, the best candidate's value
    and its position in the candidate list.  The argmax takes the first
    index of the maximum, and a NaN among the candidates wins: the first
    NaN is the result, as ``jnp.max``/``jnp.argmax`` give it.
    """
    values = values.to(torch.float32)
    S = values.shape[0]
    B, P = idx.shape
    if P == 0:
        raise ValueError("batched_predict_argmax_ref needs P >= 1 candidates")
    scores = take_columns(values, idx.reshape(-1)).reshape(S, B, P)
    scores = scores.permute(1, 0, 2)                      # (B, S, P)
    nan = torch.isnan(scores)
    any_nan = nan.any(dim=-1)
    top = torch.where(nan, torch.full_like(scores, -float("inf")),
                      scores).amax(dim=-1)
    hit = torch.where(any_nan[..., None], nan, scores == top[..., None])
    pos = torch.arange(P, device=scores.device).expand_as(scores)
    argk = torch.where(hit, pos, torch.full_like(pos, P)).amin(dim=-1)
    best = scores.gather(-1, argk[..., None]).squeeze(-1)
    return best, argk.to(torch.int32)


# --------------------------------------------------------------------- #
# attention
# --------------------------------------------------------------------- #
NEG_INF = -1e30


def _band(qpos: torch.Tensor, kpos: torch.Tensor, causal: bool, window: int
          ) -> torch.Tensor:
    """(len(qpos), len(kpos)) bool: which keys each query may see."""
    mask = torch.ones((qpos.numel(), kpos.numel()), dtype=torch.bool,
                      device=qpos.device)
    if causal:
        mask &= kpos[None, :] <= qpos[:, None]
    if window > 0:
        mask &= kpos[None, :] > qpos[:, None] - window
    return mask


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: int = 0, q_offset: int = 0,
                  logits_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Grouped-query scaled-dot-product attention.

    q: (B, Sq, Hq, D); k, v: (B, Sk, Hkv, D) with Hq % Hkv == 0.
    ``q_offset`` is the absolute position of q[0] (decode: Sk - Sq).
    ``window`` > 0 enables sliding-window causal masking.
    Returns (B, Sq, Hq, D) in q.dtype.  A masked score is -1e30, so a query
    that sees no key gets the mean of v, as in the reference.
    """
    B, Sq, Hq, D = q.shape
    _, Sk, Hkv, _ = k.shape
    g = Hq // Hkv
    qr = q.reshape(B, Sq, Hkv, g, D)
    scale = 1.0 / np.sqrt(D)
    logits = torch.einsum("bqhgd,bkhd->bhgqk", qr.to(logits_dtype),
                          k.to(logits_dtype)) * scale
    qpos = torch.arange(Sq, device=q.device) + q_offset
    kpos = torch.arange(Sk, device=q.device)
    logits.masked_fill_(~_band(qpos, kpos, causal, window), NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    del logits
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs.to(v.dtype), v)
    return out.reshape(B, Sq, Hq, D).to(q.dtype)


def attention_blocked(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool = True, window: int = 0, q_offset: int = 0,
                      bq: int = 1024, bk: int = 1024) -> torch.Tensor:
    """Flash-style attention in plain torch: a loop over q blocks with an
    inner loop over kv blocks carrying online-softmax statistics, so no more
    than a (B, H, bq, bk) tile of scores is live.  Fully masked tiles are
    computed (the mask is applied numerically), as in the reference.
    Sq and Sk must be multiples of the block sizes (after clipping them to
    Sq and Sk)."""
    B, Sq, Hq, D = q.shape
    _, Sk, Hkv, _ = k.shape
    g = Hq // Hkv
    bq = min(bq, Sq)
    bk = min(bk, Sk)
    if Sq % bq or Sk % bk:
        raise ValueError(f"attention_blocked needs Sq % bq == 0 and "
                         f"Sk % bk == 0, got Sq={Sq}, bq={bq}, Sk={Sk}, bk={bk}")
    nq, nk = Sq // bq, Sk // bk
    f32 = torch.float32
    scale = 1.0 / np.sqrt(D)
    # (B, Hkv, g, S, D) head-major blocks
    qh = q.reshape(B, Sq, Hkv, g, D).permute(0, 2, 3, 1, 4).to(f32) * scale
    kh = k.permute(0, 2, 1, 3).to(f32)                    # (B, Hkv, Sk, D)
    vh = v.permute(0, 2, 1, 3).to(f32)
    dev = q.device
    blocks = []
    for qi in range(nq):
        qblk = qh[:, :, :, qi * bq:(qi + 1) * bq]         # (B,Hkv,g,bq,D)
        qpos = torch.arange(bq, device=dev) + q_offset + qi * bq
        m = torch.full((B, Hkv, g, bq), NEG_INF, dtype=f32, device=dev)
        l = torch.zeros((B, Hkv, g, bq), dtype=f32, device=dev)
        acc = torch.zeros((B, Hkv, g, bq, D), dtype=f32, device=dev)
        for ki in range(nk):
            kblk = kh[:, :, ki * bk:(ki + 1) * bk]        # (B,Hkv,bk,D)
            vblk = vh[:, :, ki * bk:(ki + 1) * bk]
            s = torch.einsum("bhgqd,bhkd->bhgqk", qblk, kblk)
            kpos = torch.arange(bk, device=dev) + ki * bk
            s = torch.where(_band(qpos, kpos, causal, window), s,
                            torch.full_like(s, NEG_INF))
            m_new = torch.maximum(m, s.amax(-1))
            p = torch.exp(s - m_new[..., None])
            alpha = torch.exp(m - m_new)
            l = alpha * l + p.sum(-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "bhgqk,bhkd->bhgqd", p, vblk)
            m = m_new
        out = acc / torch.clamp(l, min=1e-30)[..., None]  # (B,Hkv,g,bq,D)
        blocks.append(out.permute(0, 3, 1, 2, 4))         # (B,bq,Hkv,g,D)
    return torch.cat(blocks, dim=1).reshape(B, Sq, Hq, D).to(q.dtype)


def decode_attention_ref(q: torch.Tensor, k_cache: torch.Tensor,
                         v_cache: torch.Tensor, valid_mask: torch.Tensor, *,
                         dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Single-step attention against a (possibly ring-buffer) KV cache, the
    reference's ``decode_attention``: q (B, 1, Hq, D); caches (B, L, Hkv,
    D); valid_mask (B, L) or (1, L) -> q's dtype.  The scores, the softmax
    and P V in ``dtype`` (float32, as the reference; float64 for a
    witness) over every slot, the invalid ones masked to -1e30."""
    B, Sq, Hq, D = q.shape
    _, L, Hkv, _ = k_cache.shape
    g = Hq // Hkv
    qr = q.reshape(B, Sq, Hkv, g, D)
    scores = torch.einsum("bqhgd,blhd->bhgql", qr.to(dtype),
                          k_cache.to(dtype)) / torch.sqrt(
                              torch.tensor(D, dtype=dtype))
    mask = valid_mask[:, None, None, None, :]
    scores = torch.where(mask, scores, torch.full_like(scores, NEG_INF))
    probs = torch.softmax(scores, dim=-1)
    o = torch.einsum("bhgql,blhd->bqhgd", probs, v_cache.to(dtype))
    return o.reshape(B, Sq, Hq, D).to(q.dtype)


# --------------------------------------------------------------------- #
# Mamba2 SSD (state-space duality), chunked
# --------------------------------------------------------------------- #
def ssd_chunked_ref(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                    Bmat: torch.Tensor, Cmat: torch.Tensor, *,
                    chunk: int = 256, initial_state: torch.Tensor | None = None,
                    return_state: bool = False):
    """Chunked SSD scan (Dao & Gu 2024, "minimal mamba2" algorithm).

    x:  (B, L, H, P)   inputs per head
    dt: (B, L, H)      positive step sizes (already softplus'd)
    A:  (H,)           negative per-head decay rates
    Bmat, Cmat: (B, L, N)  input/output projections (single group)
    Returns y: (B, L, H, P) in x.dtype and, with ``return_state``, the
    final state (B, H, P, N) in float32.  A ragged L is padded with dt = 0
    steps (decay 1, no update), whose outputs are dropped.

    The reference's four-operand einsums are contracted pairwise, in this
    order, so that no (B, nc, Q, Q, H, P) product is ever formed:
      intra  = ((C.B^T) * Ldec) @_k (dt * x)
      states = ((decay_to_end * dt) * x) @_k B
      inter  = (C @_n entering) * exp(dA_cum)
    """
    Bsz, L, H, P = x.shape
    N = Bmat.shape[-1]
    if L % chunk:
        pad = chunk - L % chunk
        out = ssd_chunked_ref(
            F.pad(x, (0, 0, 0, 0, 0, pad)), F.pad(dt, (0, 0, 0, pad)), A,
            F.pad(Bmat, (0, 0, 0, pad)), F.pad(Cmat, (0, 0, 0, pad)),
            chunk=chunk, initial_state=initial_state,
            return_state=return_state)
        if return_state:
            return out[0][:, :L], out[1]
        return out[:, :L]
    nc = L // chunk
    f32 = torch.float32

    xc = x.reshape(Bsz, nc, chunk, H, P).to(f32)
    dtc = dt.reshape(Bsz, nc, chunk, H).to(f32)
    Bc = Bmat.reshape(Bsz, nc, chunk, N).to(f32)
    Cc = Cmat.reshape(Bsz, nc, chunk, N).to(f32)

    dA = dtc * A.to(f32)[None, None, None, :]            # (B, nc, Q, H) <= 0
    dA_cum = torch.cumsum(dA, dim=2)                     # within-chunk cumsum

    # intra-chunk (quadratic in chunk): causal decay matrix per head
    Ldec = dA_cum[:, :, :, None, :] - dA_cum[:, :, None, :, :]  # (B,nc,Q,Q,H)
    causal = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                   device=x.device))
    # exp where k <= q, 0 above the diagonal.  Above it the entries are the
    # decay sums between k and q, which overflow exp past ~88; they are set
    # to -inf before the exp (exp gives 0 there, as the reference's masking
    # after the exp does), so that no inf reaches the backward as 0 x inf:
    # the reference's gradient is NaN wherever one overflows, this one is
    # that gradient everywhere else.  In place where autograd does not
    # record: the serve shape's (B, nc, Q, Q, H) tile is ~1.9 GB.
    above = ~causal[None, None, :, :, None]
    cb = torch.einsum("bcqn,bckn->bcqk", Cc, Bc)         # (B,nc,Q,Q)
    if Ldec.requires_grad:
        Ldec = torch.exp(Ldec.masked_fill(above, -torch.inf)) * cb[..., None]
    else:
        Ldec.masked_fill_(above, -torch.inf).exp_()
        Ldec.mul_(cb[..., None])                         # (B,nc,Q,K,H)
    u = dtc[..., None] * xc                              # (B,nc,K,H,P)
    intra = torch.einsum("bcqkh,bckhp->bcqhp", Ldec, u)
    del Ldec, u

    # chunk-final states
    decay_to_end = torch.exp(dA_cum[:, :, -1:, :] - dA_cum)      # (B,nc,Q,H)
    w = (decay_to_end * dtc)[..., None] * xc                     # (B,nc,K,H,P)
    states = torch.einsum("bckhp,bckn->bchpn", w, Bc)            # (B,nc,H,P,N)
    del w

    # inter-chunk recurrence over chunk states
    chunk_decay = torch.exp(dA_cum[:, :, -1, :])                 # (B,nc,H)
    s = (torch.zeros((Bsz, H, P, N), dtype=f32, device=x.device)
         if initial_state is None else initial_state.to(f32))
    entering = []
    for c in range(nc):
        entering.append(s)                           # state *entering* chunk c
        s = s * chunk_decay[:, c, :, None, None] + states[:, c]
    entering = torch.stack(entering, dim=1)                      # (B,nc,H,P,N)

    # contribution of the entering state within each chunk
    state_decay = torch.exp(dA_cum)                              # (B,nc,Q,H)
    inter = torch.einsum("bcqn,bchpn->bcqhp", Cc, entering) \
        * state_decay[..., None]

    y = (intra + inter).reshape(Bsz, L, H, P).to(x.dtype)
    if return_state:
        return y, s
    return y


def ssd_decode_step(state: torch.Tensor, x_t: torch.Tensor,
                    dt_t: torch.Tensor, A: torch.Tensor, B_t: torch.Tensor,
                    C_t: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Single-token SSD recurrence.

    state: (B, H, P, N); x_t: (B, H, P); dt_t: (B, H); B_t, C_t: (B, N).
    Returns (y_t (B, H, P) in x_t.dtype, new_state float32).
    """
    f32 = torch.float32
    dA = torch.exp(dt_t.to(f32) * A.to(f32)[None, :])            # (B, H)
    upd = (dt_t.to(f32)[:, :, None] * x_t.to(f32))[..., None] \
        * B_t.to(f32)[:, None, None, :]                         # (B,H,P,N)
    new_state = state * dA[..., None, None] + upd
    y = torch.einsum("bhpn,bn->bhp", new_state, C_t.to(f32))
    return y.to(x_t.dtype), new_state


def ssd_sequential_ref(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                       Bmat: torch.Tensor, Cmat: torch.Tensor,
                       initial_state: torch.Tensor | None = None
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """Token-by-token SSD oracle used to validate the chunked form."""
    Bsz, L, H, P = x.shape
    N = Bmat.shape[-1]
    state = (torch.zeros((Bsz, H, P, N), dtype=torch.float32, device=x.device)
             if initial_state is None else initial_state.to(torch.float32))
    ys = []
    for t in range(L):
        y, state = ssd_decode_step(state, x[:, t], dt[:, t], A,
                                   Bmat[:, t], Cmat[:, t])
        ys.append(y)
    return torch.stack(ys, dim=1), state


# --------------------------------------------------------------------- #
# RWKV6 (Finch) linear attention with data-dependent decay, chunked
# --------------------------------------------------------------------- #
def rwkv6_chunked_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      w: torch.Tensor, u: torch.Tensor, *, chunk: int = 128,
                      initial_state: torch.Tensor | None = None,
                      return_state: bool = False):
    """Chunked RWKV6 WKV computation.

    r, k: (B, L, H, K); v: (B, L, H, V); w: (B, L, H, K) log-decay (<= 0,
    data-dependent, float32); u: (H, K) bonus for the current token.  State
    S (B, H, K, V) float32 with recurrence S_t = diag(exp(w_t)) S_{t-1} +
    k_t v_t^T and output y_t = r_t @ (S_{t-1} + diag(u) k_t v_t^T), in r's
    dtype.  A ragged L is padded with w = 0 (decay 1) and r = k = 0 steps:
    the state is unchanged and their outputs are dropped.

    As the reference does, the intra-chunk decay exp(wcum_{t-1} - wcum_s)
    is split across the two operands, r exp(wcum_{t-1}) and k exp(-wcum_s);
    both stay inside float32 only while |w| * chunk stays below ~88 (the
    model clamps |w| to 4 and takes chunk 16).  Every einsum has two
    operands; the bonus sums r u k over K before it meets v, and the
    chunk states are carried in a loop over the chunks, as in
    ``ssd_chunked_ref``.
    """
    Bsz, L, H, K = r.shape
    V = v.shape[-1]
    if L % chunk:
        pad = chunk - L % chunk
        p4 = (0, 0, 0, 0, 0, pad)
        out = rwkv6_chunked_ref(
            F.pad(r, p4), F.pad(k, p4), F.pad(v, p4), F.pad(w, p4), u,
            chunk=chunk, initial_state=initial_state,
            return_state=return_state)
        if return_state:
            return out[0][:, :L], out[1]
        return out[:, :L]
    nc = L // chunk
    f32 = torch.float32

    rc = r.reshape(Bsz, nc, chunk, H, K).to(f32)
    kc = k.reshape(Bsz, nc, chunk, H, K).to(f32)
    vc = v.reshape(Bsz, nc, chunk, H, V).to(f32)
    wc = w.reshape(Bsz, nc, chunk, H, K).to(f32)

    wcum = torch.cumsum(wc, dim=2)                      # within-chunk log-decay
    ri = rc * torch.exp(wcum - wc)                      # exponent +wcum_{t-1}
    ki = kc * torch.exp(-wcum)                          # exponent -wcum_s
    att = torch.einsum("bcthk,bcshk->bchts", ri, ki)    # (B,nc,H,Q,Q)
    strict = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                   device=r.device), -1)
    att = att.masked_fill(~strict, 0.0)
    intra = torch.einsum("bchts,bcshv->bcthv", att, vc)
    # current-token bonus: u replaces the decay for s == t
    bonus = (rc * u.to(f32)[None, None, None] * kc).sum(-1, keepdim=True) * vc

    # chunk summary: the state update of the whole chunk
    total = wcum[:, :, -1:]                             # (B,nc,1,H,K)
    k_tail = kc * torch.exp(total - wcum)               # decay from s to end
    chunk_state = torch.einsum("bcshk,bcshv->bchkv", k_tail, vc)
    chunk_decay = torch.exp(total[:, :, 0])             # (B,nc,H,K)

    s = (torch.zeros((Bsz, H, K, V), dtype=f32, device=r.device)
         if initial_state is None else initial_state.to(f32))
    entering = []
    for c in range(nc):
        entering.append(s)                           # state *entering* chunk c
        s = s * chunk_decay[:, c, :, :, None] + chunk_state[:, c]
    entering = torch.stack(entering, dim=1)             # (B,nc,H,K,V)

    inter = torch.einsum("bcthk,bchkv->bcthv", ri, entering)
    y = (intra + inter + bonus).reshape(Bsz, L, H, V).to(r.dtype)
    if return_state:
        return y, s
    return y


def rwkv6_decode_step(state: torch.Tensor, r_t: torch.Tensor,
                      k_t: torch.Tensor, v_t: torch.Tensor, w_t: torch.Tensor,
                      u: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Single-token RWKV6 step.  state: (B, H, K, V) float32; r, k, w:
    (B, H, K); v: (B, H, V).  Returns (y (B, H, V) in r_t's dtype, new
    state float32)."""
    f32 = torch.float32
    rt, kt, vt, wt = (a.to(f32) for a in (r_t, k_t, v_t, w_t))
    kv = kt[..., :, None] * vt[..., None, :]                    # (B,H,K,V)
    y = torch.einsum("bhk,bhkv->bhv", rt,
                     state + u.to(f32)[None, :, :, None] * kv)
    new_state = state * torch.exp(wt)[..., None] + kv
    return y.to(r_t.dtype), new_state


def rwkv6_sequential_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         w: torch.Tensor, u: torch.Tensor,
                         initial_state: torch.Tensor | None = None
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """Token-by-token oracle used to validate the chunked form."""
    Bsz, L, H, K = r.shape
    V = v.shape[-1]
    state = (torch.zeros((Bsz, H, K, V), dtype=torch.float32, device=r.device)
             if initial_state is None else initial_state.to(torch.float32))
    ys = []
    for t in range(L):
        y, state = rwkv6_decode_step(state, r[:, t], k[:, t], v[:, t],
                                     w[:, t], u)
        ys.append(y)
    return torch.stack(ys, dim=1), state
