"""Plain-torch versions of the hand-written kernels.

Each function here computes exactly what its CUDA kernel computes, in the
same order of operations, with ordinary tensor ops.  They are the CPU route
of ``kernels.ops`` and the yardstick the kernels are held to on the card;
nothing on the main path calls them when a card is present.
``take_columns`` is the gather they share with ``core.batched``'s plain
scoring ops.
"""
from __future__ import annotations

import torch


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
def cluster_assign_ref(X: torch.Tensor, C: torch.Tensor
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """Nearest-centroid assignment for many points at once.

    X: (N, d) points; C: (M, d) centroids, both float32.  Returns (labels
    (N,) int32, min squared distance (N,) float32), the distance expanded as
    ``max(|x|^2 - 2 x.c + |c|^2, 0)`` and the label the first index of the
    minimum.
    """
    X = X.to(torch.float32)
    C = C.to(torch.float32)
    x2 = (X * X).sum(-1, keepdim=True)                    # (N, 1)
    c2 = (C * C).sum(-1)[None, :]                         # (1, M)
    d2 = torch.clamp(x2 - 2.0 * (X @ C.T) + c2, min=0.0)  # (N, M)
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
