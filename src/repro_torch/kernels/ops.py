"""Dispatch over the hand-written kernels and their plain-torch versions.

The route follows the tensor's device and nothing else: a CUDA tensor goes
to the CUDA kernel (which raises on anything it does not take), a CPU tensor
to the plain version in ``ref.py``.  There is no fallback from one to the
other.  Whether a caller goes through these functions at all is its own
``use_kernel`` choice (see ``device.resolve_use_kernel``).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ref


def cluster_assign(X: torch.Tensor, C: torch.Tensor
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Nearest-centroid assignment: X (N, d) points vs C (M, d) centroids.

    Returns (labels (N,) int32, min squared distance (N,) f32) — the offline
    clustering path's million-row label pass and the additive refit's
    routing of large refresh batches (``core.clustering``).
    """
    if X.is_cuda:
        from repro_torch.kernels.cluster_assign import cluster_assign_cuda
        return cluster_assign_cuda(X, C)
    return ref.cluster_assign_ref(X, C)


def transfer_predict_argmax(values: torch.Tensor, idx: torch.Tensor
                            ) -> tuple[torch.Tensor, torch.Tensor]:
    """Best candidate per (request, surface) over stacked surface lattices.

    values: (S, G) flattened integer-lattice surface values; idx: (B, P)
    flat candidate indices.  Returns (best (B, S) f32, argk (B, S) int32) —
    fleet admission's batched predict/argmax (``core.batched``).
    """
    if values.is_cuda:
        from repro_torch.kernels.transfer_select import (
            batched_predict_argmax_cuda,
        )
        return batched_predict_argmax_cuda(values, idx)
    return ref.batched_predict_argmax_ref(values, idx)


def nat_spline_fit(x: torch.Tensor, Y: torch.Tensor) -> torch.Tensor:
    """Natural-cubic-spline coefficients for many rows over shared knots.

    x: (N,) strictly increasing knots; Y: (R, N) values.  Returns
    (R, N-1, 4) — the batched Thomas solve the additive refit uses to refit
    every touched (cluster, bin) spline row in one call
    (``core.surfaces.fit_surfaces_batched``).
    """
    if Y.is_cuda:
        from repro_torch.kernels.spline_fit import nat_spline_fit_cuda
        return nat_spline_fit_cuda(x, Y)
    return ref.nat_spline_fit_ref(x, Y)


# Above this KV length the plain route switches from materialised scores to
# the blocked online-softmax loop (the reference's switch).
BLOCKED_ATTENTION_THRESHOLD = 2048


def plain_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0, q_offset: int = 0
                    ) -> torch.Tensor:
    """The plain route of ``flash_attention``, the reference's non-Pallas
    one: ``attention_ref`` up to 2048 keys, ``attention_blocked`` above."""
    if k.shape[1] > BLOCKED_ATTENTION_THRESHOLD:
        return ref.attention_blocked(q, k, v, causal=causal, window=window,
                                     q_offset=q_offset)
    return ref.attention_ref(q, k, v, causal=causal, window=window,
                             q_offset=q_offset)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0, q_offset: int = 0
                    ) -> torch.Tensor:
    """GQA scaled-dot-product attention. q: (B, Sq, Hq, D); k/v:
    (B, Sk, Hkv, D) -> (B, Sq, Hq, D) in q.dtype — the prefill of every
    attention layer: the hybrid's shared block, each GQA layer of the
    dense and MoE stacks and each MLA layer, at q-k width with v padded to
    it (``models.attention``)."""
    if q.is_cuda:
        from repro_torch.kernels.flash_attention import flash_attention_cuda
        return flash_attention_cuda(q, k, v, causal=causal, window=window,
                                    q_offset=q_offset)
    return plain_attention(q, k, v, causal=causal, window=window,
                           q_offset=q_offset)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, valid_mask: torch.Tensor
                     ) -> torch.Tensor:
    """Single-step attention against a (possibly ring-buffer) KV cache.

    q: (B, 1, Hq, D); caches: (B, L, Hkv, D); valid_mask: (B, L) or (1, L).
    Plain torch on every device, as in the reference, which has no kernel
    for it: a memory-bound gather and reduce over the cache.
    """
    B, Sq, Hq, D = q.shape
    _, L, Hkv, _ = k_cache.shape
    g = Hq // Hkv
    f32 = torch.float32
    qr = q.reshape(B, Sq, Hkv, g, D)
    scores = torch.einsum("bqhgd,blhd->bhgql", qr.to(f32),
                          k_cache.to(f32)) / torch.sqrt(
                              torch.tensor(D, dtype=f32))
    mask = valid_mask[:, None, None, None, :]
    scores = torch.where(mask, scores, torch.full_like(scores, ref.NEG_INF))
    probs = torch.softmax(scores, dim=-1)
    o = torch.einsum("bhgql,blhd->bqhgd", probs, v_cache.to(f32))
    return o.reshape(B, Sq, Hq, D).to(q.dtype)


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             B: torch.Tensor, C: torch.Tensor, *, chunk: int = 128,
             initial_state: torch.Tensor | None = None,
             return_state: bool = False):
    """Mamba2 SSD over a sequence (``ref.ssd_chunked_ref``'s contract):
    y (B, L, H, P) in x.dtype and, with ``return_state``, the final state
    (B, H, P, N) f32 — every Mamba2 layer's prefill (``models.ssm``)."""
    if x.is_cuda:
        from repro_torch.kernels.ssm_scan import ssd_scan_cuda
        return ssd_scan_cuda(x, dt, A, B, C, chunk=chunk,
                             initial_state=initial_state,
                             return_state=return_state)
    return ref.ssd_chunked_ref(x, dt, A, B, C, chunk=chunk,
                               initial_state=initial_state,
                               return_state=return_state)


def rwkv6_scan(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               w: torch.Tensor, u: torch.Tensor, *, chunk: int = 16,
               initial_state: torch.Tensor | None = None,
               return_state: bool = False):
    """RWKV6 WKV over a sequence (``ref.rwkv6_chunked_ref``'s contract):
    y (B, L, H, V) in r.dtype and, with ``return_state``, the final state
    (B, H, K, V) f32 -- every RWKV6 layer's prefill and decode step
    (``models.rwkv``)."""
    if r.is_cuda:
        from repro_torch.kernels.rwkv6 import rwkv6_cuda
        return rwkv6_cuda(r, k, v, w, u, chunk=chunk,
                          initial_state=initial_state,
                          return_state=return_state)
    return ref.rwkv6_chunked_ref(r, k, v, w, u, chunk=chunk,
                                 initial_state=initial_state,
                                 return_state=return_state)
