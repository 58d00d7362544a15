"""Dispatch over the hand-written kernels and their plain-torch versions.

The route follows the tensor's device and nothing else: a CUDA tensor goes
to the CUDA kernel (which raises on anything it does not take), a CPU tensor
to the plain version in ``ref.py``.  There is no fallback from one to the
other.  Whether a caller goes through these functions at all is its own
``use_kernel`` choice (see ``device.resolve_use_kernel``).

The three LM kernels have no backward kernel, and neither have the JAX
package's (it trains through its XLA oracles).  Where autograd records a
call (grad mode on and an input that requires grad), it goes through a
``torch.autograd.Function`` per kernel: its forward is the same route on
the inputs detached (the kernel on the card), and its backward recomputes
the plain version from the saved inputs and returns that version's
vector-Jacobian product, the gradient the reference's training route
computes.  ``decode_attention_prefix``'s kernel serves decode alone and has
no gradient; it takes the caller's ``use_kernel`` itself, since its plain
route first builds the mask of the valid slots.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ref
from repro_torch.trace import span


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


def _flash_attention(q, k, v, *, causal: bool, window: int, q_offset: int
                     ) -> torch.Tensor:
    if q.is_cuda:
        from repro_torch.kernels.flash_attention import flash_attention_cuda
        return flash_attention_cuda(q, k, v, causal=causal, window=window,
                                    q_offset=q_offset)
    return plain_attention(q, k, v, causal=causal, window=window,
                           q_offset=q_offset)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0, q_offset: int = 0
                    ) -> torch.Tensor:
    """GQA scaled-dot-product attention. q: (B, Sq, Hq, D); k/v:
    (B, Sk, Hkv, D) -> (B, Sq, Hq, D) in q.dtype — the prefill of every
    attention layer: the hybrid's shared block, each GQA layer of the
    dense and MoE stacks and each MLA layer, at q-k width with v padded to
    it (``models.attention``); and their training forward, with the
    gradient of ``plain_attention`` (``FlashAttentionGrad``)."""
    if _records(q, k, v):
        return FlashAttentionGrad.apply(q, k, v, causal, window, q_offset)
    return _flash_attention(q, k, v, causal=causal, window=window,
                            q_offset=q_offset)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, valid_mask: torch.Tensor
                     ) -> torch.Tensor:
    """Single-step attention against a (possibly ring-buffer) KV cache.

    q: (B, 1, Hq, D); caches: (B, L, Hkv, D); valid_mask: (B, L) or (1, L).
    Plain torch on every device, as in the reference, which has no kernel
    for it (``ref.decode_attention_ref``): it casts the whole cache to
    float32 before it multiplies.
    """
    with span("repro.decode_attend"):
        return ref.decode_attention_ref(q, k_cache, v_cache, valid_mask)


def decode_attention_prefix(q: torch.Tensor, k_cache: torch.Tensor,
                            v_cache: torch.Tensor, n_valid: torch.Tensor, *,
                            use_kernel: bool | None) -> torch.Tensor:
    """``decode_attention`` where the valid slots are the prefix
    ``[0, n_valid)`` of the caches, as in every GQA cache (a sliding
    window's ring included), ``n_valid`` a one-element int32 tensor on q's
    device: with ``use_kernel``, on the card, the split-KV CUDA kernel,
    which reads only those slots and never waits for the card
    (``kernels.decode_attention``); else ``decode_attention`` over the
    prefix's mask."""
    if use_kernel and q.is_cuda:
        from repro_torch.kernels.decode_attention import decode_attention_cuda
        with span("repro.decode_attend"):
            return decode_attention_cuda(q, k_cache, v_cache, n_valid)
    valid = torch.arange(k_cache.shape[1], device=q.device)[None, :] < n_valid
    return decode_attention(q, k_cache, v_cache, valid)


def _ssd_scan(x, dt, A, B, C, **kw):
    if x.is_cuda:
        from repro_torch.kernels.ssm_scan import ssd_scan_cuda
        return ssd_scan_cuda(x, dt, A, B, C, **kw)
    return ref.ssd_chunked_ref(x, dt, A, B, C, **kw)


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             B: torch.Tensor, C: torch.Tensor, *, chunk: int = 128,
             initial_state: torch.Tensor | None = None,
             return_state: bool = False):
    """Mamba2 SSD over a sequence (``ref.ssd_chunked_ref``'s contract):
    y (B, L, H, P) in x.dtype and, with ``return_state``, the final state
    (B, H, P, N) f32 — every Mamba2 layer's prefill (``models.ssm``), and
    its training forward from a zero state without the final state, with
    the gradient of ``ref.ssd_chunked_ref`` (``SsdScanGrad``)."""
    if _records(x, dt, A, B, C, initial_state):
        _trainable("ssd_scan", initial_state, return_state)
        return SsdScanGrad.apply(x, dt, A, B, C, chunk)
    return _ssd_scan(x, dt, A, B, C, chunk=chunk,
                     initial_state=initial_state, return_state=return_state)


def _rwkv6_scan(r, k, v, w, u, **kw):
    if r.is_cuda:
        from repro_torch.kernels.rwkv6 import rwkv6_cuda
        return rwkv6_cuda(r, k, v, w, u, **kw)
    return ref.rwkv6_chunked_ref(r, k, v, w, u, **kw)


def rwkv6_scan(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               w: torch.Tensor, u: torch.Tensor, *, chunk: int = 16,
               initial_state: torch.Tensor | None = None,
               return_state: bool = False):
    """RWKV6 WKV over a sequence (``ref.rwkv6_chunked_ref``'s contract):
    y (B, L, H, V) in r.dtype and, with ``return_state``, the final state
    (B, H, K, V) f32 -- every RWKV6 layer's prefill and decode step
    (``models.rwkv``), and its training forward from a zero state without
    the final state, with the gradient of ``ref.rwkv6_chunked_ref``
    (``Rwkv6ScanGrad``)."""
    if _records(r, k, v, w, u, initial_state):
        _trainable("rwkv6_scan", initial_state, return_state)
        return Rwkv6ScanGrad.apply(r, k, v, w, u, chunk)
    return _rwkv6_scan(r, k, v, w, u, chunk=chunk,
                       initial_state=initial_state, return_state=return_state)


# --------------------------------------------------------------------- #
# gradients: the kernel forward, the plain version's vjp backward
# --------------------------------------------------------------------- #
def _records(*ts) -> bool:
    """Whether autograd records a call on these inputs (None skipped)."""
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in ts)


def _trainable(name: str, initial_state, return_state: bool) -> None:
    """Training runs a scan from a zero state and takes no final state;
    the gradient of anything else is not provided."""
    if initial_state is not None or return_state:
        raise NotImplementedError(
            f"{name} has a gradient only from a zero state and without the "
            f"final state (initial_state=None, return_state=False)")


def _plain_vjp(ctx, plain, grad: torch.Tensor, n: int, **kw) -> tuple:
    """The gradients of ``plain(*inputs, **kw)`` against ``grad`` for the
    first ``n`` inputs of ``ctx`` (saved tensors), recomputed from them;
    None where an input needs none."""
    need = ctx.needs_input_grad[:n]
    with torch.enable_grad():
        xs = [t.detach().requires_grad_(g)
              for t, g in zip(ctx.saved_tensors, need)]
        out = plain(*xs, **kw)
        grads = iter(torch.autograd.grad(
            out, [x for x in xs if x.requires_grad], grad))
    return tuple(next(grads) if g else None for g in need)


class FlashAttentionGrad(torch.autograd.Function):
    """``flash_attention`` with a backward: the kernel forward on the
    detached inputs, the vjp of ``plain_attention`` (looked up at the
    call) in the backward."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, q_offset):
        ctx.save_for_backward(q, k, v)
        ctx.kw = dict(causal=causal, window=window, q_offset=q_offset)
        return _flash_attention(q.detach(), k.detach(), v.detach(), **ctx.kw)

    @staticmethod
    def backward(ctx, grad):
        return _plain_vjp(ctx, plain_attention, grad, 3, **ctx.kw) \
            + (None, None, None)


class SsdScanGrad(torch.autograd.Function):
    """``ssd_scan`` from a zero state with a backward: the kernel forward,
    the vjp of ``ref.ssd_chunked_ref`` in the backward."""

    @staticmethod
    def forward(ctx, x, dt, A, B, C, chunk):
        ctx.save_for_backward(x, dt, A, B, C)
        ctx.chunk = chunk
        return _ssd_scan(*(t.detach() for t in (x, dt, A, B, C)), chunk=chunk)

    @staticmethod
    def backward(ctx, grad):
        return _plain_vjp(ctx, ref.ssd_chunked_ref, grad, 5,
                          chunk=ctx.chunk) + (None,)


class Rwkv6ScanGrad(torch.autograd.Function):
    """``rwkv6_scan`` from a zero state with a backward: the kernel
    forward, the vjp of ``ref.rwkv6_chunked_ref`` in the backward."""

    @staticmethod
    def forward(ctx, r, k, v, w, u, chunk):
        ctx.save_for_backward(r, k, v, w, u)
        ctx.chunk = chunk
        return _rwkv6_scan(*(t.detach() for t in (r, k, v, w, u)),
                           chunk=chunk)

    @staticmethod
    def backward(ctx, grad):
        return _plain_vjp(ctx, ref.rwkv6_chunked_ref, grad, 5,
                          chunk=ctx.chunk) + (None,)
