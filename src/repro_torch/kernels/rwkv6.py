"""RWKV6 WKV chunked scan on the card: the wrapper of ``csrc/rwkv6.cu``.

Every RWKV6 layer runs it, in prefill and in every decode step
(``models.rwkv.rwkv6_time_mix``; rwkv6-1.6b: 24 times a prefill and 24
times a decode step, the latter at L = 1 and chunk 1 from the carried
state).  One CUDA block owns a (batch, head), carries its (K, V) float32
state in registers through the chunks in order and prefetches the next
chunk with ``cp.async``; it takes an initial state, returns the final state
itself, takes a ragged L as the plain version pads it, and forms each
chunk's weights split across the operands as the plain version does where
that cannot overflow (largest |cumsum of w| over the chunk at most 64),
else with each pair's decay taken directly (see the note at the top of the
source).  Its plain-torch version is ``kernels.ref.rwkv6_chunked_ref``.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

MAX_KV = 64
MAX_CHUNK = 64
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# Kernel launches since import; callers that count a run reset it to 0.
launches = 0


# rwkv6_launch(r, k, v, w, u, init, y, final_state, dtype, B, L, H, K, V, Q,
# stream)
ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7 + [ctypes.c_void_p]


@functools.lru_cache(maxsize=None)
def _lib():
    lib = _build.load("rwkv6")
    fn = lib.rwkv6_launch
    fn.argtypes = ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def rwkv6_cuda(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               w: torch.Tensor, u: torch.Tensor, *, chunk: int = 16,
               initial_state: torch.Tensor | None = None,
               return_state: bool = False):
    """r, k (B, L, H, K) and v (B, L, H, V) in one dtype, float32 or
    bfloat16; w (B, L, H, K) and initial_state (B, H, K, V) in float32; u
    (H, K) in r's dtype or float32; all contiguous on one CUDA device.
    Returns y (B, L, H, V) in r's dtype and, with ``return_state``, the
    final state (B, H, K, V) float32.  Raises on anything the kernel does
    not take: K or V above 64, chunk above 64, inputs that require grad
    (there is no backward)."""
    global launches
    ts = [r, k, v, w, u] + ([] if initial_state is None else [initial_state])
    if not all(t.is_cuda for t in ts) or len({t.device for t in ts}) != 1:
        raise ValueError("rwkv6_cuda needs every input on one CUDA device")
    if r.dtype not in _DTYPES or k.dtype != r.dtype or v.dtype != r.dtype:
        raise TypeError(f"rwkv6_cuda takes r, k, v of one dtype, float32 or "
                        f"bfloat16, got {r.dtype}, {k.dtype}, {v.dtype}")
    if w.dtype != torch.float32 or u.dtype not in (r.dtype, torch.float32) \
            or (initial_state is not None
                and initial_state.dtype != torch.float32):
        raise TypeError("rwkv6_cuda takes float32 w and initial_state, and u "
                        "in r's dtype or float32")
    if any(t.requires_grad for t in ts):
        raise ValueError("rwkv6_cuda has no backward; call it on tensors that "
                         "do not require grad (ops.rwkv6_scan gives it the "
                         "plain version's)")
    if r.dim() != 4:
        raise ValueError(f"r {tuple(r.shape)} is not (B, L, H, K)")
    Bsz, L, H, K = r.shape
    V = v.shape[-1]
    if (k.shape != r.shape or w.shape != r.shape
            or tuple(v.shape) != (Bsz, L, H, V) or tuple(u.shape) != (H, K)
            or (initial_state is not None
                and tuple(initial_state.shape) != (Bsz, H, K, V))):
        raise ValueError(
            f"shapes r {tuple(r.shape)}, k {tuple(k.shape)}, v "
            f"{tuple(v.shape)}, w {tuple(w.shape)}, u {tuple(u.shape)}"
            + ("" if initial_state is None else
               f", initial_state {tuple(initial_state.shape)}")
            + " are not (B, L, H, K) three times, (B, L, H, V), (H, K) and "
              "(B, H, K, V)")
    if not (1 <= K <= MAX_KV and 1 <= V <= MAX_KV and 1 <= chunk <= MAX_CHUNK):
        raise ValueError(f"rwkv6_cuda takes K, V <= {MAX_KV} and 1 <= chunk <= "
                         f"{MAX_CHUNK}, got K={K}, V={V}, chunk={chunk}")
    if min(Bsz, L, H) < 1 or Bsz > 65535 or H > 2 ** 31 - 1:
        raise ValueError(f"rwkv6_cuda takes 1 <= B <= 65535 and L, H >= 1, "
                         f"got B={Bsz}, L={L}, H={H}")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("rwkv6_cuda needs contiguous inputs")
    u32 = u.to(torch.float32)
    y = torch.empty_like(v)
    final = (torch.empty((Bsz, H, K, V), dtype=torch.float32, device=r.device)
             if return_state else None)
    fn = _lib()
    with torch.cuda.device(r.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
                u32.data_ptr(),
                None if initial_state is None else initial_state.data_ptr(),
                y.data_ptr(), None if final is None else final.data_ptr(),
                _DTYPES[r.dtype], Bsz, L, H, K, V, int(chunk), stream)
    if rc != 0:
        raise RuntimeError(f"rwkv6 kernel launch failed: CUDA error {rc}")
    launches += 1
    return (y, final) if return_state else y
