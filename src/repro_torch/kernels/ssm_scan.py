"""Mamba2 SSD chunked scan on the card: the wrapper of ``csrc/ssd_scan.cu``.

Every Mamba2 layer's prefill runs it (``models.ssm.mamba2_forward``;
zamba2-7b: 81 times a prefill).  One CUDA block owns a (batch, head) and
carries its (P, N) float32 state through the chunks in order; it takes an
initial state, returns the final state itself, and takes a ragged L as the
plain version pads it (see the note at the top of the source).  The dtypes
pick the kernel inside the source: x, B and C all bfloat16 run the
tensor-core kernel (``mma.sync``), every other combination the float32
CUDA-core kernel.  Its plain-torch version is ``kernels.ref.ssd_chunked_ref``.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

MAX_P = 64
MAX_N = 64
MAX_CHUNK = 1024
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# Kernel launches since import; callers that count a run reset it to 0.
launches = 0


# ssd_scan_launch(x, dt, A, B, C, init, y, final_state, x_dtype, bc_dtype,
# B, L, H, P, N, Q, stream)
ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 8 + [ctypes.c_void_p]


@functools.lru_cache(maxsize=None)
def _lib():
    lib = _build.load("ssd_scan")
    fn = lib.ssd_scan_launch
    fn.argtypes = ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def ssd_scan_cuda(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                  B: torch.Tensor, C: torch.Tensor, *, chunk: int = 128,
                  initial_state: torch.Tensor | None = None,
                  return_state: bool = False):
    """x (B, L, H, P) and B, C (B, L, N) in float32 or bfloat16; dt (B, L, H),
    A (H,) and initial_state (B, H, P, N) in float32; all contiguous on one
    CUDA device.  Returns y (B, L, H, P) in x's dtype and, with
    ``return_state``, the final state (B, H, P, N) float32.  Raises on
    anything the kernel does not take: P or N above 64, chunk above 1024,
    inputs that require grad (there is no backward)."""
    global launches
    ts = [x, dt, A, B, C] + ([] if initial_state is None else [initial_state])
    if not all(t.is_cuda for t in ts) or len({t.device for t in ts}) != 1:
        raise ValueError("ssd_scan_cuda needs every input on one CUDA device")
    if x.dtype not in _DTYPES or B.dtype not in _DTYPES or B.dtype != C.dtype:
        raise TypeError(f"ssd_scan_cuda takes float32 or bfloat16 x and B, C "
                        f"(B and C of one dtype), got {x.dtype}, {B.dtype}, "
                        f"{C.dtype}")
    if any(t.dtype != torch.float32 for t in ts[1:3] + ts[5:]):
        raise TypeError("ssd_scan_cuda takes float32 dt, A and initial_state")
    if any(t.requires_grad for t in ts):
        raise ValueError("ssd_scan_cuda has no backward; call it on tensors "
                         "that do not require grad (ops.ssd_scan gives it "
                         "the plain version's)")
    if x.dim() != 4:
        raise ValueError(f"x {tuple(x.shape)} is not (B, L, H, P)")
    Bsz, L, H, P = x.shape
    N = B.shape[-1]
    if (tuple(dt.shape) != (Bsz, L, H) or tuple(A.shape) != (H,)
            or tuple(B.shape) != (Bsz, L, N) or B.shape != C.shape
            or (initial_state is not None
                and tuple(initial_state.shape) != (Bsz, H, P, N))):
        raise ValueError(
            f"shapes x {tuple(x.shape)}, dt {tuple(dt.shape)}, A "
            f"{tuple(A.shape)}, B {tuple(B.shape)}, C {tuple(C.shape)}"
            + ("" if initial_state is None else
               f", initial_state {tuple(initial_state.shape)}")
            + " are not (B, L, H, P), (B, L, H), (H,), (B, L, N) twice and "
              "(B, H, P, N)")
    if not (1 <= P <= MAX_P and 1 <= N <= MAX_N and 1 <= chunk <= MAX_CHUNK):
        raise ValueError(f"ssd_scan_cuda takes P <= {MAX_P}, N <= {MAX_N} and "
                         f"1 <= chunk <= {MAX_CHUNK}, got P={P}, N={N}, "
                         f"chunk={chunk}")
    if min(Bsz, L, H) < 1 or Bsz > 65535 or H > 2 ** 31 - 1:
        raise ValueError(f"ssd_scan_cuda takes 1 <= B <= 65535 and L, H >= 1, "
                         f"got B={Bsz}, L={L}, H={H}")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("ssd_scan_cuda needs contiguous inputs")
    y = torch.empty_like(x)
    final = (torch.empty((Bsz, H, P, N), dtype=torch.float32, device=x.device)
             if return_state else None)
    fn = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
                C.data_ptr(),
                None if initial_state is None else initial_state.data_ptr(),
                y.data_ptr(), None if final is None else final.data_ptr(),
                _DTYPES[x.dtype], _DTYPES[B.dtype], Bsz, L, H, P, N,
                int(chunk), stream)
    if rc != 0:
        raise RuntimeError(f"ssd_scan kernel launch failed: CUDA error {rc}")
    launches += 1
    return (y, final) if return_state else y
