"""Best candidate per (request, surface) on the card: the wrapper of
``csrc/transfer_select.cu``.

Fleet admission predicts each request's demand from its cluster's stacked
surface lattices (``core.batched.SurfaceStack.best_candidates``): every
request x surface x candidate point is scored and the best candidate per
(request, surface) kept.  The CUDA kernel is a direct gather, one thread per
output pair (see the note at the top of the source).  Its plain-torch
version is ``kernels.ref.batched_predict_argmax_ref``.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

# Kernel launches since import; callers that count a run reset it to 0.
launches = 0


@functools.lru_cache(maxsize=None)
def _lib():
    lib = _build.load("transfer_select")
    fn = lib.transfer_select_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def batched_predict_argmax_cuda(values: torch.Tensor, idx: torch.Tensor
                                ) -> tuple[torch.Tensor, torch.Tensor]:
    """values (S, G) f32 lattices, idx (B, P) int32 flat candidate indices,
    both contiguous on one CUDA device -> (best (B, S) f32, argk (B, S)
    int32).  Raises on anything the kernel does not take: P = 0, and sizes
    of 2**31 elements or more."""
    global launches  # repro-lint: disable=DET103 -- a launch counter
    if not (values.is_cuda and idx.is_cuda) or values.device != idx.device:
        raise ValueError("batched_predict_argmax_cuda needs values and idx on "
                         "one CUDA device")
    if values.dtype != torch.float32 or idx.dtype != torch.int32:
        raise TypeError(f"batched_predict_argmax_cuda takes float32 values "
                        f"and int32 idx, got {values.dtype} and {idx.dtype}")
    if values.dim() != 2 or idx.dim() != 2:
        raise ValueError(f"shapes {tuple(values.shape)} and {tuple(idx.shape)}"
                         " are not (S, G) and (B, P)")
    S, G = values.shape
    B, P = idx.shape
    if P == 0:
        raise ValueError("batched_predict_argmax_cuda needs P >= 1 candidates")
    if S * G >= 2 ** 31 or B * S >= 2 ** 31 or B * P >= 2 ** 31:
        raise ValueError(f"batched_predict_argmax_cuda takes S*G, B*S and B*P "
                         f"below 2**31, got S={S}, G={G}, B={B}, P={P}")
    if not (values.is_contiguous() and idx.is_contiguous()):
        raise ValueError("batched_predict_argmax_cuda needs contiguous values "
                         "and idx")
    best = torch.empty((B, S), dtype=torch.float32, device=values.device)
    argk = torch.empty((B, S), dtype=torch.int32, device=values.device)
    if B == 0 or S == 0:
        return best, argk
    fn = _lib()
    with torch.cuda.device(values.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(values.data_ptr(), idx.data_ptr(), S, G, B, P,
                best.data_ptr(), argk.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"transfer_select kernel launch failed: CUDA error "
                           f"{rc}")
    launches += 1
    return best, argk
