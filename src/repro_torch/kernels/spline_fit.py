"""Batched natural-cubic-spline fitting on the card: the wrapper of
``csrc/spline_fit.cu``.

The additive refit refits every touched (cluster, load-bin) surface at once,
which reduces to fitting R spline rows over one shared knot vector (see
``core.surfaces.fit_surfaces_batched``).  The CUDA kernel runs one thread per
row, each computing the knot-only Thomas factors in registers while its row
loads (see the note at the top of the source), and handles the degenerate
N = 1 and N = 2 itself.  Its
plain-torch version is ``kernels.ref.nat_spline_fit_ref``.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

MAX_N = 16

# Kernel launches since import; callers that count a run reset it to 0.
launches = 0


@functools.lru_cache(maxsize=None)
def _lib():
    lib = _build.load("spline_fit")
    fn = lib.spline_fit_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def nat_spline_fit_cuda(x: torch.Tensor, Y: torch.Tensor) -> torch.Tensor:
    """x (N,) f32 knots, Y (R, N) f32 rows, both contiguous on one CUDA
    device -> (R, max(N-1, 1), 4) f32 coefficients.  Raises on anything the
    kernel does not take: 1 <= N <= 16."""
    global launches  # repro-lint: disable=DET103 -- a launch counter
    if not (x.is_cuda and Y.is_cuda) or x.device != Y.device:
        raise ValueError("nat_spline_fit_cuda needs x and Y on one CUDA device")
    if x.dtype != torch.float32 or Y.dtype != torch.float32:
        raise TypeError(f"nat_spline_fit_cuda takes float32, got "
                        f"{x.dtype} and {Y.dtype}")
    if x.dim() != 1 or Y.dim() != 2 or Y.shape[1] != x.shape[0]:
        raise ValueError(f"shapes {tuple(x.shape)} and {tuple(Y.shape)} are "
                         "not (N,) and (R, N)")
    R, n = Y.shape
    if not 1 <= n <= MAX_N:
        raise ValueError(f"nat_spline_fit_cuda takes 1 <= N <= {MAX_N}, got {n}")
    if R >= 2 ** 31:
        raise ValueError(f"nat_spline_fit_cuda takes R < 2**31, got {R}")
    if not (x.is_contiguous() and Y.is_contiguous()):
        raise ValueError("nat_spline_fit_cuda needs contiguous x and Y")
    out = torch.empty((R, max(n - 1, 1), 4), dtype=torch.float32,
                      device=Y.device)
    if R == 0:
        return out
    fn = _lib()
    with torch.cuda.device(Y.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(x.data_ptr(), Y.data_ptr(), R, n, out.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"spline_fit kernel launch failed: CUDA error {rc}")
    launches += 1
    return out
