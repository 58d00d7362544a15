"""Nearest-centroid assignment on the card: the wrapper of
``csrc/cluster_assign.cu``.

The offline clustering path's hot loop at million-row scale assigns every
log row to its nearest centroid; the additive refit routes refresh batches
of 512 entries or more the same way.  The CUDA kernel runs one thread per
point with the centroids staged in shared memory (see the note at the top of
the source).  Its plain-torch version is ``kernels.ref.cluster_assign_ref``.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

MAX_M = 64
MAX_D = 16

# Kernel launches since import; callers that count a run reset it to 0.
launches = 0


@functools.lru_cache(maxsize=None)
def _lib():
    lib = _build.load("cluster_assign")
    fn = lib.cluster_assign_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def cluster_assign_cuda(X: torch.Tensor, C: torch.Tensor
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """X (N, d) f32 points, C (M, d) f32 centroids, both contiguous on one
    CUDA device -> (labels (N,) int32, d2 (N,) f32).  Raises on anything
    the kernel does not take: M <= 64 and d <= 16."""
    global launches  # repro-lint: disable=DET103 -- a launch counter
    if not (X.is_cuda and C.is_cuda) or X.device != C.device:
        raise ValueError("cluster_assign_cuda needs X and C on one CUDA device")
    if X.dtype != torch.float32 or C.dtype != torch.float32:
        raise TypeError(f"cluster_assign_cuda takes float32, got "
                        f"{X.dtype} and {C.dtype}")
    if X.dim() != 2 or C.dim() != 2 or X.shape[1] != C.shape[1]:
        raise ValueError(f"shapes {tuple(X.shape)} and {tuple(C.shape)} are "
                         "not (N, d) and (M, d)")
    n, d = X.shape
    m = C.shape[0]
    if not (1 <= m <= MAX_M and 1 <= d <= MAX_D):
        raise ValueError(f"cluster_assign_cuda takes 1 <= M <= {MAX_M} and "
                         f"1 <= d <= {MAX_D}, got M={m}, d={d}")
    if n >= 2 ** 31:
        raise ValueError(f"cluster_assign_cuda takes N < 2**31, got {n}")
    if not (X.is_contiguous() and C.is_contiguous()):
        raise ValueError("cluster_assign_cuda needs contiguous X and C")
    labels = torch.empty(n, dtype=torch.int32, device=X.device)
    dist = torch.empty(n, dtype=torch.float32, device=X.device)
    if n == 0:
        return labels, dist
    fn = _lib()
    with torch.cuda.device(X.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(X.data_ptr(), C.data_ptr(), n, d, m, labels.data_ptr(),
                dist.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"cluster_assign kernel launch failed: CUDA error {rc}")
    launches += 1
    return labels, dist
