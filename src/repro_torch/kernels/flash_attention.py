"""GQA attention with an online softmax on the card: the wrapper of
``csrc/flash_attention.cu``.

The shared attention block of a hybrid model runs it in every prefill
(``models.attention.gqa_prefill``; zamba2-7b: 13 times a prefill).  The
dtype picks the kernel: bfloat16 runs on the tensor cores (``mma.sync``
with ``ldmatrix`` and ``cp.async``, FlashAttention-2's shape), float32 on
the CUDA cores, where it keeps full float32 products.  In both one CUDA
block owns a (batch, q head, 64-query tile) and loops over 64-key tiles,
skipping those outside the causal or window band (see the note at the top
of the source).  Its plain-torch version is ``kernels.ops.plain_attention``
(``ref.attention_ref`` up to 2048 keys, ``ref.attention_blocked`` above).
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from repro_torch.kernels import _build

MAX_D = 256
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# Kernel launches since import; callers that count a run reset it to 0.
launches = 0


# flash_attention_launch(q, k, v, o, dtype, B, Sq, Sk, Hq, Hkv, D, causal,
# window, q_offset, scale, stream)
ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 9 + [
    ctypes.c_longlong, ctypes.c_float, ctypes.c_void_p]


@functools.lru_cache(maxsize=None)
def _lib():
    lib = _build.load("flash_attention")
    fn = lib.flash_attention_launch
    fn.argtypes = ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                         causal: bool = True, window: int = 0,
                         q_offset: int = 0) -> torch.Tensor:
    """q (B, Sq, Hq, D), k and v (B, Sk, Hkv, D), one dtype (float32 or
    bfloat16), contiguous on one CUDA device -> (B, Sq, Hq, D) in q's
    dtype.  Raises on anything the kernel does not take: D not a multiple
    of 8 or above 256, Hq not a multiple of Hkv, an empty sequence, inputs
    that require grad (there is no backward), bfloat16 inputs that do not
    start 16-byte aligned."""
    global launches
    ts = (q, k, v)
    if not all(t.is_cuda for t in ts) or not (q.device == k.device == v.device):
        raise ValueError("flash_attention_cuda needs q, k and v on one CUDA "
                         "device")
    if q.dtype not in _DTYPES or not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"flash_attention_cuda takes float32 or bfloat16 q, "
                        f"k, v of one dtype, got {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    if any(t.requires_grad for t in ts):
        raise ValueError("flash_attention_cuda has no backward; call it on "
                         "tensors that do not require grad")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"shapes {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)} are not (B, Sq, Hq, D) and twice "
                         "(B, Sk, Hkv, D)")
    B, Sq, Hq, D = q.shape
    _, Sk, Hkv, Dk = k.shape
    if k.shape[0] != B or Dk != D:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} differ "
                         "in batch or head_dim")
    if not (D % 8 == 0 and 8 <= D <= MAX_D):
        raise ValueError(f"flash_attention_cuda takes head_dim a multiple of "
                         f"8 up to {MAX_D}, got {D}")
    if Hkv < 1 or Hq % Hkv:
        raise ValueError(f"flash_attention_cuda needs Hq % Hkv == 0, got "
                         f"Hq={Hq}, Hkv={Hkv}")
    if min(B, Sq, Sk) < 1 or B > 65535 or Hq > 65535 or window < 0:
        raise ValueError(f"flash_attention_cuda takes 1 <= B, Hq <= 65535, "
                         f"Sq, Sk >= 1 and window >= 0, got B={B}, Hq={Hq}, "
                         f"Sq={Sq}, Sk={Sk}, window={window}")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("flash_attention_cuda needs contiguous q, k and v")
    if q.dtype == torch.bfloat16 and any(t.data_ptr() % 16 for t in ts):
        raise ValueError("flash_attention_cuda copies bfloat16 rows 16 bytes "
                         "at a time: q, k and v must start 16-byte aligned")
    out = torch.empty_like(q)
    fn = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                _DTYPES[q.dtype], B, Sq, Sk, Hq, Hkv, D, int(bool(causal)),
                int(window), int(q_offset), float(1.0 / np.sqrt(D)), stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                           f"error {rc}")
    launches += 1
    return out
