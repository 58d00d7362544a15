"""GQA attention with an online softmax on the card: the wrapper of
``csrc/flash_attention.cu``.

Every attention prefill of the LM stacks runs it: the hybrid's shared block
(``models.attention.gqa_prefill``; zamba2-7b: 13 times a prefill), each
GQA layer of the dense and MoE stacks, and each MLA layer
(``mla_prefill``, at q-k width 192 with v padded to it).  The dtype picks
the kernel: bfloat16 runs on the tensor cores (``mma.sync`` with
``ldmatrix`` and ``cp.async``, FlashAttention-2's shape), float32 on the
CUDA cores, where it keeps full float32 products.  In both one CUDA block
owns a (batch, q head, 64-query tile) and loops over 64-key tiles,
skipping those outside the causal or window band (see the note at the top
of the source).  The bfloat16 kernel is compiled for head widths of 16 KD
columns, KD in ``BF16_INSTANCES``; D takes the narrowest that holds it, a
power of two but for 7 and 12 (``last_instance`` reads the one a launch
took), and ``instance=`` forces a wider one.  Its plain-torch version is
``kernels.ops.plain_attention``
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
# the bfloat16 kernel's compiled widths, in 16-column groups of D
BF16_INSTANCES = (1, 2, 4, 7, 8, 12, 16)

# Kernel launches since import; callers that count a run reset it to 0.
launches = 0

_I, _P = ctypes.c_int, ctypes.c_void_p
# flash_attention_launch(q, k, v, o, dtype, B, Sq, Sk, Hq, Hkv, D, causal,
# window, q_offset, scale, stream) and
# flash_attention_launch_bf16_instance(q, k, v, o, B, Sq, Sk, Hq, Hkv, D,
# causal, window, q_offset, scale, kd, stream)
ARGTYPES = [_P] * 4 + [_I] * 9 + [ctypes.c_longlong, ctypes.c_float, _P]
INSTANCE_ARGTYPES = [_P] * 4 + [_I] * 8 + [ctypes.c_longlong,
                                           ctypes.c_float, _I, _P]


@functools.lru_cache(maxsize=None)
def _lib():
    lib = _build.load("flash_attention")
    for name, args in (("flash_attention_launch", ARGTYPES),
                       ("flash_attention_launch_bf16_instance",
                        INSTANCE_ARGTYPES),
                       ("flash_attention_last_instance", [])):
        getattr(lib, name).argtypes = args
        getattr(lib, name).restype = _I
    return lib


def last_instance() -> int:
    """The instance of the last bfloat16 launch the library took (0 before
    any), as the compiled code recorded it."""
    return _lib().flash_attention_last_instance()


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                         causal: bool = True, window: int = 0,
                         q_offset: int = 0, instance: int | None = None
                         ) -> torch.Tensor:
    """q (B, Sq, Hq, D), k and v (B, Sk, Hkv, D), one dtype (float32 or
    bfloat16), contiguous on one CUDA device -> (B, Sq, Hq, D) in q's
    dtype.  Raises on anything the kernel does not take: D not a multiple
    of 8 or above 256, Hq not a multiple of Hkv, an empty sequence, inputs
    that require grad (there is no backward), bfloat16 inputs that do not
    start 16-byte aligned.  ``instance`` (bfloat16 only): run the kernel
    compiled for that many 16-column groups, one of ``BF16_INSTANCES``
    holding D, instead of the one D picks."""
    global launches  # repro-lint: disable=DET103 -- a launch counter
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
                         "tensors that do not require grad (ops."
                         "flash_attention gives it the plain version's)")
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
    if instance is not None and (q.dtype != torch.bfloat16 or instance
                                 not in BF16_INSTANCES or 16 * instance < D):
        raise ValueError(f"instance {instance} is not a bfloat16 instance "
                         f"of {BF16_INSTANCES} holding D = {D} ({q.dtype})")
    out = torch.empty_like(q)
    lib = _lib()
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr())
    shape = (B, Sq, Sk, Hq, Hkv, D, int(bool(causal)), int(window),
             int(q_offset), float(1.0 / np.sqrt(D)))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        if instance is None:
            rc = lib.flash_attention_launch(*ptrs, _DTYPES[q.dtype], *shape,
                                            stream)
        else:
            rc = lib.flash_attention_launch_bf16_instance(*ptrs, *shape,
                                                          instance, stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                           f"error {rc}")
    launches += 1
    return out
