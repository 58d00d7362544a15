"""Single-token GQA attention against a KV cache on the card, split over the
keys: the wrapper of ``csrc/decode_attention.cu``.

Every GQA decode step runs it under ``cfg.use_kernel``
(``models.attention.gqa_decode``): each layer of the dense, MoE, audio and
vision-language stacks, and the hybrid's shared block.  It reads each valid
key and value of the cache once, in the cache's dtype, and keeps every
product, the softmax and the sums in float32, as the plain version
(``kernels.ops.decode_attention``) does after casting the whole cache; only
the order of the sums differs.  The valid slots are the prefix
``[0, n_valid)`` of the cache, ``n_valid`` a one-element int32 tensor that
stays on the device, so a call never waits for the card and a CUDA graph
can capture it.  A block takes a chunk of keys of one (request, kv head);
``split_chunk`` picks the chunk from the shapes, and a second launch merges
the chunks.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from repro_torch.kernels import _build

MAX_D = 256
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# the keys a block may take, the widest first
CHUNKS = (256, 128, 64)
# blocks an SM that the grid should offer before a chunk is narrowed
BLOCKS_PER_SM = 4

# Calls since import (each launches the split kernel and the merge); callers
# that count a run reset it to 0.
launches = 0

_I, _P, _LL = ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong
# decode_attention_launch(q, k, v, n_valid, o, part, dtype, B, L, Hq, Hkv, D,
# q_sb, q_sh, kv_sb, kv_sl, kv_sh, chunk, sqrt_d, stream)
ARGTYPES = [_P] * 6 + [_I] * 6 + [_LL] * 5 + [_I, ctypes.c_float, _P]


@functools.lru_cache(maxsize=None)
def _lib():
    lib = _build.load("decode_attention")
    lib.decode_attention_launch.argtypes = ARGTYPES
    lib.decode_attention_launch.restype = _I
    return lib


@functools.lru_cache(maxsize=None)
def _n_sm(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def split_chunk(B: int, L: int, Hkv: int, n_sm: int) -> int:
    """The keys a block takes: the widest of ``CHUNKS`` at which the
    (request, kv head) pairs times the chunks of the L reserved slots give
    each of the ``n_sm`` SMs ``BLOCKS_PER_SM`` blocks or more, else the
    narrowest."""
    for chunk in CHUNKS[:-1]:
        if B * Hkv * -(-L // chunk) >= BLOCKS_PER_SM * n_sm:
            return chunk
    return CHUNKS[-1]


def decode_attention_cuda(q: torch.Tensor, k_cache: torch.Tensor,
                          v_cache: torch.Tensor, n_valid: torch.Tensor
                          ) -> torch.Tensor:
    """q (B, 1, Hq, D), caches (B, L, Hkv, D) of q's dtype (float32 or
    bfloat16), taken as they are strided (1 along D; one layout for both),
    ``n_valid`` a one-element int32 tensor, all on one CUDA device ->
    (B, 1, Hq, D) in q's dtype: attention over the slots ``[0, n_valid)``
    (``n_valid`` above L counts as L; below 1 no slot is valid, and all L
    weigh the same, as in the plain version).  Raises on anything the
    kernel does not take: D not a multiple of 8 or above 256, Hq not a
    multiple of Hkv, inputs that require grad, caches whose rows do not
    start 16-byte aligned."""
    global launches  # repro-lint: disable=DET103 -- a launch counter
    k, v = k_cache, v_cache
    ts = (q, k, v, n_valid)
    if not all(t.is_cuda for t in ts) or len({t.device for t in ts}) != 1:
        raise ValueError("decode_attention_cuda needs q, the caches and "
                         "n_valid on one CUDA device")
    if q.dtype not in _DTYPES or not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"decode_attention_cuda takes float32 or bfloat16 "
                        f"q and caches of one dtype, got {q.dtype}, "
                        f"{k.dtype}, {v.dtype}")
    if n_valid.dtype != torch.int32 or n_valid.numel() != 1:
        raise TypeError(f"n_valid must be one int32, got {n_valid.dtype} "
                        f"of shape {tuple(n_valid.shape)}")
    if any(t.requires_grad for t in (q, k, v)):
        raise ValueError("decode_attention_cuda has no backward; call it on "
                         "tensors that do not require grad")
    if q.dim() != 4 or q.shape[1] != 1 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"shapes {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)} are not (B, 1, Hq, D) and twice "
                         "(B, L, Hkv, D)")
    B, _, Hq, D = q.shape
    _, L, Hkv, Dk = k.shape
    if k.shape[0] != B or Dk != D:
        raise ValueError(f"q {tuple(q.shape)} and the caches "
                         f"{tuple(k.shape)} differ in batch or head_dim")
    if not (D % 8 == 0 and 8 <= D <= MAX_D):
        raise ValueError(f"decode_attention_cuda takes head_dim a multiple "
                         f"of 8 up to {MAX_D}, got {D}")
    if Hkv < 1 or Hq % Hkv or not 1 <= B <= 65535 or L < 1:
        raise ValueError(f"decode_attention_cuda needs Hq % Hkv == 0, "
                         f"1 <= B <= 65535 and L >= 1, got Hq={Hq}, "
                         f"Hkv={Hkv}, B={B}, L={L}")
    if q.stride(3) != 1 or k.stride(3) != 1 or k.stride() != v.stride():
        raise ValueError("decode_attention_cuda needs unit strides along D "
                         "and one layout for both caches")
    per_unit = 16 // k.element_size()
    if any(t.data_ptr() % 16 for t in (k, v)) or any(
            s % per_unit for s in k.stride()[:3]):
        raise ValueError("decode_attention_cuda copies the caches 16 bytes "
                         "at a time: each row must start 16-byte aligned")
    chunk = split_chunk(B, L, Hkv, _n_sm(q.device.index))
    n_chunks = -(-L // chunk)
    out = torch.empty((B, 1, Hq, D), dtype=q.dtype, device=q.device)
    part = torch.empty(B * Hq * n_chunks * (D + 2), dtype=torch.float32,
                       device=q.device)
    lib = _lib()
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), n_valid.data_ptr(),
            out.data_ptr(), part.data_ptr())
    shape = (_DTYPES[q.dtype], B, L, Hq, Hkv, D, q.stride(0), q.stride(2),
             *k.stride()[:3], chunk, float(np.float32(np.sqrt(D))))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.decode_attention_launch(*ptrs, *shape, stream)
    if rc != 0:
        raise RuntimeError(f"decode_attention kernel launch failed: CUDA "
                           f"error {rc}")
    launches += 1
    return out
