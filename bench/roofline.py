"""Peaks of one NVIDIA H100 SXM and the operations and bytes the served
work needs, counted from the configuration and the batch shapes alone, so
that they read the same whatever implements the work.

A least time is the larger of operations over the peak rate and bytes over
the memory bandwidth.  Bytes count each input read once and each output
written once.  Operations count matrix products, attention and the SSM
scan; elementwise work is left out.  The shared pieces are here; what a
family's layers count is its module's (``bench.families``).
"""
from __future__ import annotations

from bench import families

# NVIDIA's data sheet, H100 SXM, dense rates, at the 700 W power limit
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
BF16 = 2
F32 = 4


def least_s(flops: float, n_bytes: float, peak: float = PEAK_BF16_FLOPS
            ) -> float:
    return max(flops / peak, n_bytes / PEAK_BYTES)


def causal_pairs(S: int) -> int:
    """(query, key) pairs of a causal S x S attention."""
    return S * (S + 1) // 2


def flash_attention(B: int, S: int, Hq: int, Hkv: int, D: int,
                    elt: int = BF16) -> tuple[float, float]:
    """(operations, bytes) of one causal prefill attention launch: q k^T and
    p v over the causal half; q, k, v read and o written once."""
    flops = 4 * D * causal_pairs(S) * B * Hq
    n_bytes = elt * B * S * D * (2 * Hq + 2 * Hkv)
    return flops, n_bytes


def ssd_scan(B: int, L: int, H: int, P: int, N: int, chunk: int,
             elt: int = BF16) -> tuple[float, float]:
    """(operations, bytes) of one chunked SSD launch from a zero state that
    returns its final state: per chunk of q rows, C B^T over the causal
    half, the causal (C B^T * decay) (dt x) per head, and the chunk's state
    update and its read-out (2 q P N each); x, B, C read and y written in
    ``elt`` bytes, dt and the final state in float32."""
    lens = [min(chunk, L - t) for t in range(0, L, chunk)]
    flops = B * sum(q * q * N + H * (q * q * P + 4 * q * P * N)
                    for q in lens)
    n_bytes = (elt * 2 * B * L * H * P + elt * 2 * B * L * N
               + F32 * B * L * H + F32 * H + F32 * B * H * P * N)
    return flops, n_bytes


def prefill(cfg: dict, B: int, S: int) -> tuple[float, float]:
    """(operations, bytes) of a prefill of B prompts of S tokens that hands
    on the decode state and the last position's logits."""
    return families.of(cfg).prefill(cfg, B, S)


def decode_step(cfg: dict, B: int, valid: int) -> tuple[float, float]:
    """(operations, bytes) of one decode step for B requests whose caches
    hold ``valid`` positions once the step's own is written."""
    return families.of(cfg).decode_step(cfg, B, valid)


def n_attention(cfg: dict) -> int:
    """Attention applications a forward makes."""
    return families.of(cfg).n_attention(cfg)


def n_params(cfg: dict) -> int:
    """Every parameter, the embedding and the head included."""
    return families.of(cfg).n_params(cfg)
