"""Peaks of one NVIDIA H100 SXM and the operations and bytes the served
work needs, counted from the configuration and the batch shapes alone, so
that they read the same whatever implements the work.

A least time is the larger of operations over the peak rate and bytes over
the memory bandwidth.  Bytes count each input read once and each output
written once.  Operations count matrix products, attention and the SSM
scan; elementwise work is left out.
"""
from __future__ import annotations


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


def _gqa_weights(cfg: dict) -> int:
    d, H, Hkv, f = cfg["d_model"], cfg["n_heads"], cfg["n_kv_heads"], cfg["d_ff"]
    hd = d // H
    return d * (H + 2 * Hkv) * hd + H * hd * d + 3 * d * f + 2 * d


def _mamba_dims(cfg: dict) -> tuple[int, int, int, int, int]:
    d, N, P = cfg["d_model"], cfg["ssm_state"], cfg["ssm_head_dim"]
    di = cfg["ssm_expand"] * d
    return di, di // P, P, N, di + 2 * N


def _mamba_weights(cfg: dict) -> int:
    d, K = cfg["d_model"], cfg["ssm_conv"]
    di, H, P, N, C = _mamba_dims(cfg)
    return d * (2 * di + 2 * N + H) + di * d + K * C + C + 3 * H + di + d


def layer_weights(cfg: dict) -> int:
    """Parameters every token passes through, the embedding and the head
    left out."""
    if cfg["family"] == "hybrid":
        return cfg["n_layers"] * _mamba_weights(cfg) + _gqa_weights(cfg)
    return cfg["n_layers"] * _gqa_weights(cfg)


def n_attention(cfg: dict) -> int:
    """Attention applications a forward makes."""
    if cfg["family"] == "hybrid":
        return cfg["n_layers"] // cfg["hybrid_attn_every"]
    return cfg["n_layers"]


def _kv_entry_bytes(cfg: dict) -> int:
    """Bytes of one position's keys and values in one attention's cache."""
    return 2 * BF16 * cfg["n_kv_heads"] * (cfg["d_model"] // cfg["n_heads"])


def prefill(cfg: dict, B: int, S: int) -> tuple[float, float]:
    """(operations, bytes) of a prefill of B prompts of S tokens that hands
    on the decode state and the last position's logits."""
    d, V, H, Hkv = cfg["d_model"], cfg["vocab_size"], cfg["n_heads"], \
        cfg["n_kv_heads"]
    hd = d // H
    gemm = 2 * B * S * layer_weights(cfg) + 2 * B * d * V
    attn = n_attention(cfg) * flash_attention(B, S, H, Hkv, hd)[0]
    weight_bytes = BF16 * (layer_weights(cfg) + d * V + min(B * S, V) * d)
    state_bytes = n_attention(cfg) * B * S * _kv_entry_bytes(cfg)
    scan = 0
    if cfg["family"] == "hybrid":
        di, Hs, P, N, C = _mamba_dims(cfg)
        f, _ = ssd_scan(B, S, Hs, P, N, min(cfg["ssm_chunk"], S))
        scan = cfg["n_layers"] * f
        state_bytes += cfg["n_layers"] * B * (
            F32 * Hs * P * N + BF16 * (cfg["ssm_conv"] - 1) * C)
    return gemm + attn + scan, weight_bytes + state_bytes


def decode_step(cfg: dict, B: int, valid: int) -> tuple[float, float]:
    """(operations, bytes) of one dense-family decode step for B requests
    whose caches hold ``valid`` positions once the step's own is written:
    the weights and the valid cache entries read once, the new entries
    written."""
    if cfg["family"] != "dense":
        raise ValueError("decode_step counts the dense family")
    d, V, H = cfg["d_model"], cfg["vocab_size"], cfg["n_heads"]
    hd = d // H
    n = n_attention(cfg)
    flops = 2 * B * (layer_weights(cfg) + d * V) + n * 4 * hd * H * B * valid
    n_bytes = (BF16 * (layer_weights(cfg) + d * V + B * d)
               + n * B * valid * _kv_entry_bytes(cfg))
    return flops, n_bytes


def n_params(cfg: dict) -> int:
    """Every parameter, the embedding and the head included."""
    return layer_weights(cfg) + (2 * cfg["vocab_size"] + 1) * cfg["d_model"]


