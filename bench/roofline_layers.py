"""Operations and bytes of single layers of the served work, counted from
the configuration and the batch shapes alone (as ``bench.roofline``
counts whole steps), for the shares that read device time under the
program's spans (``bench.spans``).  Bytes count each input read once and
each output written once; elementwise work is left out of operations."""
from __future__ import annotations

from bench.roofline import BF16, F32, ssd_scan


def decode_attention(B: int, valid: int, Hq: int, Hkv: int, D: int
                     ) -> tuple[float, float]:
    """(operations, bytes) of one attention of a decode step over B
    requests whose caches hold ``valid`` positions: q k^T and p v over the
    valid keys; the valid keys and values read once in bf16, q read and o
    written."""
    flops = 4 * D * Hq * B * valid
    n_bytes = BF16 * (2 * B * valid * Hkv * D + 2 * B * Hq * D)
    return flops, n_bytes


def mamba2_mixer(cfg: dict, B: int, S: int) -> tuple[float, float]:
    """(operations, bytes) of one Mamba2 mixer over B prompts of S tokens,
    ``w_in`` to ``w_out``: the two products and ``ssd_scan``'s operations;
    the weights, the input and the output in bf16 and the state it hands
    on (the SSM state in float32, the conv's last K - 1 inputs in bf16)."""
    d, N, P, K = cfg["d_model"], cfg["ssm_state"], cfg["ssm_head_dim"], \
        cfg["ssm_conv"]
    di = cfg["ssm_expand"] * d
    H, C = di // P, di + 2 * N
    n_in = 2 * di + 2 * N + H
    scan, _ = ssd_scan(B, S, H, P, N, min(cfg["ssm_chunk"], S))
    flops = 2 * B * S * d * (n_in + di) + scan
    weights = d * n_in + di * d + K * C + C + 3 * H + di
    n_bytes = (BF16 * (weights + 2 * B * S * d)
               + F32 * B * H * P * N + BF16 * B * (K - 1) * C)
    return flops, n_bytes


def rms_norm(rows: int, d: int) -> tuple[float, float]:
    """(operations, bytes) of one RMSNorm over ``rows`` rows of d: the
    input read and the output written in bf16, the weight read once."""
    return 0.0, BF16 * (2 * rows * d + d)
