"""The operation and byte counts, against shapes worked by hand."""
from __future__ import annotations

import pytest

from bench import harness, roofline, weights
from bench.families import dense, hybrid

TINY_DENSE = {"family": "dense", "n_layers": 2, "d_model": 8, "n_heads": 2,
              "n_kv_heads": 1, "d_ff": 16, "vocab_size": 32}
TINY_HYBRID = {"family": "hybrid", "n_layers": 2, "d_model": 4, "n_heads": 2,
               "n_kv_heads": 2, "d_ff": 8, "vocab_size": 10, "ssm_state": 2,
               "ssm_head_dim": 2, "ssm_expand": 2, "ssm_conv": 4,
               "ssm_chunk": 4, "hybrid_attn_every": 2}


def test_peaks_are_the_data_sheet_s():
    assert roofline.PEAK_BF16_FLOPS == 989e12
    assert roofline.PEAK_F32_FLOPS == 67e12
    assert roofline.PEAK_BYTES == 3.35e12


def test_least_time_is_the_larger_bound():
    assert roofline.least_s(989e12, 0.0) == pytest.approx(1.0)
    assert roofline.least_s(0.0, 6.7e12) == pytest.approx(2.0)
    assert roofline.least_s(67e12, 0.0, roofline.PEAK_F32_FLOPS) == \
        pytest.approx(1.0)


def test_causal_pairs():
    assert [roofline.causal_pairs(s) for s in (1, 2, 4)] == [1, 3, 10]


def test_flash_attention_counts():
    # B 2, S 4, 2 q heads over 1 kv head, D 8: 10 pairs a head; q k^T and
    # p v are 2 D multiply-adds a pair; q, o (2 heads) and k, v (1) once
    flops, n_bytes = roofline.flash_attention(2, 4, 2, 1, 8)
    assert flops == 4 * 8 * 10 * 2 * 2 == 1280
    assert n_bytes == 2 * 2 * 4 * 8 * (2 * 2 + 2 * 1) == 768


def test_ssd_scan_counts():
    # B 1, L 6, H 2, P 3, N 4, chunk 4: chunks of 4 and 2 rows
    flops, n_bytes = roofline.ssd_scan(1, 6, 2, 3, 4, 4)
    four = 4 * 4 * 4 + 2 * (4 * 4 * 3 + 4 * 4 * 3 * 4)
    two = 2 * 2 * 4 + 2 * (2 * 2 * 3 + 4 * 2 * 3 * 4)
    assert flops == four + two == 776
    # x read and y written (bf16), B and C (bf16), dt (f32), A (f32), the
    # final state (f32)
    assert n_bytes == 2 * 2 * 6 * 2 * 3 + 2 * 2 * 6 * 4 + 4 * 6 * 2 + 4 * 2 \
        + 4 * 2 * 3 * 4


def test_dense_prefill_counts():
    cfg = TINY_DENSE
    per_layer = 8 * (2 + 2 * 1) * 4 + 2 * 4 * 8 + 3 * 8 * 16 + 2 * 8
    assert dense.layer_weights(cfg) == 2 * per_layer
    flops, n_bytes = roofline.prefill(cfg, 3, 5)
    attn = 2 * (4 * 4 * 15 * 3 * 2)
    assert flops == 2 * 15 * 2 * per_layer + 2 * 3 * 8 * 32 + attn
    kv = 2 * 15 * 2 * 2 * 1 * 4
    assert n_bytes == 2 * (2 * per_layer + 8 * 32 + 15 * 8) + kv


def test_dense_decode_step_counts():
    cfg = TINY_DENSE
    per_layer = 8 * (2 + 2 * 1) * 4 + 2 * 4 * 8 + 3 * 8 * 16 + 2 * 8
    flops, n_bytes = roofline.decode_step(cfg, 3, 7)
    assert flops == 2 * 3 * (2 * per_layer + 8 * 32) + 2 * 4 * 4 * 2 * 3 * 7
    assert n_bytes == 2 * (2 * per_layer + 8 * 32 + 3 * 8) \
        + 2 * 3 * 7 * 2 * 2 * 1 * 4


def test_hybrid_decode_step_counts():
    # B 3, 7 valid positions in the shared block's one cache; 2 Mamba2
    # layers of 4 heads of P 2, N 2, conv channels C 12, K 4
    cfg = TINY_HYBRID
    di, H, P, N, C = 8, 4, 2, 2, 12
    mamba = 4 * (2 * di + 2 * N + H) + di * 4 + 4 * C + C + 3 * H + di + 4
    gqa = 4 * (2 + 2 * 2) * 2 + 2 * 2 * 4 + 3 * 4 * 8 + 2 * 4
    flops, n_bytes = roofline.decode_step(cfg, 3, 7)
    # a one-token scan a request and layer: C B^T (N), (C B^T) (dt x) (H P)
    # and the state's update and read-out (4 H P N)
    scan = 3 * (N + H * (P + 4 * P * N))
    assert scan == 222
    assert flops == 2 * 3 * (2 * mamba + gqa + 4 * 10) \
        + 4 * 2 * 2 * 3 * 7 + 2 * scan
    # the weights, the head and the B embedding rows; the valid keys and
    # values (2 kv heads of 2); each layer's float32 SSM state and bf16
    # last K - 1 conv inputs read and written
    state = 2 * 3 * (4 * H * P * N + 2 * 3 * C)
    assert n_bytes == 2 * (2 * mamba + gqa + 4 * 10 + 3 * 4) \
        + 3 * 7 * 2 * 2 * 2 * 2 + 2 * state


def test_hybrid_prefill_counts():
    cfg = TINY_HYBRID
    di, H, P, N, C = 8, 4, 2, 2, 12
    mamba = 4 * (2 * di + 2 * N + H) + di * 4 + 4 * C + C + 3 * H + di + 4
    gqa = 4 * (2 + 2 * 2) * 2 + 2 * 2 * 4 + 3 * 4 * 8 + 2 * 4
    assert hybrid.layer_weights(cfg) == 2 * mamba + gqa
    B, S = 2, 6
    flops, n_bytes = roofline.prefill(cfg, B, S)
    scan = 2 * roofline.ssd_scan(B, S, H, P, N, 4)[0]
    attn = roofline.flash_attention(B, S, 2, 2, 2)[0]
    assert flops == 2 * B * S * (2 * mamba + gqa) + 2 * B * 4 * 10 + attn \
        + scan
    state = 2 * B * (4 * H * P * N + 2 * 3 * C) + B * S * 2 * 2 * 2 * 2
    assert n_bytes == 2 * (2 * mamba + gqa + 4 * 10 + 10 * 4) + state


@pytest.mark.parametrize("name", ["zamba2-7b", "minitron-4b"])
def test_parameter_counts_agree_with_the_weights(name):
    cfg = harness.load("configs", name)
    assert roofline.n_params(cfg) == weights.n_params(cfg)


@pytest.mark.parametrize("name,want", [("zamba2-7b", 6_751_130_832),
                                       ("minitron-4b", 5_096_279_040)])
def test_full_configurations_hold_their_published_size(name, want):
    assert weights.n_params(harness.load("configs", name)) == want
