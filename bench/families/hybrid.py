"""The hybrid family (Zamba2): ``n_layers`` Mamba2 layers and one
weight-shared attention + SwiGLU block applied after every
``hybrid_attn_every``-th.  Its cache holds each Mamba2 layer's SSM state
and convolution inputs and each application's keys and values; a check
compares the keys and values at positions drawn from the seed and, where
the cell's sample names ``ssm_heads``, that many heads of the SSM state
(all of them otherwise)."""
from __future__ import annotations

from bench.families import dense, drawn
from bench.roofline import BF16, F32, ssd_scan
from bench.weights import matrix

PROGRAM_KEYS = dense.PROGRAM_KEYS
POSITIONS = "k"
CUT = ("ssm",)


def mamba_dims(cfg: dict) -> tuple[int, int, int, int, int]:
    """(inner width, heads, head width, state, conv channels)."""
    d, N, P = cfg["d_model"], cfg["ssm_state"], cfg["ssm_head_dim"]
    di = cfg["ssm_expand"] * d
    return di, di // P, P, N, di + 2 * N


def mamba_layer(pre: str, cfg: dict) -> dict:
    d, K = cfg["d_model"], cfg["ssm_conv"]
    di, H, P, N, C = mamba_dims(cfg)
    return {
        pre + "ln": ((d,), "norm", 0.1),
        pre + "mixer.w_in": matrix((d, 2 * di + 2 * N + H), d),
        pre + "mixer.conv_w": matrix((K, C), K),
        pre + "mixer.conv_b": ((C,), "normal", 0.1),
        pre + "mixer.A_log": ((H,), "A_log", None),
        pre + "mixer.D": ((H,), "ones", None),
        pre + "mixer.dt_bias": ((H,), "dt_bias", None),
        pre + "mixer.norm_w": ((di,), "norm", 0.1),
        pre + "mixer.w_out": matrix((di, d), di),
    }


def layers(cfg: dict) -> dict:
    out = {}
    for i in range(cfg["n_layers"]):
        out.update(mamba_layer(f"layers.{i}.", cfg))
    out.update(dense.gqa_layer("shared_attn.", cfg))
    return out


def picks(b, seed: int, c) -> dict:
    out = dense.picks(b, seed, c)
    if "ssm_heads" in c.sample:
        heads = mamba_dims(c.cfg)[1]
        out["ssm"] = drawn(heads, c.sample["ssm_heads"], 0, seed,
                           b.index + (1 << 43))
    return out


# ----------------------------- counts ----------------------------- #
def mamba_weights(cfg: dict) -> int:
    """Parameters of one Mamba2 layer."""
    d, K = cfg["d_model"], cfg["ssm_conv"]
    di, H, P, N, C = mamba_dims(cfg)
    return d * (2 * di + 2 * N + H) + di * d + K * C + C + 3 * H + di + d


def layer_weights(cfg: dict) -> int:
    """Parameters every token passes through, the embedding and the head
    left out."""
    return cfg["n_layers"] * mamba_weights(cfg) + dense.gqa_weights(cfg)


def n_attention(cfg: dict) -> int:
    return cfg["n_layers"] // cfg["hybrid_attn_every"]


def state_bytes(cfg: dict, B: int) -> int:
    """Bytes of the Mamba2 layers' decode state of B requests: the SSM
    state in float32, the convolution's last K - 1 inputs in bf16."""
    di, H, P, N, C = mamba_dims(cfg)
    return cfg["n_layers"] * B * (F32 * H * P * N
                                  + BF16 * (cfg["ssm_conv"] - 1) * C)


def prefill(cfg: dict, B: int, S: int) -> tuple[int, int]:
    """The attentions' prefill count, the chunked scan's operations from a
    zero state and the Mamba2 state it hands on, written once."""
    flops, n_bytes = dense.attention_prefill(cfg, B, S, layer_weights(cfg),
                                             n_attention(cfg))
    di, H, P, N, C = mamba_dims(cfg)
    scan, _ = ssd_scan(B, S, H, P, N, min(cfg["ssm_chunk"], S))
    return flops + cfg["n_layers"] * scan, n_bytes + state_bytes(cfg, B)


def decode_step(cfg: dict, B: int, valid: int) -> tuple[int, int]:
    """The attentions' decode count over the shared block's caches, each
    Mamba2 layer's one-token scan, and its state read and written once."""
    flops, n_bytes = dense.attention_decode(cfg, B, valid, layer_weights(cfg),
                                            n_attention(cfg))
    di, H, P, N, C = mamba_dims(cfg)
    scan, _ = ssd_scan(B, 1, H, P, N, 1)
    return (flops + cfg["n_layers"] * scan,
            n_bytes + 2 * state_bytes(cfg, B))


def n_params(cfg: dict) -> int:
    """Every parameter, the embedding and the head included."""
    return layer_weights(cfg) + (2 * cfg["vocab_size"] + 1) * cfg["d_model"]
