"""The dense GQA family (Minitron): ``n_layers`` pre-norm layers, each a
GQA attention with rotary positions and a SwiGLU MLP.  Its cache holds
each layer's keys and values; a check compares them at positions drawn
from the seed."""
from __future__ import annotations

from bench.families import drawn
from bench.roofline import BF16, flash_attention
from bench.weights import matrix

PROGRAM_KEYS = ("name", "family", "n_layers", "d_model", "n_heads",
                "n_kv_heads", "d_ff", "vocab_size", "ssm_state",
                "ssm_head_dim", "ssm_expand", "ssm_conv", "ssm_chunk",
                "hybrid_attn_every", "rope_theta", "norm_eps")
POSITIONS = "k"
CUT = ()


def gqa_layer(pre: str, cfg: dict) -> dict:
    """The leaves of one attention + SwiGLU layer under ``pre``."""
    d, H, Hkv, f = cfg["d_model"], cfg["n_heads"], cfg["n_kv_heads"], cfg["d_ff"]
    hd = d // H
    return {
        pre + "ln1": ((d,), "norm", 0.1),
        pre + "ln2": ((d,), "norm", 0.1),
        pre + "attn.wq": matrix((d, H, hd), d),
        pre + "attn.wk": matrix((d, Hkv, hd), d),
        pre + "attn.wv": matrix((d, Hkv, hd), d),
        pre + "attn.wo": matrix((H, hd, d), H * hd),
        pre + "ffn.w_gate": matrix((d, f), d),
        pre + "ffn.w_up": matrix((d, f), d),
        pre + "ffn.w_down": matrix((f, d), f),
    }


def layers(cfg: dict) -> dict:
    out = {}
    for i in range(cfg["n_layers"]):
        out.update(gqa_layer(f"layers.{i}.", cfg))
    return out


def picks(b, seed: int, c) -> dict:
    """``c.sample["kv_positions"]`` cache positions of the keys and values:
    the last half of them and the rest drawn from the seed."""
    n = c.sample["kv_positions"]
    pos = drawn(b.length, n, n // 2, seed, b.index + (1 << 40))
    return {"k": pos, "v": pos}


# ----------------------------- counts ----------------------------- #
def gqa_weights(cfg: dict) -> int:
    """Parameters of one attention + SwiGLU layer."""
    d, H, Hkv, f = cfg["d_model"], cfg["n_heads"], cfg["n_kv_heads"], cfg["d_ff"]
    hd = d // H
    return d * (H + 2 * Hkv) * hd + H * hd * d + 3 * d * f + 2 * d


def layer_weights(cfg: dict) -> int:
    """Parameters every token passes through, the embedding and the head
    left out."""
    return cfg["n_layers"] * gqa_weights(cfg)


def n_attention(cfg: dict) -> int:
    """Attention applications a forward makes."""
    return cfg["n_layers"]


def kv_entry_bytes(cfg: dict) -> int:
    """Bytes of one position's keys and values in one attention's cache."""
    return 2 * BF16 * cfg["n_kv_heads"] * (cfg["d_model"] // cfg["n_heads"])


def attention_prefill(cfg: dict, B: int, S: int, weights: int, n_attn: int
                      ) -> tuple[int, int]:
    """(operations, bytes) of a prefill of B prompts of S tokens through
    ``weights`` parameters a token and ``n_attn`` GQA attentions, that
    hands on their keys and values and the last position's logits."""
    d, V, H, Hkv = cfg["d_model"], cfg["vocab_size"], cfg["n_heads"], \
        cfg["n_kv_heads"]
    hd = d // H
    gemm = 2 * B * S * weights + 2 * B * d * V
    attn = n_attn * flash_attention(B, S, H, Hkv, hd)[0]
    weight_bytes = BF16 * (weights + d * V + min(B * S, V) * d)
    state_bytes = n_attn * B * S * kv_entry_bytes(cfg)
    return gemm + attn, weight_bytes + state_bytes


def attention_decode(cfg: dict, B: int, valid: int, weights: int,
                     n_attn: int) -> tuple[int, int]:
    """(operations, bytes) of one decode step for B requests through
    ``weights`` parameters a token and ``n_attn`` GQA attentions whose
    caches hold ``valid`` positions once the step's own is written: the
    weights and the valid cache entries read once, the new entries
    written."""
    d, V, H = cfg["d_model"], cfg["vocab_size"], cfg["n_heads"]
    hd = d // H
    flops = 2 * B * (weights + d * V) + n_attn * 4 * hd * H * B * valid
    n_bytes = (BF16 * (weights + d * V + B * d)
               + n_attn * B * valid * kv_entry_bytes(cfg))
    return flops, n_bytes


def prefill(cfg: dict, B: int, S: int) -> tuple[int, int]:
    return attention_prefill(cfg, B, S, layer_weights(cfg), n_attention(cfg))


def decode_step(cfg: dict, B: int, valid: int) -> tuple[int, int]:
    return attention_decode(cfg, B, valid, layer_weights(cfg),
                            n_attention(cfg))


def n_params(cfg: dict) -> int:
    """Every parameter, the embedding and the head included."""
    return layer_weights(cfg) + (2 * cfg["vocab_size"] + 1) * cfg["d_model"]
