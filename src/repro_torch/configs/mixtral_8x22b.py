"""mixtral-8x22b [moe]: 56L d_model=6144 48H (GQA kv=8) d_ff=16384 (per
expert) vocab=32768 -- 8 experts top-2, sliding-window attention
[arXiv:2401.04088]."""
from repro_torch.models.config import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="mixtral-8x22b", family="moe",
        n_layers=56, d_model=6144, n_heads=48, n_kv_heads=8,
        d_ff=16384, vocab_size=32768,
        n_experts=8, experts_per_token=2, moe_d_ff=16384,
        sliding_window=4096, rope_theta=1_000_000.0,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="mixtral-8x22b-smoke", family="moe",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=128, vocab_size=256,
        n_experts=4, experts_per_token=2, moe_d_ff=128,
        sliding_window=32, rope_theta=1_000_000.0,
        capacity_factor=8.0,
    )
