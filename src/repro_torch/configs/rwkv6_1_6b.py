"""rwkv6-1.6b [ssm]: 24L d_model=2048 (attention-free) d_ff=7168
vocab=65536 -- RWKV6 "Finch" with data-dependent decay [arXiv:2404.05892]."""
from repro_torch.models.config import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="rwkv6-1.6b", family="ssm",
        n_layers=24, d_model=2048, n_heads=32, n_kv_heads=32,
        head_dim=64, d_ff=7168, vocab_size=65536,
        attn_type="none", rwkv=True,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="rwkv6-1.6b-smoke", family="ssm",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
        head_dim=16, d_ff=128, vocab_size=256,
        attn_type="none", rwkv=True, rwkv_chunk=8,
    )
