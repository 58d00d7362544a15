"""zamba2-7b [hybrid]: 81L d_model=3584 32H (shared attention blocks)
d_ff=14336 vocab=32000, ssm_state=64 -- Mamba2 backbone with a weight-shared
attention(+MLP) block applied every 6 layers [arXiv:2411.15242]."""
from repro_torch.models.config import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="zamba2-7b", family="hybrid",
        n_layers=81, d_model=3584, n_heads=32, n_kv_heads=32,
        d_ff=14336, vocab_size=32000,
        ssm_state=64, ssm_head_dim=64, ssm_expand=2,
        hybrid_attn_every=6, rope_theta=10_000.0,
        scan_layers=True,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="zamba2-7b-smoke", family="hybrid",
        n_layers=4, d_model=64, n_heads=4, n_kv_heads=4,
        d_ff=128, vocab_size=256,
        ssm_state=16, ssm_head_dim=16, ssm_expand=2,
        hybrid_attn_every=2, rope_theta=10_000.0,
        scan_layers=False, ssm_chunk=8,
    )
