"""minitron-4b [dense]: 32L d_model=3072 24H (GQA kv=8) d_ff=9216
vocab=256000 -- pruned Nemotron [arXiv:2407.14679]."""
from repro_torch.models.config import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="minitron-4b", family="dense",
        n_layers=32, d_model=3072, n_heads=24, n_kv_heads=8,
        d_ff=9216, vocab_size=256000, rope_theta=10_000.0,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="minitron-4b-smoke", family="dense",
        n_layers=2, d_model=48, n_heads=3, n_kv_heads=1,
        d_ff=144, vocab_size=512, rope_theta=10_000.0,
    )
