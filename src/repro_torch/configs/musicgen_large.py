"""musicgen-large [audio]: 48L d_model=2048 32H d_ff=8192 vocab=2048 --
decoder-only transformer over 4 EnCodec codebook streams
[arXiv:2306.05284].  The EnCodec frontend is a stub, as in the reference:
the model takes precomputed codebook token ids (B, S, 4), sums the 4
streams' embeddings and gives each stream its own logits."""
from repro_torch.models.config import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="musicgen-large", family="audio",
        n_layers=48, d_model=2048, n_heads=32, n_kv_heads=32,
        d_ff=8192, vocab_size=2048, n_codebooks=4, rope_theta=10_000.0,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="musicgen-large-smoke", family="audio",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
        d_ff=128, vocab_size=64, n_codebooks=4, rope_theta=10_000.0,
    )
