"""qwen2-vl-2b [vlm]: 28L d_model=1536 12H (GQA kv=2) d_ff=8960
vocab=151936 -- M-RoPE, dynamic resolution [arXiv:2409.12191].  The vision
tower is a stub, as in the reference: precomputed patch embeddings replace
the first n_patches sequence positions."""
from repro_torch.models.config import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="qwen2-vl-2b", family="vlm",
        n_layers=28, d_model=1536, n_heads=12, n_kv_heads=2,
        d_ff=8960, vocab_size=151936, qkv_bias=True,
        mrope=True, mrope_sections=(16, 24, 24), rope_theta=1_000_000.0,
        vision_stub=True, n_patches=256,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="qwen2-vl-2b-smoke", family="vlm",
        n_layers=2, d_model=48, n_heads=3, n_kv_heads=1, head_dim=16,
        d_ff=96, vocab_size=256, qkv_bias=True,
        mrope=True, mrope_sections=(2, 3, 3), rope_theta=1_000_000.0,
        vision_stub=True, n_patches=8,
    )
