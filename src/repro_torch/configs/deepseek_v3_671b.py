"""deepseek-v3-671b [moe]: 61L d_model=7168 128H d_ff(dense)=18432
d_ff(moe)=2048 vocab=129280 -- MLA (q_lora 1536 / kv_lora 512, heads of
128 + 64 RoPE for q and k, 128 for v), 1 shared + 256 routed experts, top
8 by a sigmoid gate, the first 3 layers dense [arXiv:2412.19437].

The multi-token-prediction (MTP) head of the paper is a training objective
and is not modeled, as in the reference."""
from repro_torch.models.config import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v3-671b", family="moe",
        n_layers=61, d_model=7168, n_heads=128, n_kv_heads=128,
        d_ff=18432, vocab_size=129280,
        attn_type="mla", q_lora_rank=1536, kv_lora_rank=512,
        qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128,
        head_dim=192,
        n_experts=256, experts_per_token=8, n_shared_experts=1,
        moe_d_ff=2048, first_k_dense=3, rope_theta=10_000.0,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v3-smoke", family="moe",
        n_layers=3, d_model=64, n_heads=4, n_kv_heads=4,
        d_ff=160, vocab_size=256,
        attn_type="mla", q_lora_rank=32, kv_lora_rank=16,
        qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16,
        head_dim=24,
        n_experts=8, experts_per_token=2, n_shared_experts=1,
        moe_d_ff=32, first_k_dense=1, rope_theta=10_000.0,
        capacity_factor=8.0,
    )
