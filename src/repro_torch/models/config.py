"""Model configuration schema, the field set of the JAX package's
``ModelConfig``, covering its ten architectures: the ``hybrid`` (and plain
``ssm``) family, RWKV6 (``rwkv``), the ``dense`` and ``moe`` families (GQA
or MLA attention), ``audio`` (codebook streams) and ``vlm`` (M-RoPE, the
vision stub)."""
from __future__ import annotations

import dataclasses
from typing import Any

import torch


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                     # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0               # 0 -> d_model // n_heads

    # attention
    attn_type: str = "gqa"          # gqa | mla | none
    qkv_bias: bool = False
    sliding_window: int = 0         # 0 -> full attention
    rope_theta: float = 500_000.0
    mrope: bool = False             # Qwen2-VL multimodal RoPE
    mrope_sections: tuple[int, int, int] = (16, 24, 24)

    # MoE
    n_experts: int = 0
    experts_per_token: int = 0
    n_shared_experts: int = 0
    moe_d_ff: int = 0
    first_k_dense: int = 0          # DeepSeek: first k layers stay dense
    capacity_factor: float = 1.25   # expert capacity slack (drops beyond)

    # MLA (DeepSeek-V3)
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_head_dim: int = 0
    qk_rope_head_dim: int = 0
    v_head_dim: int = 0

    # SSM (Mamba2)
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_conv: int = 4
    ssm_chunk: int = 256

    # hybrid (Zamba2): one weight-shared attention block applied every k
    # Mamba2 layers
    hybrid_attn_every: int = 0

    # RWKV6 (w clamped to [-RWKV_W_CLAMP, 0))
    rwkv: bool = False
    rwkv_chunk: int = 16
    rwkv_w_clamp: float = 4.0

    # audio (MusicGen): EnCodec codebooks
    n_codebooks: int = 0

    # VLM stub (Qwen2-VL): precomputed patch embeddings prepended
    vision_stub: bool = False
    n_patches: int = 256

    # numerics / system
    dtype: Any = torch.bfloat16
    remat: bool = True
    scan_layers: bool = True
    # None: the hand-written kernels on CUDA, the plain route on the CPU
    # (``device.resolve_use_kernel``)
    use_kernel: bool | None = None
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    # activation sharding of the residual stream, mesh-axis names for
    # (batch, seq, embed); read by nothing until ``dist/`` is ported
    act_spec: tuple | None = None

    def __post_init__(self):
        if self.head_dim == 0 and self.n_heads > 0:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)

    @property
    def d_inner(self) -> int:       # Mamba2 inner width
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def n_params_dense_est(self) -> int:
        """Rough parameter count (for MODEL_FLOPS = 6*N*D roofline maths)."""
        d, L = self.d_model, self.n_layers
        emb = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        if self.rwkv:
            per = d * d * 5 + d * self.d_ff * 2
            return L * per + emb
        if self.family in ("ssm", "hybrid"):
            di = self.d_inner
            per = d * (2 * di + 2 * self.ssm_state + self.ssm_heads) + di * d
            n = L * per + emb
            if self.hybrid_attn_every:
                hd = self.head_dim * self.n_heads
                n += d * hd * 2 + d * self.n_kv_heads * self.head_dim * 2 \
                    + d * self.d_ff * 3
            return n
        hd = self.head_dim
        attn = d * (self.n_heads * hd) + 2 * d * (self.n_kv_heads * hd) \
            + (self.n_heads * hd) * d
        if self.attn_type == "mla":
            attn = (d * self.q_lora_rank
                    + self.q_lora_rank * self.n_heads
                    * (self.qk_nope_head_dim + self.qk_rope_head_dim)
                    + d * (self.kv_lora_rank + self.qk_rope_head_dim)
                    + self.kv_lora_rank * self.n_heads
                    * (self.qk_nope_head_dim + self.v_head_dim)
                    + self.n_heads * self.v_head_dim * d)
        ffn_dense = 3 * d * self.d_ff
        n = emb
        for layer in range(L):
            n += attn
            if self.n_experts and layer >= self.first_k_dense:
                n += 3 * d * self.moe_d_ff * (self.n_experts
                                              + self.n_shared_experts)
                n += d * self.n_experts          # router
            else:
                n += ffn_dense
        return n
