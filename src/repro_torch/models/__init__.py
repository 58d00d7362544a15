"""The LM stack of the port, for serving and training: the hybrid Mamba2 +
shared-attention family (Zamba2), RWKV6, the dense and MoE families (GQA
or MLA attention), the audio family (codebook streams) and the
vision-language family (M-RoPE, the vision stub)."""
