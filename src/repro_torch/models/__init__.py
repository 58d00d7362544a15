"""The LM stack of the port: the hybrid Mamba2 + shared-attention family
(Zamba2) and the RWKV6 family, inference only.  Other families wait in
ROADMAP.md."""
