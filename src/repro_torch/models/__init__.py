"""The LM stack of the port: the hybrid Mamba2 + shared-attention family
(Zamba2), inference only.  Other families wait in ROADMAP.md."""
