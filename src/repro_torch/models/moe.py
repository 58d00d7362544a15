"""Feed-forward blocks: the dense SwiGLU MLP (``repro.models.moe.ffn_init``
and ``ffn_forward``).  Routed experts wait in ROADMAP.md."""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import swiglu
from repro_torch.models.params import InitCtx


class FFN(nn.Module):
    """w_gate, w_up (d, f) and w_down (f, d)."""

    def __init__(self, cfg: ModelConfig, ctx: InitCtx, d_ff: int | None = None):
        super().__init__()
        d, f = cfg.d_model, d_ff or cfg.d_ff
        self.w_gate = ctx.param("w_gate", (d, f))
        self.w_up = ctx.param("w_up", (d, f))
        self.w_down = ctx.param("w_down", (f, d))


def ffn_init(cfg: ModelConfig, ctx: InitCtx, d_ff: int | None = None) -> FFN:
    return FFN(cfg, ctx, d_ff)


def ffn_forward(p: FFN, x: torch.Tensor) -> torch.Tensor:
    return swiglu(x, p.w_gate, p.w_up, p.w_down)
