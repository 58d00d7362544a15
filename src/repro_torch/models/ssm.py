"""Mamba2 block (selective state space with the state-space-duality scan),
as ``repro.models.ssm``.

Prefill goes through ``kernels.ops.ssd_scan`` (the hand-written CUDA kernel
on the card) when ``cfg.use_kernel`` is set, else through the plain
``kernels.ref.ssd_chunked_ref``; decode is the plain one-token recurrence
``ref.ssd_decode_step`` on every device, as in the reference.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels import ops, ref
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import rms_norm
from repro_torch.models.params import InitCtx


class Mamba2(nn.Module):
    """w_in (d, 2 di + 2 N + H): the fused input projection [z, x, B, C,
    dt]; the depthwise causal conv (conv_w (K, conv_dim), conv_b); A_log,
    D, dt_bias (H,); the gated norm's norm_w (di,); w_out (di, d)."""

    def __init__(self, cfg: ModelConfig, ctx: InitCtx):
        super().__init__()
        d, di, N, H = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
        conv_dim = di + 2 * N
        self.w_in = ctx.param("w_in", (d, 2 * di + 2 * N + H))
        self.conv_w = ctx.param("conv_w", (cfg.ssm_conv, conv_dim), scale=0.5)
        self.conv_b = ctx.param("conv_b", (conv_dim,), init="zeros")
        self.A_log = ctx.param("A_log", (H,), init="zeros")
        self.D = ctx.param("D", (H,), init="ones")
        self.dt_bias = ctx.param("dt_bias", (H,), init="zeros")
        self.norm_w = ctx.param("norm_w", (di,), init="ones")
        self.w_out = ctx.param("w_out", (di, d))


def mamba2_init(cfg: ModelConfig, ctx: InitCtx) -> Mamba2:
    return Mamba2(cfg, ctx)


def _split_proj(cfg: ModelConfig, proj: torch.Tensor):
    di, N = cfg.d_inner, cfg.ssm_state
    z = proj[..., :di]
    xbc = proj[..., di:di + di + 2 * N]
    dt = proj[..., di + di + 2 * N:]
    return z, xbc, dt


def _causal_conv(xbc: torch.Tensor, w: torch.Tensor, b: torch.Tensor
                 ) -> torch.Tensor:
    """Depthwise causal conv1d over the sequence.  xbc: (B, L, Cdim).

    The reference's shifted sum, in its order, in the input's dtype (not
    ``F.conv1d``, which runs a float32 convolution in TF32 on the card)."""
    K = w.shape[0]
    L = xbc.shape[1]
    pad = F.pad(xbc, (0, 0, K - 1, 0))
    out = sum(pad[:, i:i + L, :] * w[i][None, None] for i in range(K))
    return F.silu(out + b[None, None])


def _dt_A(p: Mamba2, dt: torch.Tensor):
    dt = F.softplus(dt.float() + p.dt_bias.float())
    return dt, -torch.exp(p.A_log.float())


def _gate_out(p: Mamba2, y: torch.Tensor, z: torch.Tensor, cfg: ModelConfig
              ) -> torch.Tensor:
    y = rms_norm(y * F.silu(z), p.norm_w, cfg.norm_eps)
    return y @ p.w_out


def mamba2_forward(p: Mamba2, x: torch.Tensor, cfg: ModelConfig, *,
                   state: torch.Tensor | None = None,
                   conv_state: torch.Tensor | None = None,
                   return_state: bool = False):
    """Full-sequence Mamba2 block.  x: (B, L, d_model).  With
    ``return_state``: (out, final SSM state (B, H, P, N) f32, conv state
    (B, K-1, conv_dim), the last K-1 pre-conv inputs)."""
    di, N, H, P = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    B_, L, _ = x.shape
    proj = x @ p.w_in
    z, xbc_raw, dt = _split_proj(cfg, proj)
    xbc = _causal_conv(xbc_raw, p.conv_w, p.conv_b)
    xs = xbc[..., :di].reshape(B_, L, H, P).contiguous()
    Bm = xbc[..., di:di + N].contiguous()
    Cm = xbc[..., di + N:].contiguous()
    dt, A = _dt_A(p, dt)
    scan = ops.ssd_scan if cfg.use_kernel else ref.ssd_chunked_ref
    res = scan(xs, dt.contiguous(), A, Bm, Cm, chunk=min(cfg.ssm_chunk, L),
               initial_state=state, return_state=return_state)
    y, final = res if return_state else (res, None)
    y = y + xs * p.D.to(xs.dtype)[None, None, :, None]
    out = _gate_out(p, y.reshape(B_, L, di), z, cfg)
    if return_state:
        # the reference computes the same product again here; the pre-conv
        # inputs are those of ``proj``
        return out, final, xbc_raw[:, -(cfg.ssm_conv - 1):, :]
    return out


def mamba2_decode(p: Mamba2, x: torch.Tensor, cfg: ModelConfig,
                  state: torch.Tensor, conv_state: torch.Tensor):
    """Single-token recurrent step.

    x: (B, 1, d); state: (B, H, P, N); conv_state: (B, K-1, conv_dim).
    Returns (out, new_state, new_conv_state), new tensors.
    """
    di, N, H, P = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    B_ = x.shape[0]
    proj = x @ p.w_in
    z, xbc_raw, dt = _split_proj(cfg, proj)
    # streaming causal conv: window = [conv_state, current]
    win = torch.cat([conv_state, xbc_raw], dim=1)             # (B, K, Cdim)
    conv = torch.einsum("bkc,kc->bc", win, p.conv_w) + p.conv_b
    xbc = F.silu(conv)[:, None, :]
    xs = xbc[..., :di].reshape(B_, H, P)
    Bm = xbc[:, 0, di:di + N]
    Cm = xbc[:, 0, di + N:]
    dt1, A = _dt_A(p, dt[:, 0])
    y, new_state = ref.ssd_decode_step(state, xs, dt1, A, Bm, Cm)
    y = y + xs * p.D.to(xs.dtype)[None, :, None]
    out = _gate_out(p, y.reshape(B_, 1, di), z, cfg)
    return out, new_state, win[:, 1:, :]


def mamba2_state_init(cfg: ModelConfig, batch: int, *, device,
                      n: int | None = None) -> dict:
    """Zeroed decode state; with ``n``, ``n`` states stacked on a leading
    axis.  The SSM state is float32, the conv state the model's dtype."""
    di, N = cfg.d_inner, cfg.ssm_state
    lead = () if n is None else (n,)
    return {
        "ssm": torch.zeros(lead + (batch, cfg.ssm_heads, cfg.ssm_head_dim, N),
                           dtype=torch.float32, device=device),
        "conv": torch.zeros(lead + (batch, cfg.ssm_conv - 1, di + 2 * N),
                            dtype=cfg.dtype, device=device),
    }
