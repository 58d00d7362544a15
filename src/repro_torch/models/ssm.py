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
from repro_torch.trace import span


class Mamba2(nn.Module):
    """w_in (d, 2 di + 2 N + H): the fused input projection [z, x, B, C,
    dt]; the depthwise causal conv (conv_w (K, conv_dim), conv_b); A_log,
    D, dt_bias (H,); the gated norm's norm_w (di,); w_out (di, d).  ``tp``:
    None, or where the heads split over a mesh's ``model`` axis
    (``dist.tensor_parallel.MambaSplit``): the rank's block of each
    segment of w_in's and the conv's ``inner`` dim, of norm_w and w_out."""

    def __init__(self, cfg: ModelConfig, ctx: InitCtx):
        super().__init__()
        self.tp = None
        d, di, N, H = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
        conv_dim = di + 2 * N
        self.w_in = ctx.param("w_in", (d, 2 * di + 2 * N + H),
                              ("embed", "inner"),
                              segments=(di, di, 2 * N, H))
        self.conv_w = ctx.param("conv_w", (cfg.ssm_conv, conv_dim),
                                (None, "inner"), scale=0.5,
                                segments=(di, 2 * N))
        self.conv_b = ctx.param("conv_b", (conv_dim,), ("inner",),
                                init="zeros", segments=(di, 2 * N))
        self.A_log = ctx.param("A_log", (H,), (None,), init="zeros")
        self.D = ctx.param("D", (H,), (None,), init="ones")
        self.dt_bias = ctx.param("dt_bias", (H,), (None,), init="zeros")
        self.norm_w = ctx.param("norm_w", (di,), ("inner",), init="ones")
        self.w_out = ctx.param("w_out", (di, d), ("inner", "embed"))


def mamba2_init(cfg: ModelConfig, ctx: InitCtx) -> Mamba2:
    return Mamba2(cfg, ctx)


def _dims(p: Mamba2, cfg: ModelConfig) -> tuple[int, int, int, int]:
    """(d_inner, heads, B/C columns, head dim) of the block, or of this
    rank's share where it splits over ``model``."""
    n = 1 if p.tp is None else p.tp.mg.size
    return (cfg.d_inner // n, cfg.ssm_heads // n, 2 * cfg.ssm_state // n,
            cfg.ssm_head_dim)


def _split_proj(proj: torch.Tensor, di: int, bc: int):
    z = proj[..., :di]
    xbc = proj[..., di:di + di + bc]
    dt = proj[..., di + di + bc:]
    return z, xbc, dt


def _bc(p: Mamba2, xbc: torch.Tensor, di: int, N: int):
    """B and C (..., N) each, after the conv: the rank's channels gathered
    over ``model`` where the block splits."""
    bc = xbc[..., di:]
    if p.tp is not None:
        bc = p.tp.gather_bc(bc)
    return bc[..., :N], bc[..., N:]


def _heads(p: Mamba2, t: torch.Tensor) -> torch.Tensor:
    """An (H,) leaf, at this rank's heads where the block splits."""
    return t if p.tp is None else p.tp.part(t, 0)


def _causal_conv(xbc: torch.Tensor, w: torch.Tensor, b: torch.Tensor
                 ) -> torch.Tensor:
    """Depthwise causal conv1d over the sequence.  xbc: (B, L, Cdim).

    The reference's shifted sum, in its order, in the input's dtype (not
    ``F.conv1d``, which runs a float32 convolution in TF32 on the card)."""
    with span("repro.causal_conv"):
        K = w.shape[0]
        L = xbc.shape[1]
        pad = F.pad(xbc, (0, 0, K - 1, 0))
        out = sum(pad[:, i:i + L, :] * w[i][None, None] for i in range(K))
        return F.silu(out + b[None, None])


def _dt_A(p: Mamba2, dt: torch.Tensor):
    dt = F.softplus(dt.float() + _heads(p, p.dt_bias).float())
    return dt, -torch.exp(_heads(p, p.A_log).float())


def _gate_out(p: Mamba2, y: torch.Tensor, z: torch.Tensor, cfg: ModelConfig
              ) -> torch.Tensor:
    """The gated norm over the whole d_inner and ``w_out``; split, the
    norm's sum of squares and the product's partial sums over ``model``."""
    if p.tp is None:
        return rms_norm(y * F.silu(z), p.norm_w, cfg.norm_eps) @ p.w_out
    y = p.tp.rms_norm(y * F.silu(z), p.norm_w, cfg.norm_eps)
    return p.tp.exit(y @ p.w_out)


def _enter(p: Mamba2, x: torch.Tensor) -> torch.Tensor:
    return x if p.tp is None else p.tp.enter(x)


def mamba2_forward(p: Mamba2, x: torch.Tensor, cfg: ModelConfig, *,
                   state: torch.Tensor | None = None,
                   conv_state: torch.Tensor | None = None,
                   return_state: bool = False):
    """Full-sequence Mamba2 block.  x: (B, L, d_model).  With
    ``return_state``: (out, final SSM state (B, H, P, N) f32, conv state
    (B, K-1, conv_dim), the last K-1 pre-conv inputs); split over
    ``model``, the rank's heads and conv channels of them."""
    with span("repro.mamba2"):
        di, H, bc, P = _dims(p, cfg)
        B_, L, _ = x.shape
        proj = _enter(p, x) @ p.w_in
        z, xbc_raw, dt = _split_proj(proj, di, bc)
        xbc = _causal_conv(xbc_raw, p.conv_w, p.conv_b)
        xs = xbc[..., :di].reshape(B_, L, H, P).contiguous()
        Bm, Cm = _bc(p, xbc, di, cfg.ssm_state)
        dt, A = _dt_A(p, dt)
        scan = ops.ssd_scan if cfg.use_kernel else ref.ssd_chunked_ref
        with span("repro.scan"):
            res = scan(xs, dt.contiguous(), A, Bm.contiguous(),
                       Cm.contiguous(), chunk=min(cfg.ssm_chunk, L),
                       initial_state=state, return_state=return_state)
        y, final = res if return_state else (res, None)
        y = y + xs * _heads(p, p.D).to(xs.dtype)[None, None, :, None]
        out = _gate_out(p, y.reshape(B_, L, di), z, cfg)
        if return_state:
            # the reference computes the same product again here; the
            # pre-conv inputs are those of ``proj``
            return out, final, xbc_raw[:, -(cfg.ssm_conv - 1):, :]
        return out


def mamba2_decode(p: Mamba2, x: torch.Tensor, cfg: ModelConfig,
                  state: torch.Tensor, conv_state: torch.Tensor):
    """Single-token recurrent step.

    x: (B, 1, d); state: (B, H, P, N); conv_state: (B, K-1, conv_dim) (the
    rank's heads and channels where the block splits).  Returns (out,
    new_state, new_conv_state), new tensors.
    """
    di, H, bc, P = _dims(p, cfg)
    B_ = x.shape[0]
    proj = _enter(p, x) @ p.w_in
    z, xbc_raw, dt = _split_proj(proj, di, bc)
    # streaming causal conv: window = [conv_state, current]
    win = torch.cat([conv_state, xbc_raw], dim=1)             # (B, K, Cdim)
    conv = torch.einsum("bkc,kc->bc", win, p.conv_w) + p.conv_b
    xbc = F.silu(conv)[:, None, :]
    xs = xbc[..., :di].reshape(B_, H, P)
    Bm, Cm = _bc(p, xbc[:, 0], di, cfg.ssm_state)
    dt1, A = _dt_A(p, dt[:, 0])
    y, new_state = ref.ssd_decode_step(state, xs, dt1, A, Bm, Cm)
    y = y + xs * _heads(p, p.D).to(xs.dtype)[None, :, None]
    out = _gate_out(p, y.reshape(B_, 1, di), z, cfg)
    return out, new_state, win[:, 1:, :]


# the logical axes of each state leaf, as the reference's state init
# records them
MAMBA2_STATE_AXES = {"ssm": ("batch", "heads", None, None),
                     "conv": ("batch", None, "inner")}


def mamba2_state_init(cfg: ModelConfig, batch: int, *, device,
                      n: int | None = None, heads: int | None = None,
                      conv_dim: int | None = None) -> dict:
    """Zeroed decode state; with ``n``, ``n`` states stacked on a leading
    axis.  The SSM state is float32, the conv state the model's dtype;
    ``heads`` and ``conv_dim`` default to the whole block's (a rank's
    share where it splits over ``model``)."""
    N = cfg.ssm_state
    lead = () if n is None else (n,)
    H = heads or cfg.ssm_heads
    C = conv_dim or cfg.d_inner + 2 * N
    return {
        "ssm": torch.zeros(lead + (batch, H, cfg.ssm_head_dim, N),
                           dtype=torch.float32, device=device),
        "conv": torch.zeros(lead + (batch, cfg.ssm_conv - 1, C),
                            dtype=cfg.dtype, device=device),
    }
