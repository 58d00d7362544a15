"""RWKV6 "Finch" block: time-mix with data-dependent decay + channel-mix,
as ``repro.models.rwkv``.

The WKV scan goes through ``kernels.ops.rwkv6_scan`` (the hand-written CUDA
kernel on the card) when ``cfg.use_kernel`` is set, else through the plain
``kernels.ref.rwkv6_chunked_ref``, in prefill and in decode alike: decode
is the time-mix at L = 1, which the reference runs as the chunked scan at
chunk min(rwkv_chunk, 1) = 1 from the carried WKV state.  As in the
reference, ``rms_norm`` over the whole width stands where upstream RWKV has
a per-head GroupNorm.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels import ops, ref
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import rms_norm
from repro_torch.models.params import InitCtx

LORA_R = 32      # rank of the data-dependent decay LoRA (w = base + lora(x))


def rwkv6_heads(cfg: ModelConfig) -> int:
    return cfg.d_model // cfg.head_dim


class Rwkv6(nn.Module):
    """Time mix: token-shift factors mu_{r,k,v,w,g} (d,), projections
    w_{r,k,v,g,o} (d, d), the decay's w_base (d,) and LoRA w_lora_a
    (d, 32), w_lora_b (32, d), the bonus u (H, K) and the output norm ln_x
    (d,).  Channel mix: mu_ck (d,), w_ck (d, d_ff), w_cv (d_ff, d), w_cr
    (d, d).  ``tp``: None, or where the layer splits over a mesh's
    ``model`` axis (``dist.tensor_parallel.RwkvSplit``): the rank's heads
    of the time mix (columns of w_r, w_k, w_v, w_g, rows of w_o, u) and
    its columns of the channel mix (w_ck, w_cr; rows of w_cv)."""

    def __init__(self, cfg: ModelConfig, ctx: InitCtx):
        super().__init__()
        self.tp = None
        d = cfg.d_model
        H, K = rwkv6_heads(cfg), cfg.head_dim
        for name in ("mu_r", "mu_k", "mu_v", "mu_w", "mu_g"):
            setattr(self, name, ctx.param(name, (d,), ("embed",),
                                          init="ones"))
        for name in ("w_r", "w_k", "w_v", "w_g"):
            setattr(self, name, ctx.param(name, (d, d),
                                          ("embed", "heads_x_dim")))
        self.w_o = ctx.param("w_o", (d, d), ("heads_x_dim", "embed"))
        self.w_base = ctx.param("w_base", (d,), ("embed",), init="zeros")
        self.w_lora_a = ctx.param("w_lora_a", (d, LORA_R), ("embed", None))
        self.w_lora_b = ctx.param("w_lora_b", (LORA_R, d), (None, "embed"))
        self.u = ctx.param("u", (H, K), ("heads", "head_dim"), scale=0.1)
        self.ln_x = ctx.param("ln_x", (d,), ("embed",), init="ones")
        self.mu_ck = ctx.param("mu_ck", (d,), ("embed",), init="ones")
        self.w_ck = ctx.param("w_ck", (d, cfg.d_ff), ("embed", "mlp"))
        self.w_cv = ctx.param("w_cv", (cfg.d_ff, d), ("mlp", "embed"))
        self.w_cr = ctx.param("w_cr", (d, d), ("embed", "embed_out"))


def rwkv6_init(cfg: ModelConfig, ctx: InitCtx) -> Rwkv6:
    return Rwkv6(cfg, ctx)


def _token_shift(x: torch.Tensor, last: torch.Tensor) -> torch.Tensor:
    """shifted[t] = x[t-1]; position 0 takes ``last`` (carried state)."""
    return torch.cat([last[:, None, :], x[:, :-1, :]], dim=1)


def _decay(p: Rwkv6, xw: torch.Tensor, clamp: float, tp=None
           ) -> torch.Tensor:
    """The data-dependent decay; with ``tp`` (the time mix split), at this
    rank's columns: the LoRA's tanh output enters the split, w_lora_b and
    w_base are read at the rank's columns."""
    t = torch.tanh(xw @ p.w_lora_a)
    if tp is None:
        lora, base = t @ p.w_lora_b, p.w_base
    else:
        lora, base = tp.enter(t) @ tp.part(p.w_lora_b, 1), tp.part(p.w_base, 0)
    w = -torch.exp(torch.clamp(base[None, None].float() + lora.float(),
                               -8.0, 2.0))
    return torch.clamp(w, -clamp, -1e-4)


def _mix(x: torch.Tensor, xs: torch.Tensor, mu: torch.Tensor) -> torch.Tensor:
    return x * mu[None, None] + xs * (1.0 - mu[None, None])


def rwkv6_time_mix(p: Rwkv6, x: torch.Tensor, cfg: ModelConfig, *,
                   shift_state: torch.Tensor | None = None,
                   wkv_state: torch.Tensor | None = None,
                   return_state: bool = False):
    """x: (B, L, d) -> (B, L, d).  With ``return_state``: (out, final WKV
    state (B, H, K, K) f32, the last input (B, d) for the next token
    shift).  Split over ``model`` (``p.tp.time``), each token-shift mix
    enters the rank's heads (``copy_to``), the WKV state is the rank's
    heads', ``ln_x`` normalises over the whole width and ``w_o``'s partial
    sums leave (``reduce_from``)."""
    B_, L, d = x.shape
    tp = p.tp if p.tp is not None and p.tp.time else None
    H, K = p.u.shape[0], cfg.head_dim
    last = shift_state if shift_state is not None else x.new_zeros((B_, d))
    xs = _token_shift(x, last)

    def mixed(mu):
        m = _mix(x, xs, mu)
        return m if tp is None else tp.enter(m)
    r = (mixed(p.mu_r) @ p.w_r).reshape(B_, L, H, K)
    k = (mixed(p.mu_k) @ p.w_k).reshape(B_, L, H, K)
    v = (mixed(p.mu_v) @ p.w_v).reshape(B_, L, H, K)
    g = F.silu(mixed(p.mu_g) @ p.w_g)
    w = _decay(p, _mix(x, xs, p.mu_w), cfg.rwkv_w_clamp,
               tp).reshape(B_, L, H, K)

    scan = ops.rwkv6_scan if cfg.use_kernel else ref.rwkv6_chunked_ref
    res = scan(r, k, v, w, p.u, chunk=min(cfg.rwkv_chunk, L),
               initial_state=wkv_state, return_state=return_state)
    y, final = res if return_state else (res, None)
    y = y.reshape(B_, L, H * K)
    if tp is None:
        out = (rms_norm(y, p.ln_x, cfg.norm_eps) * g) @ p.w_o
    else:
        y = tp.rms_norm(y, tp.part(p.ln_x, 0), cfg.norm_eps)
        out = tp.exit((y * g) @ p.w_o)
    if return_state:
        return out, final, x[:, -1, :]
    return out


def rwkv6_channel_mix(p: Rwkv6, x: torch.Tensor, cfg: ModelConfig, *,
                      shift_state: torch.Tensor | None = None,
                      return_state: bool = False):
    """x: (B, L, d) -> (B, L, d); with ``return_state`` also the last input
    (B, d) for the next token shift.  Split over ``model``
    (``p.tp.channel``): the mix enters the split (``copy_to``), ``w_cv``'s
    partial sums leave it, and each rank's columns of the receptance-gated
    output are gathered (``gather_from``)."""
    B_, L, d = x.shape
    last = shift_state if shift_state is not None else x.new_zeros((B_, d))
    xk = _mix(x, _token_shift(x, last), p.mu_ck)
    tp = p.tp if p.tp is not None and p.tp.channel else None
    if tp is None:
        kv = torch.square(torch.relu(xk @ p.w_ck)) @ p.w_cv
        out = torch.sigmoid(xk @ p.w_cr) * kv
    else:
        xk = tp.enter(xk)
        kv = tp.exit(torch.square(torch.relu(xk @ p.w_ck)) @ p.w_cv)
        out = tp.gather(torch.sigmoid(xk @ p.w_cr) * tp.part(kv, -1))
    if return_state:
        return out, x[:, -1, :]
    return out


# the logical axes of each state leaf, as the reference's state init
# records them
RWKV6_STATE_AXES = {"wkv": ("batch", "heads", None, None),
                    "shift_t": ("batch", "embed"),
                    "shift_c": ("batch", "embed")}


def rwkv6_state_init(cfg: ModelConfig, batch: int, *, device,
                     n: int | None = None, heads: int | None = None) -> dict:
    """Zeroed decode state; with ``n``, ``n`` states stacked on a leading
    axis.  The WKV state (B, H, K, K) is float32, ``heads`` of them
    (default all; a rank's share where they split over ``model``), the two
    token-shift states (B, d) the model's dtype."""
    H, K = heads or rwkv6_heads(cfg), cfg.head_dim
    lead = () if n is None else (n,)
    return {
        "wkv": torch.zeros(lead + (batch, H, K, K), dtype=torch.float32,
                           device=device),
        "shift_t": torch.zeros(lead + (batch, cfg.d_model), dtype=cfg.dtype,
                               device=device),
        "shift_c": torch.zeros(lead + (batch, cfg.d_model), dtype=cfg.dtype,
                               device=device),
    }
