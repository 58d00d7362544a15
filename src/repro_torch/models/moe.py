"""Feed-forward blocks: the dense SwiGLU MLP and the mixture of experts with
token-choice top-k routing, capacity-bounded sort-based dispatch and shared
experts (``repro.models.moe``).

The expert products are batched matrix products over the (E, C, d) dispatch
buffer, as the reference's einsums are; no kernel of the port is on this
path.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import swiglu
from repro_torch.models.params import InitCtx


class FFN(nn.Module):
    """w_gate, w_up (d, f) and w_down (f, d).  ``tp``: None, or where the
    ``mlp`` dim splits over a mesh's ``model`` axis
    (``dist.tensor_parallel.MlpSplit``), this rank's columns and rows."""

    def __init__(self, cfg: ModelConfig, ctx: InitCtx, d_ff: int | None = None):
        super().__init__()
        self.tp = None
        d, f = cfg.d_model, d_ff or cfg.d_ff
        self.w_gate = ctx.param("w_gate", (d, f), ("embed", "mlp"))
        self.w_up = ctx.param("w_up", (d, f), ("embed", "mlp"))
        self.w_down = ctx.param("w_down", (f, d), ("mlp", "embed"))


def ffn_init(cfg: ModelConfig, ctx: InitCtx, d_ff: int | None = None) -> FFN:
    return FFN(cfg, ctx, d_ff)


def ffn_forward(p: FFN, x: torch.Tensor) -> torch.Tensor:
    """SwiGLU; split over ``model``, column-parallel ``w_gate`` and
    ``w_up``, row-parallel ``w_down``, its partial sums summed over it."""
    if p.tp is None:
        return swiglu(x, p.w_gate, p.w_up, p.w_down)
    return p.tp.exit(swiglu(p.tp.enter(x), p.w_gate, p.w_up, p.w_down))


class MoE(nn.Module):
    """router (d, E); w_gate, w_up (E, d, f); w_down (E, f, d); and, with
    ``cfg.n_shared_experts``, a ``shared`` SwiGLU of width
    ``moe_d_ff * n_shared_experts``."""

    def __init__(self, cfg: ModelConfig, ctx: InitCtx):
        super().__init__()
        d, f, E = cfg.d_model, cfg.moe_d_ff, cfg.n_experts
        self.router = ctx.param("router", (d, E), ("embed", None))
        self.w_gate = ctx.param("w_gate", (E, d, f),
                                  ("experts", "embed", "expert_mlp"))
        self.w_up = ctx.param("w_up", (E, d, f),
                                ("experts", "embed", "expert_mlp"))
        self.w_down = ctx.param("w_down", (E, f, d),
                                  ("experts", "expert_mlp", "embed"))
        if cfg.n_shared_experts:
            self.shared = FFN(cfg, ctx, d_ff=cfg.moe_d_ff * cfg.n_shared_experts)


def moe_init(cfg: ModelConfig, ctx: InitCtx) -> MoE:
    return MoE(cfg, ctx)


def expert_capacity(n_tokens: int, cfg: ModelConfig) -> int:
    c = math.ceil(n_tokens * cfg.experts_per_token / cfg.n_experts
                  * cfg.capacity_factor)
    return max(8, -(-c // 8) * 8)          # round up to multiple of 8


def expert_counts(ids: torch.Tensor, n_experts: int) -> torch.Tensor:
    """``torch.bincount(ids, minlength=n_experts)`` for ids below
    ``n_experts``, with its size fixed by ``n_experts`` alone: bincount
    sizes its output by the largest id, which a CUDA stream capture or a
    fake tensor cannot read."""
    return torch.zeros(n_experts, dtype=torch.long, device=ids.device
                       ).scatter_add_(0, ids, torch.ones_like(ids))


def _route(p: MoE, xt: torch.Tensor, cfg: ModelConfig):
    """Router probabilities (T, E) f32 and the renormalised top-k (weights,
    expert ids), each (T, k).  Ties go to the lower expert id, as
    ``jax.lax.top_k`` breaks them (``torch.topk`` promises no order): a
    stable descending sort keeps equal probabilities in id order."""
    logits = xt.float() @ p.router.float()
    # DeepSeek-V3 gates with a sigmoid (selected by its MLA attention),
    # classic MoE with a softmax; both renormalise the selected gates
    probs = torch.sigmoid(logits) if cfg.attn_type == "mla" \
        else torch.softmax(logits, dim=-1)
    topv, topi = torch.sort(probs, dim=-1, descending=True, stable=True)
    k = cfg.experts_per_token
    topv, topi = topv[:, :k], topi[:, :k]
    topv = topv / torch.clamp(topv.sum(-1, keepdim=True), min=1e-9)
    return probs, topv, topi


def moe_forward(p: MoE, x: torch.Tensor, cfg: ModelConfig
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Token-choice top-k MoE with capacity-bounded sort-based dispatch.
    x (B, S, d) -> (out (B, S, d), aux () f32).

    The (token, expert) pairs are sorted by expert (stably, so a token keeps
    its place within its expert) and scattered into an (E, C, d) buffer; a
    pair past its expert's capacity C goes to the overflow row E*C, which
    is discarded (Switch-style drops).  Every expert runs over its C rows,
    empty ones included; outputs come back weighted by the router and are
    summed per token.  ``aux`` is the Switch load-balance loss.
    """
    B, S, d = x.shape
    E, k = cfg.n_experts, cfg.experts_per_token
    T = B * S
    C = expert_capacity(T, cfg)
    xt = x.reshape(T, d)
    probs, topv, topi = _route(p, xt, cfg)

    # ---- sort-based dispatch ---------------------------------------- #
    flat_e = topi.reshape(-1)                            # (T*k,)
    flat_t = torch.arange(T, device=x.device).repeat_interleave(k)
    order = torch.argsort(flat_e, stable=True)
    se, st, sw = flat_e[order], flat_t[order], topv.reshape(-1)[order]
    counts = expert_counts(se, E)
    starts = torch.cumsum(counts, 0) - counts
    pos = torch.arange(T * k, device=x.device) - starts[se]
    slot = torch.where(pos < C, se * C + pos, E * C)     # E*C: overflow row
    # every real slot is written at most once; the overflow row takes
    # whichever of its duplicates lands last
    buf = x.new_zeros((E * C + 1, d))
    buf[slot] = xt[st]
    xbuf = buf[:E * C].view(E, C, d)

    # ---- expert compute (batched over the expert axis) --------------- #
    gate = torch.bmm(xbuf, p.w_gate)
    if gate.requires_grad:
        # autograd keeps what the backward reads: new arrays, as in the
        # reference; a dropped pair's output is zero and takes no gradient
        h = F.silu(gate) * torch.bmm(xbuf, p.w_up)
        ybuf = torch.cat([torch.bmm(h, p.w_down).reshape(E * C, d),
                          buf.new_zeros((1, d))])
        y_tok = ybuf[slot] * sw[:, None].to(buf.dtype)
    else:
        # in place where the reference makes new arrays: the same products,
        # and the expert outputs overwrite the dispatch buffer (at
        # DeepSeek-V3's 16,384 prefill tokens it is 2.35 GB in bf16, and
        # each copy spared counts beside the weights on one card)
        h = F.silu(gate, inplace=True)
        h.mul_(torch.bmm(xbuf, p.w_up))
        torch.bmm(h, p.w_down, out=xbuf)
        del h, gate
        buf[E * C].zero_()             # a dropped pair's output is zero
        y_tok = buf[slot]
        y_tok.mul_(sw[:, None].to(buf.dtype))

    # ---- combine ------------------------------------------------------ #
    y = x.new_zeros((T, d)).index_add_(0, st, y_tok)

    out = y.reshape(B, S, d)
    if hasattr(p, "shared"):
        out = out + ffn_forward(p.shared, x)
    me = expert_counts(flat_e, E).float() / (T * k)
    aux = E * torch.sum(me * probs.mean(0))
    return out, aux


def moe_forward_oracle(p: MoE, x: torch.Tensor, cfg: ModelConfig
                       ) -> torch.Tensor:
    """Per-token dense oracle (no capacity drops) for tests."""
    B, S, d = x.shape
    xt = x.reshape(-1, d)
    _, topv, topi = _route(p, xt, cfg)
    y = torch.zeros_like(xt)
    for e in range(cfg.n_experts):
        w_e = torch.where(topi == e, topv, 0.0).sum(-1)   # (T,)
        ye = swiglu(xt, p.w_gate[e], p.w_up[e], p.w_down[e])
        y = y + w_e[:, None].to(ye.dtype) * ye
    out = y.reshape(B, S, d)
    if hasattr(p, "shared"):
        out = out + ffn_forward(p.shared, x)
    return out
