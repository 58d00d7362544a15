"""Feed-forward blocks: the dense SwiGLU MLP and the mixture of experts with
token-choice top-k routing, capacity-bounded sort-based dispatch and shared
experts (``repro.models.moe``).

The expert products are batched matrix products over the (E, C, d) dispatch
buffer, as the reference's einsums are; no kernel of the port is on this
path.

A batch split over ranks (the sharded train step's block of each
microbatch, the dry run's block of a prefill or decode batch) routes as
the reference's program over the whole batch does (``BatchRouting``,
``routed_over``): the capacity of the whole batch, a pair's place in its
expert's queue counted over every lower batch rank, and the load-balance
loss of the whole batch.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.dist.tensor_parallel import (ModelGroup, all_gather,
                                              sum_partial)
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
    ``moe_d_ff * n_shared_experts``.  ``tp``: None, or where the
    ``experts`` or ``expert_mlp`` dim splits over a mesh's ``model`` axis
    (``dist.tensor_parallel.ExpertSplit``), this rank's experts or each
    expert's columns.  ``batch``: None, or the split of the batch it
    routes over ranks (``BatchRouting``, set by ``routed_over``)."""

    def __init__(self, cfg: ModelConfig, ctx: InitCtx):
        super().__init__()
        self.tp = None
        self.batch = None
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


@dataclasses.dataclass(frozen=True, eq=False)
class BatchRouting:
    """A routing batch split along its rows into ``count`` equal blocks
    over the ranks of ``group`` (the batch group: its process group, its
    size and this rank's place in it), this rank holding block ``index``.
    Group rank j holds block j % ``count``: the blocks lie in group-rank
    order, as ``sharding.batch_block`` lays rows over ``pod`` x ``data``
    (pod outer), and where the rows split over ``data`` alone the ``pod``
    coordinates repeat them."""
    group: ModelGroup
    index: int
    count: int


@contextlib.contextmanager
def routed_over(model: nn.Module, routing: BatchRouting | None):
    """Every ``MoE`` of ``model`` routes over ``routing``'s whole batch
    while the block runs (nothing changes with None)."""
    moes = [m for m in model.modules() if isinstance(m, MoE)]
    for m in moes:
        m.batch = routing
    try:
        yield
    finally:
        for m in moes:
            m.batch = None


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

    With ``p.batch`` (``BatchRouting``) ``x`` is this rank's block of a
    batch of ``count`` blocks, routed as the whole batch is: C is the
    whole batch's capacity; a pair's place in its expert's queue is its
    place here plus that expert's pairs on every lower block (one
    all-gather of the (E,) counts: the reference's stable sort orders the
    pairs block-major); ``aux`` is the whole batch's, its router means
    summed over the batch group both ways (``sum_partial``), so that
    after the step's average over that group the router takes the
    reference's gradient of it once.  No expert keeps more than
    ``min(C, T)`` of this block's T tokens (a token takes an expert at
    most once), so the buffer holds that many rows an expert.

    With ``p.tp`` (``ExpertSplit``) the routing runs replicated on every
    model rank (the router is whole and the tokens are replicated over
    ``model``, so every rank makes the same choices and drops); the
    tokens and the gates enter the split experts through ``copy_to``;
    each rank runs its experts' rows of the buffer (``experts`` split) or
    every expert's products at its columns (``expert_mlp`` split) and
    combines its partial outputs, which are summed over ``model``
    (``reduce_from``).  The load-balance loss stays replicated and its
    gradient is not summed over ``model``.  The reference's GSPMD program
    moves tokens by all-to-alls to the ranks of their experts; with the
    activations replicated over ``model`` no all-to-all is needed, and
    the sums are the same.
    """
    B, S, d = x.shape
    E, k = cfg.n_experts, cfg.experts_per_token
    T = B * S
    route = p.batch
    T_all = T * route.count if route is not None else T
    C = expert_capacity(T_all, cfg)
    rows = C if route is None else min(C, T)     # buffer rows an expert
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
    if route is None:
        keep = pos < C
    else:
        parts = all_gather(counts[None], route.group, 0)     # (ranks, E)
        keep = pos + parts[:route.index].sum(0)[se] < C
    tp = p.tp
    lo, n_e = (0, E) if tp is None else tp.experts(E)
    if n_e != E:                   # this rank's experts [lo, lo + n_e)
        keep = keep & (se >= lo) & (se < lo + n_e)
    slot = torch.where(keep, (se - lo) * rows + pos, n_e * rows)  # overflow
    if tp is not None:
        xt, sw = tp.enter(xt), tp.enter(sw)
    # every real slot is written at most once; the overflow row takes
    # whichever of its duplicates lands last
    buf = x.new_zeros((n_e * rows + 1, d))
    buf[slot] = xt[st]
    xbuf = buf[:n_e * rows].view(n_e, rows, d)

    # ---- expert compute (batched over the expert axis) --------------- #
    gate = torch.bmm(xbuf, p.w_gate)
    if gate.requires_grad:
        # autograd keeps what the backward reads: new arrays, as in the
        # reference; a dropped pair's output is zero and takes no gradient
        h = F.silu(gate) * torch.bmm(xbuf, p.w_up)
        ybuf = torch.cat([torch.bmm(h, p.w_down).reshape(n_e * rows, d),
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
        buf[n_e * rows].zero_()        # a dropped pair's output is zero
        y_tok = buf[slot]
        y_tok.mul_(sw[:, None].to(buf.dtype))

    # ---- combine ------------------------------------------------------ #
    y = x.new_zeros((T, d)).index_add_(0, st, y_tok)
    if tp is not None:
        y = tp.exit(y)

    out = y.reshape(B, S, d)
    if hasattr(p, "shared"):
        out = out + ffn_forward(p.shared, x)
    if route is None:
        me = expert_counts(flat_e, E).float() / (T * k)
    else:
        me = parts[:route.count].sum(0).float() / (T_all * k)
    return out, load_balance_loss(probs, me, route)


def load_balance_loss(probs: torch.Tensor, me: torch.Tensor,
                      route: BatchRouting | None) -> torch.Tensor:
    """The Switch load-balance loss E * sum(me * ce) of the router
    probabilities ``probs`` (T, E) and each expert's share of the pairs
    ``me`` (E,), ``ce`` the mean of ``probs`` over the batch: with
    ``route``, over its whole batch, the sum summed over the batch group
    both ways (each block counted size / count times there)."""
    if route is None:
        ce = probs.mean(0)
    else:
        ce = sum_partial(probs.sum(0), route.group) / (
            probs.shape[0] * route.group.size)
    return probs.shape[1] * torch.sum(me * ce)


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
