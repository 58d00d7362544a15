"""Grouped-query attention with prefill and decode paths (the GQA half of
``repro.models.attention``; MLA waits in ROADMAP.md).

Prefill goes through ``kernels.ops.flash_attention`` (the hand-written
CUDA kernel on the card) when ``cfg.use_kernel`` is set, else through the
plain route ``kernels.ops.plain_attention``; decode is plain torch on every
device, as in the reference.

The decode cache is updated in place: ``gqa_prefill`` and ``gqa_decode``
write the new keys and values and the length counter into the tensors of
the ``cache`` dict they are given (which may be views into a stacked cache)
and return that same dict.  The reference returns new arrays instead.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.kernels import ops
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import apply_rope
from repro_torch.models.params import InitCtx


class GQA(nn.Module):
    """wq (d, H, hd), wk and wv (d, Hkv, hd), wo (H, hd, d), optional
    biases."""

    def __init__(self, cfg: ModelConfig, ctx: InitCtx):
        super().__init__()
        d, H, Hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        self.wq = ctx.param("wq", (d, H, hd))
        self.wk = ctx.param("wk", (d, Hkv, hd))
        self.wv = ctx.param("wv", (d, Hkv, hd))
        self.wo = ctx.param("wo", (H, hd, d))
        if cfg.qkv_bias:
            self.bq = ctx.param("bq", (H, hd), init="zeros")
            self.bk = ctx.param("bk", (Hkv, hd), init="zeros")
            self.bv = ctx.param("bv", (Hkv, hd), init="zeros")


def gqa_init(cfg: ModelConfig, ctx: InitCtx) -> GQA:
    if cfg.mrope:
        raise NotImplementedError("M-RoPE waits for qwen2-vl (ROADMAP.md)")
    return GQA(cfg, ctx)


def _proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum('bsd,dhk->bshk') as one matrix product."""
    d, h, k = w.shape
    return (x @ w.reshape(d, h * k)).unflatten(-1, (h, k))


def _project_qkv(p: GQA, x: torch.Tensor, cfg: ModelConfig,
                 positions: torch.Tensor):
    q, k, v = _proj(x, p.wq), _proj(x, p.wk), _proj(x, p.wv)
    if cfg.qkv_bias:
        q = q + p.bq[None, None]
        k = k + p.bk[None, None]
        v = v + p.bv[None, None]
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _out(p: GQA, o: torch.Tensor) -> torch.Tensor:
    """einsum('bshk,hkd->bsd') as one matrix product."""
    h, k, d = p.wo.shape
    return o.flatten(-2) @ p.wo.reshape(h * k, d)


def _attend(q, k, v, cfg: ModelConfig) -> torch.Tensor:
    attend = ops.flash_attention if cfg.use_kernel else ops.plain_attention
    return attend(q.contiguous(), k.contiguous(), v.contiguous(), causal=True,
                  window=cfg.sliding_window)


def gqa_forward(p: GQA, x: torch.Tensor, cfg: ModelConfig,
                positions: torch.Tensor) -> torch.Tensor:
    """Full-sequence causal attention (prefill without a cache)."""
    q, k, v = _project_qkv(p, x, cfg, positions)
    return _out(p, _attend(q, k, v, cfg))


def gqa_prefill(p: GQA, x: torch.Tensor, cfg: ModelConfig,
                positions: torch.Tensor, cache: dict):
    """Prefill: run full attention AND fill the cache (in place).

    Sliding-window caches are rings of size ``window``: only the trailing
    window of keys survives prefill, placed at their ring slots."""
    q, k, v = _project_qkv(p, x, cfg, positions)
    S = x.shape[1]
    L = cache["k"].shape[1]
    if S > L:                       # SWA ring: keep the last L positions
        roll = S % L
        k_w = torch.roll(k[:, -L:], shifts=roll, dims=1)
        v_w = torch.roll(v[:, -L:], shifts=roll, dims=1)
    else:
        k_w, v_w = k, v
    cache["k"][:, :k_w.shape[1]] = k_w.to(cache["k"].dtype)
    cache["v"][:, :v_w.shape[1]] = v_w.to(cache["v"].dtype)
    cache["len"].fill_(S)
    return _out(p, _attend(q, k, v, cfg)), cache


def gqa_decode(p: GQA, x: torch.Tensor, cfg: ModelConfig,
               positions: torch.Tensor, cache: dict):
    """Single-token decode against the KV cache (updated in place).

    For sliding-window attention the cache is a ring buffer of size
    ``cfg.sliding_window``.  The slot index stays on the device; like the
    reference's ``dynamic_update_slice`` it is clamped to the cache.
    """
    q, k, v = _project_qkv(p, x, cfg, positions)      # (B, 1, H, hd)
    L = cache["k"].shape[1]
    pos = cache["len"][0].long()                      # current length
    slot = pos % L if cfg.sliding_window else torch.clamp(pos, max=L - 1)
    cache["k"].index_copy_(1, slot.reshape(1), k.to(cache["k"].dtype))
    cache["v"].index_copy_(1, slot.reshape(1), v.to(cache["v"].dtype))
    n_valid = torch.clamp(pos + 1, max=L)
    valid = torch.arange(L, device=x.device)[None, :] < n_valid
    o = ops.decode_attention(q, cache["k"], cache["v"], valid)
    cache["len"] += 1
    return _out(p, o), cache


def gqa_cache_init(cfg: ModelConfig, batch: int, max_len: int, *,
                   device, n: int | None = None) -> dict:
    """Zeroed KV cache; with ``n``, ``n`` caches stacked on a leading axis."""
    L = min(max_len, cfg.sliding_window) if cfg.sliding_window else max_len
    lead = () if n is None else (n,)
    shape = lead + (batch, L, cfg.n_kv_heads, cfg.head_dim)
    return {
        "k": torch.zeros(shape, dtype=cfg.dtype, device=device),
        "v": torch.zeros(shape, dtype=cfg.dtype, device=device),
        "len": torch.zeros(lead + (1,), dtype=torch.int32, device=device),
    }
