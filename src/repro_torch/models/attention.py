"""Attention blocks with prefill and decode paths, as in
``repro.models.attention``: grouped-query attention (GQA, optional sliding
window, RoPE or Qwen2-VL's M-RoPE) and DeepSeek-V3's multi-head latent
attention (MLA).

Prefill goes through ``kernels.ops.flash_attention`` (the hand-written
CUDA kernel on the card) when ``cfg.use_kernel`` is set, else through the
plain route ``kernels.ops.plain_attention``; decode is plain torch on every
device, as in the reference.  MLA's prefill pads v from ``v_head_dim`` to
the query-key width and slices the output back, as the reference does, and
caches only the latents; its decode is the reference's absorbed form.

The decode cache is updated in place: the prefill and decode functions
write the new keys and values (MLA: latents) and the length counter into
the tensors of the ``cache`` dict they are given (which may be views into a
stacked cache) and return that same dict.  The reference returns new arrays
instead.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels import ops, ref
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import apply_mrope, apply_rope
from repro_torch.models.params import InitCtx


class GQA(nn.Module):
    """wq (d, H, hd), wk and wv (d, Hkv, hd), wo (H, hd, d), optional
    biases."""

    def __init__(self, cfg: ModelConfig, ctx: InitCtx):
        super().__init__()
        d, H, Hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        self.wq = ctx.param("wq", (d, H, hd), ("embed", "heads", "head_dim"))
        self.wk = ctx.param("wk", (d, Hkv, hd),
                             ("embed", "kv_heads", "head_dim"))
        self.wv = ctx.param("wv", (d, Hkv, hd),
                             ("embed", "kv_heads", "head_dim"))
        self.wo = ctx.param("wo", (H, hd, d), ("heads", "head_dim", "embed"))
        if cfg.qkv_bias:
            self.bq = ctx.param("bq", (H, hd), ("heads", "head_dim"),
                                init="zeros")
            self.bk = ctx.param("bk", (Hkv, hd), ("kv_heads", "head_dim"),
                                init="zeros")
            self.bv = ctx.param("bv", (Hkv, hd), ("kv_heads", "head_dim"),
                                init="zeros")


def gqa_init(cfg: ModelConfig, ctx: InitCtx) -> GQA:
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
    if cfg.mrope:                   # positions (3, B, S)
        q = apply_mrope(q, positions, cfg.rope_theta, cfg.mrope_sections)
        k = apply_mrope(k, positions, cfg.rope_theta, cfg.mrope_sections)
    else:
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


# the logical axes of each cache leaf, as the reference's cache init
# records them (``dist.sharding`` maps them onto a mesh)
GQA_CACHE_AXES = {"k": ("batch", "seq_cache", "kv_heads", "head_dim"),
                  "v": ("batch", "seq_cache", "kv_heads", "head_dim"),
                  "len": (None,)}


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


# --------------------------------------------------------------------- #
# MLA (DeepSeek-V3): latent-compressed KV + decoupled RoPE
# --------------------------------------------------------------------- #
class MLA(nn.Module):
    """wq_a (d, q_lora), wq_b (q_lora, H, dn + dr), wkv_a (d, kv_lora +
    dr), wkv_b (kv_lora, H, dn + dv), wo (H, dv, d): the reference's
    ``mla_init`` leaves."""

    def __init__(self, cfg: ModelConfig, ctx: InitCtx):
        super().__init__()
        d, H = cfg.d_model, cfg.n_heads
        qr, kvr = cfg.q_lora_rank, cfg.kv_lora_rank
        dn, dr, dv = (cfg.qk_nope_head_dim, cfg.qk_rope_head_dim,
                      cfg.v_head_dim)
        self.wq_a = ctx.param("wq_a", (d, qr), ("embed", "q_lora"))
        self.wq_b = ctx.param("wq_b", (qr, H, dn + dr),
                              ("q_lora", "heads", "head_dim"))
        self.wkv_a = ctx.param("wkv_a", (d, kvr + dr), ("embed", "kv_lora"))
        self.wkv_b = ctx.param("wkv_b", (kvr, H, dn + dv),
                               ("kv_lora", "heads", "head_dim"))
        self.wo = ctx.param("wo", (H, dv, d), ("heads", "head_dim", "embed"))


def mla_init(cfg: ModelConfig, ctx: InitCtx) -> MLA:
    return MLA(cfg, ctx)


def _mla_query(p: MLA, x: torch.Tensor, cfg: ModelConfig,
               positions: torch.Tensor):
    """einsum('bsd,dr,rhk->bshk') as two products (x wq_a first, rounded
    to x's dtype as the reference's pairwise einsum rounds it), split into
    (q_nope (B, S, H, dn), q_rope (B, S, H, dr) roped)."""
    q = _proj(x @ p.wq_a, p.wq_b)
    dn = cfg.qk_nope_head_dim
    return q[..., :dn], apply_rope(q[..., dn:], positions, cfg.rope_theta)


def _mla_latents(p: MLA, x: torch.Tensor, cfg: ModelConfig,
                 positions: torch.Tensor):
    """The compressed KV latent c_kv (B, S, kv_lora) and the decoupled
    RoPE key k_rope (B, S, dr), roped."""
    kv_a = x @ p.wkv_a
    kvr = cfg.kv_lora_rank
    k_rope = apply_rope(kv_a[..., None, kvr:], positions, cfg.rope_theta)
    return kv_a[..., :kvr], k_rope[:, :, 0]


def _mla_qkv(p: MLA, x: torch.Tensor, cfg: ModelConfig,
             positions: torch.Tensor, latents=None):
    """q, k (B, S, H, dn + dr) and v (B, S, H, dv): k's RoPE half is the
    shared k_rope broadcast over the heads.  ``latents``: ``_mla_latents``
    of the same inputs, when the caller has them."""
    dn, H = cfg.qk_nope_head_dim, cfg.n_heads
    q_nope, q_rope = _mla_query(p, x, cfg, positions)
    c_kv, k_rope = latents or _mla_latents(p, x, cfg, positions)
    kv = _proj(c_kv, p.wkv_b)
    k_nope, v = kv[..., :dn], kv[..., dn:]
    k_rope_b = k_rope[:, :, None].expand(-1, -1, H, -1)
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope_b], dim=-1)
    return q, k, v


def _mla_attend(q, k, v, cfg: ModelConfig) -> torch.Tensor:
    """Causal attention with v zero-padded to q's head width (the shared
    attention primitive takes one D), the output sliced back to dv."""
    dqk, dv = q.shape[-1], v.shape[-1]
    attend = ops.flash_attention if cfg.use_kernel else ops.plain_attention
    o = attend(q.contiguous(), k.contiguous(), F.pad(v, (0, dqk - dv)),
               causal=True)
    return o[..., :dv]


def mla_forward(p: MLA, x: torch.Tensor, cfg: ModelConfig,
                positions: torch.Tensor) -> torch.Tensor:
    """Full-sequence causal attention (prefill without a cache)."""
    return _out(p, _mla_attend(*_mla_qkv(p, x, cfg, positions), cfg))


def mla_prefill(p: MLA, x: torch.Tensor, cfg: ModelConfig,
                positions: torch.Tensor, cache: dict):
    """Prefill: full attention, and only the latents into the cache (in
    place): c_kv and k_rope, kv_lora + dr values a position, not heads x
    head width."""
    latents = _mla_latents(p, x, cfg, positions)
    q, k, v = _mla_qkv(p, x, cfg, positions, latents)
    S = x.shape[1]
    cache["ckv"][:, :S] = latents[0].to(cache["ckv"].dtype)
    cache["krope"][:, :S] = latents[1].to(cache["krope"].dtype)
    cache["len"].fill_(S)
    return _out(p, _mla_attend(q, k, v, cfg)), cache


def mla_decode(p: MLA, x: torch.Tensor, cfg: ModelConfig,
               positions: torch.Tensor, cache: dict):
    """Single-token decode with the absorbed matrices (cache updated in
    place): the query is projected into the latent space through wkv_b's
    key half, attends to the latent cache directly in float32, and the
    attended latent goes through wkv_b's value half.  Plain torch on every
    device, as in the reference.  The slot index stays on the device and is
    clamped to the cache, as the reference's ``dynamic_update_slice``
    clamps it."""
    dn, dr = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    q_nope, q_rope = _mla_query(p, x, cfg, positions)    # (B, 1, H, .)
    c_kv, k_rope = _mla_latents(p, x, cfg, positions)    # (B, 1, kvr/dr)
    L = cache["ckv"].shape[1]
    pos = cache["len"][0].long()
    slot = torch.clamp(pos, max=L - 1)
    cache["ckv"].index_copy_(1, slot, c_kv.to(cache["ckv"].dtype))
    cache["krope"].index_copy_(1, slot, k_rope.to(cache["krope"].dtype))

    wb_k, wb_v = p.wkv_b[..., :dn], p.wkv_b[..., dn:]    # (kvr, H, dn/dv)
    q_lat = torch.einsum("bshk,rhk->bshr", q_nope, wb_k)  # absorbed query
    f32 = torch.float32
    scale = float(np.float32(1.0) / np.sqrt(np.float32(dn + dr)))
    ckv = cache["ckv"].to(f32)
    scores = (torch.einsum("bshr,blr->bhsl", q_lat.to(f32), ckv)
              + torch.einsum("bshk,blk->bhsl", q_rope.to(f32),
                             cache["krope"].to(f32))) * scale
    valid = torch.arange(L, device=x.device) < pos + 1
    scores = torch.where(valid, scores, torch.full_like(scores, ref.NEG_INF))
    probs = torch.softmax(scores, dim=-1)
    o_lat = torch.einsum("bhsl,blr->bshr", probs, ckv)
    o = torch.einsum("bshr,rhk->bshk", o_lat, wb_v.to(f32)).to(x.dtype)
    cache["len"] += 1
    return _out(p, o), cache


MLA_CACHE_AXES = {"ckv": ("batch", "seq_cache", "kv_lora"),
                  "krope": ("batch", "seq_cache", None),
                  "len": (None,)}


def mla_cache_init(cfg: ModelConfig, batch: int, max_len: int, *,
                   device, n: int | None = None) -> dict:
    """Zeroed latent cache: ckv (B, L, kv_lora), krope (B, L, dr) in the
    model's dtype and len (1,) int32; with ``n``, ``n`` caches stacked on a
    leading axis."""
    lead = () if n is None else (n,)
    return {
        "ckv": torch.zeros(lead + (batch, max_len, cfg.kv_lora_rank),
                           dtype=cfg.dtype, device=device),
        "krope": torch.zeros(lead + (batch, max_len, cfg.qk_rope_head_dim),
                             dtype=cfg.dtype, device=device),
        "len": torch.zeros(lead + (1,), dtype=torch.int32, device=device),
    }
