"""Layers shared by the plain references: RMSNorm, rotary embeddings,
causal GQA attention, SwiGLU and the matrix product, all in float32.

``quant`` is None for the reference itself.  A lower precision
(``bench.reference.quant``) passes a function that is handed both operands
of every matrix product (kinds "activation" and "weight"), its result
("output") and the residual stream after each add ("stream"), and rounds
those it rounds; everything else stays float32.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

F32 = torch.float32
# query rows a block of attention scores holds: (heads, rows, keys) float32
SCORE_BLOCK_ELEMENTS = 1 << 28


def mm(x: torch.Tensor, w: torch.Tensor, quant=None) -> torch.Tensor:
    """x (..., k) @ w (k, n) in float32, the operands and the result handed
    to ``quant`` where it is given."""
    if quant is None:
        return x @ w
    x, w = quant(x, "activation"), quant(w, "weight")
    return quant(x @ w, "output")


def stream(x: torch.Tensor, quant=None) -> torch.Tensor:
    """The residual stream after an add, handed to ``quant`` where it is
    given."""
    return x if quant is None else quant(x, "stream")


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * w


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float
         ) -> torch.Tensor:
    """x (S, H, D) rotated by position: the first and second halves of D
    are the two coordinates of each of the D/2 frequencies.  The angles are
    taken in float64, then rounded once."""
    D = x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, D, 2, dtype=torch.float64,
                                       device=x.device) / D)
    ang = positions.to(torch.float64)[:, None] * inv[None, :]
    cos = torch.cos(ang).to(F32)[:, None, :]
    sin = torch.sin(ang).to(F32)[:, None, :]
    x1, x2 = x[..., :D // 2], x[..., D // 2:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
                     ) -> torch.Tensor:
    """q (S, Hq, D), k and v (S, Hkv, D) -> (S, Hq, D): softmax(q k^T /
    sqrt(D)) v over the keys at or before each query, each kv head shared
    by Hq / Hkv query heads; in blocks of query rows."""
    S, Hq, D = q.shape
    g = Hq // k.shape[1]
    k = k.repeat_interleave(g, dim=1).transpose(0, 1)        # (Hq, S, D)
    v = v.repeat_interleave(g, dim=1).transpose(0, 1)
    qh = q.transpose(0, 1) / math.sqrt(D)                     # (Hq, S, D)
    rows = max(1, SCORE_BLOCK_ELEMENTS // (Hq * S))
    out = torch.empty_like(qh)
    keys = torch.arange(S, device=q.device)
    for lo in range(0, S, rows):
        hi = min(S, lo + rows)
        s = qh[:, lo:hi] @ k[:, :hi].transpose(1, 2)           # (Hq, r, hi)
        later = keys[None, :hi] > torch.arange(lo, hi, device=q.device)[:, None]
        s.masked_fill_(later[None], float("-inf"))
        out[:, lo:hi] = torch.softmax(s, dim=-1) @ v[:, :hi]
    return out.transpose(0, 1)


def swiglu(x: torch.Tensor, w_gate, w_up, w_down, quant=None) -> torch.Tensor:
    return mm(F.silu(mm(x, w_gate, quant)) * mm(x, w_up, quant), w_down, quant)


def gqa_block(W, pre: str, x: torch.Tensor, cfg: dict, positions, quant=None):
    """Pre-norm GQA attention and SwiGLU MLP with residuals (a dense layer,
    or the hybrid's shared block).  Returns (x, k, v): the roped keys and
    the values (S, Hkv, hd) that a decode cache keeps."""
    d, H, Hkv = cfg["d_model"], cfg["n_heads"], cfg["n_kv_heads"]
    hd = d // H
    eps = cfg["norm_eps"]

    def w(name):
        return W[pre + name].to(F32)
    h = rms_norm(x, w("ln1"), eps)
    q = mm(h, w("attn.wq").reshape(d, H * hd), quant).reshape(-1, H, hd)
    k = mm(h, w("attn.wk").reshape(d, Hkv * hd), quant).reshape(-1, Hkv, hd)
    v = mm(h, w("attn.wv").reshape(d, Hkv * hd), quant).reshape(-1, Hkv, hd)
    q = rope(q, positions, cfg["rope_theta"])
    k = rope(k, positions, cfg["rope_theta"])
    o = causal_attention(q, k, v).reshape(-1, H * hd)
    x = stream(x + mm(o, w("attn.wo").reshape(H * hd, d), quant), quant)
    h = rms_norm(x, w("ln2"), eps)
    x = stream(x + swiglu(h, w("ffn.w_gate"), w("ffn.w_up"),
                          w("ffn.w_down"), quant), quant)
    return x, k, v


def head_logits(W, x: torch.Tensor, cfg: dict, quant=None) -> torch.Tensor:
    """The final norm and the output head: x (n, d) -> logits (n, V)."""
    h = rms_norm(x, W["ln_f"].to(F32), cfg["norm_eps"])
    return mm(h, W["head"].to(F32), quant)
