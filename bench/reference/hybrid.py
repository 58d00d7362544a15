"""The hybrid family (Zamba2) in plain float32: a stack of Mamba2 layers
with one weight-shared GQA attention + SwiGLU block applied after every
``hybrid_attn_every``-th layer, then the final norm and the head.

A Mamba2 layer: h = RMSNorm(x); [z | xBC | dt] = h W_in; xBC goes through
a depthwise causal convolution of width K with a bias and SiLU and splits
into x (heads of P), B and C (one group of N); dt = softplus(dt + dt_bias),
A = -exp(A_log); the state-space recurrence s_t = exp(dt_t A) s_{t-1} +
dt_t x_t B_t^T, y_t = s_t C_t + D x_t; out = RMSNorm(y * SiLU(z)) W_out.
The recurrence is computed in chunks (the state-space duality form), which
is the same sum.

The decode state that a prefill hands on: each layer's final SSM state (H,
P, N), its last K - 1 inputs to the convolution, and each application of
the shared block's roped keys and values.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from bench.reference.layers import (F32, gqa_block, head_logits, mm,
                                    rms_norm, stream)

CHUNK = 256
# positions whose logits one product of the head takes
HEAD_ROWS = 256


def ssd(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, Bm: torch.Tensor,
        Cm: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """x (L, H, P), dt (L, H), A (H,), Bm and Cm (L, N) -> (y (L, H, P),
    the final state (H, P, N)), from a zero state."""
    L, H, P = x.shape
    N = Bm.shape[-1]
    state = torch.zeros(H, P, N, dtype=F32, device=x.device)
    ys = []
    for lo in range(0, L, CHUNK):
        hi = min(L, lo + CHUNK)
        a = torch.cumsum(dt[lo:hi] * A, dim=0)               # (Q, H), <= 0
        u = dt[lo:hi, :, None] * x[lo:hi]                     # (Q, H, P)
        seg = a[:, None, :] - a[None, :, :]                   # (Q, K, H)
        Q = hi - lo
        keep = torch.ones(Q, Q, dtype=torch.bool, device=x.device).tril()
        decay = torch.exp(seg.masked_fill(~keep[..., None], float("-inf")))
        cb = Cm[lo:hi] @ Bm[lo:hi].T                          # (Q, K)
        intra = torch.einsum("qkh,khp->qhp", decay * cb[..., None], u)
        inter = torch.einsum("qn,hpn->qhp", Cm[lo:hi], state) \
            * torch.exp(a)[..., None]
        ys.append(intra + inter)
        to_end = torch.exp(a[-1:] - a)                        # (Q, H)
        state = state * torch.exp(a[-1])[:, None, None] + torch.einsum(
            "khp,kn->hpn", to_end[..., None] * u, Bm[lo:hi])
    return torch.cat(ys, dim=0), state


def mamba2(W, pre: str, x: torch.Tensor, cfg: dict, quant=None):
    """One Mamba2 mixer on x (L, d), the residual not added.  Returns (out,
    final SSM state (H, P, N), the last K - 1 convolution inputs)."""
    d, N, P, K = cfg["d_model"], cfg["ssm_state"], cfg["ssm_head_dim"], \
        cfg["ssm_conv"]
    di = cfg["ssm_expand"] * d
    H = di // P
    L = x.shape[0]
    if cfg.get("mamba_ngroups", 1) != 1:
        raise NotImplementedError("the reference has one B/C group")

    def w(name):
        return W[pre + name].to(F32)
    proj = mm(x, w("w_in"), quant)
    z, xbc_in, dt = proj[:, :di], proj[:, di:2 * di + 2 * N], proj[:, 2 * di + 2 * N:]
    conv_w, conv_b = w("conv_w"), w("conv_b")                 # (K, C), (C,)
    padded = F.pad(xbc_in, (0, 0, K - 1, 0))
    xbc = F.silu(sum(padded[i:i + L] * conv_w[i] for i in range(K)) + conv_b)
    if quant is not None:                       # the scan's inputs
        xbc = quant(xbc, "output")
    xs = xbc[:, :di].reshape(L, H, P)
    Bm, Cm = xbc[:, di:di + N], xbc[:, di + N:]
    dt = F.softplus(dt + w("dt_bias"))
    A = -torch.exp(w("A_log"))
    y, state = ssd(xs, dt, A, Bm, Cm)
    y = y + xs * w("D")[None, :, None]
    if quant is not None:
        y = quant(y, "output")
    g = rms_norm(y.reshape(L, di) * F.silu(z), w("norm_w"), cfg["norm_eps"])
    return mm(g, w("w_out"), quant), state, xbc_in[L - (K - 1):]


def _stack(W, cfg: dict, tokens: torch.Tensor, kv_positions, quant):
    """The layers over tokens (L,): the stream (L, d) before the final
    norm, and each layer's decode state (the shared block's keys and values
    at ``kv_positions``; none where it is None)."""
    L = tokens.shape[0]
    positions = torch.arange(L, device=tokens.device)
    x = W["embedding"][tokens].to(F32)
    every = cfg["hybrid_attn_every"]
    ssm, conv, ks, vs = [], [], [], []
    for i in range(cfg["n_layers"]):
        pre = f"layers.{i}."
        h = rms_norm(x, W[pre + "ln"].to(F32), cfg["norm_eps"])
        out, s, c = mamba2(W, pre + "mixer.", h, cfg, quant)
        x = stream(x + out, quant)
        if kv_positions is not None:
            ssm.append(s)
            conv.append(c)
        if (i + 1) % every == 0:
            x, k, v = gqa_block(W, "shared_attn.", x, cfg, positions, quant)
            if kv_positions is not None:
                ks.append(k[kv_positions])
                vs.append(v[kv_positions])
    return x, (ssm, conv, ks, vs)


def prefill(W, cfg: dict, tokens: torch.Tensor, kv_positions: torch.Tensor,
            quant=None) -> dict:
    """One request's prefill: tokens (L,) -> {"logits": the last position's
    (V,), "ssm": (n, H, P, N), "conv": (n, K - 1, C), "k", "v": (n_attn,
    len(kv_positions), Hkv, hd) at ``kv_positions``}."""
    x, (ssm, conv, ks, vs) = _stack(W, cfg, tokens, kv_positions, quant)
    logits = head_logits(W, x[-1:], cfg, quant)[0]
    return {"logits": logits, "ssm": torch.stack(ssm),
            "conv": torch.stack(conv), "k": torch.stack(ks),
            "v": torch.stack(vs)}


def logits_from(W, cfg: dict, tokens: torch.Tensor, start: int,
                quant=None) -> torch.Tensor:
    """The logits (L - start, V) of positions start .. L - 1 of one
    sequence tokens (L,), each predicting the token after it: what a
    prefill of tokens[:start + 1] and decode steps through its cache
    give."""
    x, _ = _stack(W, cfg, tokens, None, quant)
    x = x[start:]
    return torch.cat([head_logits(W, x[i:i + HEAD_ROWS], cfg, quant)
                      for i in range(0, x.shape[0], HEAD_ROWS)])
