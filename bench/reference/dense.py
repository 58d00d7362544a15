"""The dense GQA family (Minitron) in plain float32: a stack of pre-norm
layers, each GQA attention with rotary positions and a SwiGLU MLP, then the
final norm and the head."""
from __future__ import annotations

import torch

from bench.reference.layers import F32, gqa_block, head_logits

# positions whose logits one product of the head takes
HEAD_ROWS = 256


def _stack(W, cfg: dict, tokens: torch.Tensor, kv_positions, quant):
    L = tokens.shape[0]
    positions = torch.arange(L, device=tokens.device)
    x = W["embedding"][tokens].to(F32)
    ks, vs = [], []
    for i in range(cfg["n_layers"]):
        x, k, v = gqa_block(W, f"layers.{i}.", x, cfg, positions, quant)
        if kv_positions is not None:
            ks.append(k[kv_positions])
            vs.append(v[kv_positions])
    return x, ks, vs


def prefill(W, cfg: dict, tokens: torch.Tensor, kv_positions: torch.Tensor,
            quant=None) -> dict:
    """One request's prefill: tokens (L,) -> {"logits": the last position's
    (V,), "k", "v": (n, len(kv_positions), Hkv, hd) at ``kv_positions``}."""
    x, ks, vs = _stack(W, cfg, tokens, kv_positions, quant)
    return {"logits": head_logits(W, x[-1:], cfg, quant)[0],
            "k": torch.stack(ks), "v": torch.stack(vs)}


def logits_from(W, cfg: dict, tokens: torch.Tensor, start: int,
                quant=None) -> torch.Tensor:
    """The logits (L - start, V) of positions start .. L - 1 of one
    sequence tokens (L,), each predicting the token after it."""
    x, _, _ = _stack(W, cfg, tokens, None, quant)
    x = x[start:]
    return torch.cat([head_logits(W, x[i:i + HEAD_ROWS], cfg, quant)
                      for i in range(0, x.shape[0], HEAD_ROWS)])
