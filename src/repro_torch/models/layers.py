"""Shared neural building blocks: RMSNorm, RoPE, Qwen2-VL's M-RoPE and
SwiGLU, as the JAX package computes them (``repro.models.layers``)."""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.trace import span


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-5
             ) -> torch.Tensor:
    with span("repro.rms_norm"):
        dt = x.dtype
        x = x.float()
        x = x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps)
        return (x * weight.float()).to(dt)


def rope_freqs(head_dim: int, theta: float) -> np.ndarray:
    return 1.0 / (theta ** (np.arange(0, head_dim, 2) / head_dim))


@functools.lru_cache(maxsize=None)
def _inv_freq(head_dim: int, theta: float, device: torch.device
              ) -> torch.Tensor:
    """``rope_freqs`` as float32 on ``device``, made once: a copy from
    host memory on every call would wait for the device each time."""
    return torch.tensor(rope_freqs(head_dim, theta), dtype=torch.float32,
                        device=device)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float
               ) -> torch.Tensor:
    """x: (B, S, H, D); positions: (B, S) absolute positions."""
    D = x.shape[-1]
    inv = _inv_freq(D, float(theta), x.device)
    ang = positions[..., None].float() * inv                   # (B, S, D/2)
    return _rotate(x, ang)


def _rotate(x: torch.Tensor, ang: torch.Tensor) -> torch.Tensor:
    """x (B, S, H, D) rotated by the angles ang (B, S, D/2) in float32,
    rounded once to x's dtype."""
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


@functools.lru_cache(maxsize=None)
def _section_ids(sections: tuple[int, int, int], device: torch.device
                 ) -> torch.Tensor:
    """The position stream (0 t, 1 h, 2 w) of each of the D/2 frequency
    slots, on ``device``, made once."""
    return torch.tensor(np.repeat(np.arange(3), sections), dtype=torch.long,
                        device=device)


def apply_mrope(x: torch.Tensor, positions3: torch.Tensor, theta: float,
                sections: tuple[int, int, int]) -> torch.Tensor:
    """Qwen2-VL multimodal RoPE.  x: (B, S, H, D); positions3: (3, B, S)
    temporal/height/width position ids.  The D/2 frequency slots are split
    into ``sections`` (t, h, w), and each slot rotates by its section's
    position stream.  Text tokens carry equal t/h/w ids, which reduces it
    to ``apply_rope``."""
    D = x.shape[-1]
    assert sum(sections) == D // 2, (sections, D)
    inv = _inv_freq(D, float(theta), x.device)                 # (D/2,)
    sec = _section_ids(tuple(sections), x.device)              # (D/2,)
    ang = positions3[..., None].float() * inv                  # (3, B, S, D/2)
    # slot j takes stream sec[j] (the reference's take_along_axis, axis 0)
    ang = torch.gather(ang, 0, sec.expand(1, *ang.shape[1:]))[0]
    return _rotate(x, ang)


def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
           w_down: torch.Tensor) -> torch.Tensor:
    """SwiGLU MLP: down( silu(x @ gate) * (x @ up) )."""
    g = F.silu(x @ w_gate)
    u = x @ w_up
    return (g * u) @ w_down
