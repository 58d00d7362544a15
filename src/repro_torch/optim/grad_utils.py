"""Gradient utilities: global-norm clipping and the int8 compression codecs
(``repro.optim.grad_utils``; the codecs serve the quantized all-reduce of
``dist/``).

A tree is a dict of named tensors (nested dicts are flattened to dotted
paths) or an ``nn.Module``, whose parameters are its leaves.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.models.params import paths_from_tree


def _leaves(tree) -> dict[str, torch.Tensor]:
    """Named leaves in the reference's leaf order: sorted paths."""
    flat = (dict(tree.named_parameters()) if isinstance(tree, nn.Module)
            else paths_from_tree(tree))
    return {name: flat[name] for name in sorted(flat)}


def _sum_of_squares(leaves) -> torch.Tensor | None:
    total = None
    for leaf in leaves:
        s = torch.sum(torch.square(leaf.detach().to(torch.float32)))
        total = s if total is None else total + s
    return total


def global_norm(tree, sums: dict | None = None) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in float32: one sum a leaf,
    added up in sorted path order (the reference's per-leaf sums; its
    stacked layer leaves are one sum each, the port's per-layer leaves one
    each, so the two agree to float32 rounding, not bit for bit).

    ``sums``: for the path of each leaf that is a rank's block of a tensor
    cut over ranks (a tensor-parallel or an FSDP gradient), the in-place
    all-reduces that sum a value over the ranks it is cut over, one a mesh
    axis.  The leaves that share their all-reduces add their squares up
    first, in sorted path order, and each such part is summed through
    them once; every other leaf, the same on every rank, counts once."""
    sums = sums or {}
    parts: dict[tuple, list] = {}
    for name, leaf in _leaves(tree).items():
        parts.setdefault(sums.get(name, ()), []).append(leaf)
    total = None
    for fns, leaves in parts.items():
        part = _sum_of_squares(leaves)
        for fn in fns:
            part = fn(part.contiguous())
        total = part if total is None else total + part
    return torch.sqrt(total)


def clip_by_global_norm(tree, max_norm: float, sums: dict | None = None
                        ) -> tuple[dict[str, torch.Tensor], torch.Tensor]:
    """(the leaves scaled by min(1, max_norm / norm), each in its own dtype,
    as a flat dict of paths; the norm before clipping).  ``sums``: as
    ``global_norm`` takes it."""
    norm = global_norm(tree, sums)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return {name: (leaf.detach().to(torch.float32) * scale).to(leaf.dtype)
            for name, leaf in _leaves(tree).items()}, norm


def int8_scale(x: torch.Tensor, axis=None) -> torch.Tensor:
    """Symmetric int8 scale of ``x`` (per-tensor, or per-row via ``axis``)."""
    a = torch.abs(x.to(torch.float32))
    m = torch.amax(a) if axis is None else torch.amax(a, dim=axis)
    return m / 127.0 + 1e-12


def quantize_int8(x: torch.Tensor, scale=None
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 quantization -> (q, scale).  ``torch.round`` rounds
    half to even, as ``jnp.round`` does.  Pass ``scale`` to quantize against
    an externally agreed scale."""
    if scale is None:
        scale = int8_scale(x)
    q = torch.clamp(torch.round(x.to(torch.float32) / scale), -127, 127
                    ).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale) -> torch.Tensor:
    return q.to(torch.float32) * scale
