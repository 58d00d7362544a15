"""The served weights, made by the benchmark from the seed on the device.

``spec(cfg)`` lists every leaf of a configuration (the names the program's
parameters carry) with its shape and how it is drawn.  ``make(cfg, seed,
device)`` draws them all in bfloat16, the served type: every normal leaf
from a few calls into one flat buffer, then scaled in place; the per-head
decay and step-size leaves from one uniform call each.  The program and
the reference both take these tensors.

The draw follows a trained network's scales rather than any init rule of
the program: matrices N(0, 1/fan_in), the embedding N(0, 1), norm weights
1 + N(0, 0.1^2), the convolution's bias N(0, 0.1^2), Mamba2's A in [1, 16]
and its step size dt in [1e-3, 1e-1] (log-uniform), as Mamba2 draws them.
"""
from __future__ import annotations

import math

import torch

from bench import families

# leaves start at multiples of this many elements of the flat buffer
ALIGN = 64
# elements one call draws
DRAW = 1 << 30


def matrix(shape, fan_in):
    """A matrix leaf drawn N(0, 1/fan_in)."""
    return (tuple(shape), "normal", 1.0 / math.sqrt(fan_in))


def spec(cfg: dict) -> dict[str, tuple]:
    """{name: (shape, kind, std)} of every leaf, in the program's order:
    the embedding, the final norm and the head, then the family's layers
    (``bench.families``)."""
    d, V = cfg["d_model"], cfg["vocab_size"]
    out = {"embedding": ((V, d), "normal", 1.0), "ln_f": ((d,), "norm", 0.1),
           "head": matrix((d, V), d)}
    out.update(families.of(cfg).layers(cfg))
    return out


def n_params(cfg: dict) -> int:
    return sum(math.prod(shape) for shape, _, _ in spec(cfg).values())


def _uniform(n: int, lo: float, hi: float, gen, device) -> torch.Tensor:
    u = torch.rand(n, generator=gen, device=device, dtype=torch.float32)
    return lo + (hi - lo) * u


def make(cfg: dict, seed: int, device) -> dict[str, torch.Tensor]:
    """{name: bfloat16 tensor on ``device``}, the same for the same seed."""
    leaves = spec(cfg)
    gen = torch.Generator(device=device).manual_seed(seed)
    drawn = [n for n, (_, kind, _) in leaves.items()
             if kind in ("normal", "norm")]
    offsets, total = {}, 0
    for name in drawn:
        offsets[name] = total
        total += -(-math.prod(leaves[name][0]) // ALIGN) * ALIGN
    flat = torch.empty(total, device=device, dtype=torch.bfloat16)
    for lo in range(0, total, DRAW):
        flat[lo:lo + DRAW].normal_(generator=gen)
    out = {}
    for name, (shape, kind, std) in leaves.items():
        if name in offsets:
            t = flat[offsets[name]:offsets[name] + math.prod(shape)].view(shape)
            t.mul_(std)
            if kind == "norm":
                t.add_(1.0)
            out[name] = t
    for kind in ("A_log", "dt_bias"):
        names = [n for n, (_, k, _) in leaves.items() if k == kind]
        if not names:
            continue
        sizes = [math.prod(leaves[n][0]) for n in names]
        if kind == "A_log":             # A = exp(A_log) in [1, 16]
            vals = torch.log(_uniform(sum(sizes), 1.0, 16.0, gen, device))
        else:                           # softplus(dt_bias) = dt
            dt = torch.exp(_uniform(sum(sizes), math.log(1e-3),
                                    math.log(1e-1), gen, device))
            vals = dt + torch.log(-torch.expm1(-dt))
        for name, part in zip(names, vals.to(torch.bfloat16).split(sizes)):
            out[name] = part.view(leaves[name][0])
    for name, (shape, kind, _) in leaves.items():
        if kind == "ones":
            out[name] = torch.ones(shape, dtype=torch.bfloat16, device=device)
    return {name: out[name] for name in leaves}
