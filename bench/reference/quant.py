"""Lower precisions for the reference, as ``bench.reference.layers``
hands them what they may round (``kind``: "activation" and "weight", a
matrix product's operands; "output", its result; "stream", the residual
stream after an add).

``fp8``, the control's: float8 (e4m3) operands in every matrix product,
the step below the bfloat16 that the configurations state, and nothing
else rounded.  A weight takes one scale for the whole tensor, an
activation one scale a row (a token), each mapping its largest magnitude
onto float8's largest.

``bf16``, the witness's: the operands, the results and the residual
stream in bfloat16, where a bfloat16 program keeps them, so that the
reference in it reads the gaps that rounding alone gives a sound
program."""
from __future__ import annotations

import torch

FP8 = torch.float8_e4m3fn
FP8_MAX = float(torch.finfo(FP8).max)


def fp8(t: torch.Tensor, kind: str) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 under its scale, back in float32; a
    product's result and the stream as they are."""
    if kind in ("output", "stream"):
        return t
    if kind == "weight":
        amax = t.abs().amax()
    else:
        amax = t.abs().amax(dim=-1, keepdim=True)
    scale = amax.clamp(min=1e-30) / FP8_MAX
    return (t / scale).to(FP8).to(torch.float32) * scale


def bf16(t: torch.Tensor, kind: str) -> torch.Tensor:
    """``t`` rounded to bfloat16, back in float32, whatever its kind."""
    return t.to(torch.bfloat16).to(torch.float32)
