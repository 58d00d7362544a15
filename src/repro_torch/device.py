"""Device selection for the port's entry points.

Every entry point takes ``device=`` and runs on the CUDA card unless the
caller asks for the CPU by name.  There is no silent fallback: a caller on a
machine without a card that did not pass ``device="cpu"`` gets an error, so a
run can never report CPU numbers under a device's name.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` -> the CUDA card; raises when CUDA is asked for but absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available on this machine; pass device='cpu' to run "
            "the port on the CPU")
    return dev


def resolve_use_kernel(use_kernel: bool | None, device) -> bool:
    """``None`` -> the hand-written kernels on CUDA, the reference's default
    (non-kernel) route on the CPU."""
    if use_kernel is None:
        return torch.device(device).type == "cuda"
    return bool(use_kernel)
