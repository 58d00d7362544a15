"""AdamW with mixed-precision state (``repro.optim.adamw``).

``moment_dtype=bfloat16`` halves the optimizer state's bytes (the m/v
estimates tolerate bf16); the master copy of the parameters is float32.

The state is a dict of per-parameter tensors keyed by the parameters' names
(``Model.named_parameters()``), ``{"m", "v", "master"}``, and an int32
``step``.  ``adamw_update`` runs the reference's arithmetic leaf by leaf
and writes the results in place: the moments, the master and the
parameters themselves (in their own dtype), so that no tensor moves.  A
later decode graph needs the parameters at fixed addresses.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch
from torch import nn


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    moment_dtype: Any = torch.bfloat16
    master_dtype: Any = torch.float32


def _named(params) -> dict[str, torch.Tensor]:
    return (dict(params.named_parameters()) if isinstance(params, nn.Module)
            else dict(params))


def adamw_init(params, cfg: AdamWConfig, abstract: bool = False) -> dict:
    """Zero moments, a master copy of each parameter and step 0, on the
    parameters' device, or with ``abstract`` on the ``meta`` device
    (shapes and dtypes only).  ``params``: a dict of named tensors or a
    module."""
    named = _named(params)

    def dev(p):
        return torch.device("meta") if abstract else p.device

    def zeros(dtype):
        return {n: torch.zeros(p.shape, dtype=dtype, device=dev(p))
                for n, p in named.items()}

    master = {n: (torch.empty(p.shape, dtype=cfg.master_dtype, device="meta")
                  if abstract else
                  p.detach().to(cfg.master_dtype, copy=True))
              for n, p in named.items()}
    some = next(iter(named.values()))
    return {"m": zeros(cfg.moment_dtype), "v": zeros(cfg.moment_dtype),
            "master": master,
            "step": torch.zeros((), dtype=torch.int32, device=dev(some))}


@torch.no_grad()
def adamw_update(grads: dict[str, torch.Tensor], opt_state: dict, params,
                 cfg: AdamWConfig, lr_scale=1.0) -> tuple[dict, dict]:
    """One AdamW step over ``grads`` (a dict keyed like the state).
    Updates the moments, the master and ``params`` (a dict of named tensors
    or a module) in place and returns (params as a dict, the state with
    its new step)."""
    named = _named(params)
    f32 = torch.float32
    step = opt_state["step"] + 1
    b1, b2 = cfg.b1, cfg.b2
    bc1 = 1.0 - b1 ** step.to(f32)
    bc2 = 1.0 - b2 ** step.to(f32)
    lr = cfg.lr * lr_scale
    for name, g in grads.items():
        m, v = opt_state["m"][name], opt_state["v"][name]
        master = opt_state["master"][name]
        g32 = g.to(f32)
        m32 = b1 * m.to(f32) + (1 - b1) * g32
        v32 = b2 * v.to(f32) + (1 - b2) * g32 * g32
        mh = m32 / bc1
        vh = v32 / bc2
        new_master = master.to(f32) * (1.0 - lr * cfg.weight_decay) \
            - lr * mh / (torch.sqrt(vh) + cfg.eps)
        m.copy_(m32)
        v.copy_(v32)
        master.copy_(new_master)
        named[name].copy_(master)
    return named, dict(opt_state, step=step)
