"""Elastic scaling + failure recovery (``repro.train.elastic``), on one
device.

On node loss the runtime (1) picks the largest feasible mesh from the
surviving device pool, (2) restores the newest complete checkpoint and (3)
places the state on the devices.  The plan is pure and copied from the
reference.  The port has no mesh yet: ``recover`` plans, restores through
``checkpoint.ckpt`` and places the state on one device; carving a
multi-device mesh and resharding onto it wait for the port's ``dist/``.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.checkpoint.ckpt import restore_checkpoint
from repro_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class MeshPlan:
    shape: tuple[int, ...]
    axes: tuple[str, ...]
    n_devices: int


def plan_mesh(n_alive: int, *, model_parallel: int = 16,
              multi_pod: bool = False) -> MeshPlan:
    """Largest (data, model) mesh that fits the surviving devices.

    Keeps the model axis intact (weights must stay shardable) and shrinks the
    data axis to the largest power of two that fits — a failed host removes
    its devices, the job continues at reduced global batch.
    """
    if n_alive < model_parallel:
        # degrade model parallelism to the largest power-of-two divisor
        model_parallel = 1 << int(np.log2(max(n_alive, 1)))
    data = n_alive // model_parallel
    data = 1 << int(np.log2(max(data, 1)))           # power-of-two data axis
    return MeshPlan((data, model_parallel), ("data", "model"),
                    data * model_parallel)


def recover(ckpt_dir: str, device=None, *, model_parallel: int = 16
            ) -> tuple[MeshPlan, dict]:
    """Recovery on one surviving device: plan (a (1, 1) mesh), restore the
    newest complete checkpoint, place it on ``device`` (None: the card).
    Returns (plan, the restored tree)."""
    dev = resolve_device(device)
    plan = plan_mesh(1, model_parallel=model_parallel)
    return plan, restore_checkpoint(ckpt_dir, device=dev)
