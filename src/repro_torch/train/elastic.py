"""Elastic scaling + failure recovery (``repro.train.elastic``), on
``torch.distributed``.

On node loss the runtime (1) picks the largest feasible mesh from the
surviving ranks, (2) restores the newest complete checkpoint, and (3)
reshards the state onto the new mesh (``distribute_tensor`` with the new
placements — resharding is a data movement the checkpoint format is
agnostic to, since tensors are stored unsharded).  The plan is pure and
copied from the reference.  One surviving device is a (1, 1) mesh.  Every
rank of the current process group calls ``carve_mesh`` and ``recover``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import distribute_tensor

from repro_torch.checkpoint.ckpt import restore_checkpoint
from repro_torch.device import resolve_device
from repro_torch.dist.sharding import default_rules, tree_shardings
from repro_torch.models.params import paths_from_tree


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


def carve_mesh(plan: MeshPlan, ranks=None, device=None):
    """A ``DeviceMesh`` of ``plan.shape`` and ``plan.axes`` over the first
    ``plan.n_devices`` of ``ranks`` (default: every rank of the current
    process group), on the card unless ``device`` is ``"cpu"``."""
    dev = resolve_device(device)
    if ranks is None:
        ranks = range(dist.get_world_size())
    ranks = list(ranks)[:plan.n_devices]
    if len(ranks) < plan.n_devices:
        raise ValueError(f"{len(ranks)} ranks cannot carve a {plan.shape} "
                         "mesh")
    usable = torch.tensor(ranks, dtype=torch.int64).reshape(plan.shape)
    return DeviceMesh(dev.type, usable, mesh_dim_names=plan.axes)


def reshard_state(tree: dict, axes_by_path: dict, mesh, *, rules=None
                  ) -> dict:
    """Reshard restored (host) tensors onto a new mesh: every leaf of
    ``tree`` becomes a DTensor on ``mesh`` (moved to its device type) in
    the placements ``tree_shardings`` gives it, by ``distribute_tensor``
    (rank 0's value is scattered or broadcast).  Returns a flat
    {path: DTensor} dict, keyed as ``tree_shardings`` keys it."""
    shardings = tree_shardings(tree, axes_by_path, mesh,
                               rules or default_rules(False))
    flat = paths_from_tree(tree)
    return {path: distribute_tensor(flat[path].detach(), mesh,
                                    sh.placements)
            for path, sh in shardings.items()}


def recover(ckpt_dir: str, axes_by_path: dict, alive, *,
            model_parallel: int = 16, device=None):
    """Full recovery path: plan -> carve -> restore -> reshard.  ``alive``:
    the surviving ranks of the current process group (on the card unless
    ``device`` is ``"cpu"``).  Returns (plan, mesh, {path: DTensor})."""
    dev = resolve_device(device)
    plan = plan_mesh(len(alive), model_parallel=model_parallel)
    mesh = carve_mesh(plan, alive, dev)
    host_tree = restore_checkpoint(ckpt_dir, device="cpu")
    return plan, mesh, reshard_state(host_tree, axes_by_path, mesh)
