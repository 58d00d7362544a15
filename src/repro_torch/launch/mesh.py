"""Mesh construction (``repro.launch.mesh``) on ``torch.distributed``.

A mesh is a ``DeviceMesh`` over the ranks of the current process group,
which the caller starts (``torch.distributed.init_process_group``, with its
address, world size and rank): nothing here reads a cluster's environment.
The reference's production mesh (``make_production_mesh``) is a TPU pod's
layout and comes with the port's launch tooling.
"""
from __future__ import annotations

import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

from repro_torch.device import resolve_device


def make_host_mesh(n_model: int | None = None, device=None):
    """A (world size / n_model, n_model) ``("data", "model")`` mesh over
    every rank of the current process group, on the card unless ``device``
    is ``"cpu"`` (raises, as ``resolve_device`` does, when the card is asked
    for and absent).  ``n_model`` None: 1."""
    dev = resolve_device(device)
    if not dist.is_initialized():
        raise RuntimeError("make_host_mesh needs a process group: call "
                           "torch.distributed.init_process_group first")
    n = dist.get_world_size()
    n_model = n_model or 1
    if n % n_model:
        raise ValueError(f"{n} ranks do not split into a model axis of "
                         f"{n_model}")
    return init_device_mesh(dev.type, (n // n_model, n_model),
                            mesh_dim_names=("data", "model"))
