"""Mesh construction (``repro.launch.mesh``) on ``torch.distributed``.

A mesh is a ``DeviceMesh`` over the ranks of the current process group,
which the caller starts (``torch.distributed.init_process_group``, with its
address, world size and rank): nothing here reads a cluster's environment.
"""
from __future__ import annotations

import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

from repro_torch.device import resolve_device


def _world_size(caller: str) -> int:
    if not dist.is_initialized():
        raise RuntimeError(f"{caller} needs a process group: call "
                           "torch.distributed.init_process_group first")
    return dist.get_world_size()


def make_production_mesh(*, multi_pod: bool = False, device=None):
    """The reference's production meshes over the current process group:
    (16, 16) ``("data", "model")`` on 256 ranks, or (2, 16, 16) ``("pod",
    "data", "model")`` on 512; raises on any other world size.  ``data`` is
    DP/FSDP, ``model`` TP/EP, ``pod`` pure DP across pods.  On the card
    unless ``device`` is ``"cpu"``, as ``make_host_mesh``.

    The shapes are the reference's, so every sharding can be held to its
    own.  They are a TPU pod's layout: on H100 nodes of 8 GPUs a 16-wide
    ``model`` axis spans two NVLink domains, and its collectives cross the
    nodes' network.  A mesh shaped for such nodes, such as (32, 8), is a
    layout the reference lacks and is not made here.
    """
    dev = resolve_device(device)
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = _world_size("make_production_mesh")
    want = 512 if multi_pod else 256
    if n != want:
        raise ValueError(f"the {'x'.join(map(str, shape))} production mesh "
                         f"needs {want} ranks, the process group has {n}")
    return init_device_mesh(dev.type, shape, mesh_dim_names=axes)


def make_host_mesh(n_model: int | None = None, device=None):
    """A (world size / n_model, n_model) ``("data", "model")`` mesh over
    every rank of the current process group, on the card unless ``device``
    is ``"cpu"`` (raises, as ``resolve_device`` does, when the card is asked
    for and absent).  ``n_model`` None: 1."""
    dev = resolve_device(device)
    n = _world_size("make_host_mesh")
    n_model = n_model or 1
    if n % n_model:
        raise ValueError(f"{n} ranks do not split into a model axis of "
                         f"{n_model}")
    return init_device_mesh(dev.type, (n // n_model, n_model),
                            mesh_dim_names=("data", "model"))
