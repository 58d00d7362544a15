"""Named-axis sharding rules: logical parameter axes -> mesh axes
(``repro.dist.sharding``), on ``torch.distributed``'s ``DeviceMesh`` and
DTensor placements; and the fleet-slot partition rule of the sharded fleet
engine.

Every parameter records *logical* axis names when it is made
(``models/params.py``); this module maps them onto the physical mesh.  Two
invariants keep the mapping valid for every architecture x mesh cell:

  * **divisibility** — a dim is only sharded if the mesh-axis product divides
    it; otherwise it degrades to replicated and the degradation is recorded
    in the :class:`ShardingReport` (llama3's 40 query heads on a 16-way model
    axis, say, must not crash the launcher);
  * **one mesh axis per tensor** — a mesh axis may appear at most once in a
    spec; when two logical axes of one tensor map to the same mesh axis (MoE
    ``experts`` and ``expert_mlp`` both want ``model``), the first wins and
    the rest replicate.

A spec is a :class:`P` (the reference's ``PartitionSpec``: one entry per
tensor dim, a mesh axis name, a tuple of them, or None).  A
:class:`NamedSharding` pairs it with a mesh and gives the DTensor
``placements`` it implies: ``Shard(dim)`` on every mesh dim that a tensor
dim is split over (``("pod", "data")`` on dim 0 is ``Shard(0)`` on both),
``Replicate()`` on the rest.

The reference stacks each layer stack's leaves along a leading ``"layers"``
axis; the port keeps one tensor a layer.  ``tree_shardings`` therefore gives
a per-layer leaf (``layers.3.attn.wq``) the reference's stacked spec without
its leading entry, which is always replicated (no rule names ``"layers"``).
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any

import numpy as np
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.models.params import paths_from_tree, reference_path


class P(tuple):
    """A partition spec: one entry per tensor dim (a mesh axis name, a tuple
    of names, or None), compared entry by entry like the reference's
    ``jax.sharding.PartitionSpec``; ``P()`` is fully replicated."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


@dataclasses.dataclass
class ShardingReport:
    """Accumulates every dim that degraded to replicated, with the reason."""
    degraded: list = dataclasses.field(default_factory=list)

    def note(self, path: str, logical_axis: Any, why: str) -> None:
        self.degraded.append((path, logical_axis, why))


def default_rules(multi_pod: bool) -> dict[str, tuple[str, ...]]:
    """Logical axis -> tuple of mesh axes the dim shards over.

    ``data`` carries FSDP-style sharding of the residual/embed dim; ``model``
    carries tensor/expert parallelism; the multi-pod ``pod`` axis only ever
    splits the batch (pure data parallelism across pods).  Logical axes
    absent from the rules (``head_dim``, ``layers``, cache/seq axes, LoRA
    ranks) are replicated.
    """
    batch = ("pod", "data") if multi_pod else ("data",)
    return {
        "batch": batch,
        # fsdp-style weight sharding along the residual dim
        "embed": ("data",),
        # tensor parallelism
        "vocab": ("model",),
        "heads": ("model",),
        "kv_heads": ("model",),
        "heads_x_dim": ("model",),
        "mlp": ("model",),
        "inner": ("model",),
        "embed_out": ("model",),
        # expert parallelism (experts claim `model` first; the per-expert
        # mlp dim then degrades by the one-axis-per-tensor rule)
        "experts": ("model",),
        "expert_mlp": ("model",),
    }


def axis_sizes(mesh) -> dict[str, int]:
    """{mesh axis name: size} of a ``DeviceMesh`` (its dim names and
    shape), or ``mesh.shape`` itself where that is already such a mapping
    (a stand-in that builds no devices, as the tests pass)."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names:
        return dict(zip(names, mesh.shape))
    return dict(mesh.shape)


class CutMesh:
    """A stand-in for a ``DeviceMesh`` that ``Model.shard`` can cut a
    model on, on the meta device or filled: rank ``rank`` of every axis of
    ``shape`` (a mapping of axis sizes, read by ``axis_sizes``), and no
    process group (cutting needs none; a model cut over ``data`` on it
    raises at its first gather).  For counts and checks that need a rank's
    blocks and no ranks."""

    def __init__(self, shape: dict, rank: int = 0):
        self.shape, self.rank = dict(shape), rank

    def get_group(self, axis):
        return None

    def get_local_rank(self, axis):
        return self.rank


def spec_for(shape: tuple[int, ...], logical_axes: tuple, rules: dict,
             mesh, report: ShardingReport | None = None,
             path: str = "?") -> P:
    """The spec for one tensor, enforcing both invariants above.

    ``mesh`` is a ``DeviceMesh`` or anything ``axis_sizes`` reads.
    """
    sizes = axis_sizes(mesh)
    used: set[str] = set()
    entries: list = []
    for dim, name in zip(shape, logical_axes):
        assigned = rules.get(name) if name is not None else None
        axes = tuple(a for a in (assigned or ()) if a in sizes)
        if not axes:
            entries.append(None)
            continue
        if any(a in used for a in axes):
            if report is not None:
                report.note(path, name,
                            f"conflict mesh axes {axes} already used")
            entries.append(None)
            continue
        span = math.prod(sizes[a] for a in axes)
        if dim % span != 0:
            # Same degradation ladder as batch_sharding: drop outer axes
            # (pod first) until a divisible prefix remains, instead of
            # degrading straight to replicated.  An odd global batch on a
            # pod x data mesh still shards over data.
            kept = axes
            while kept and dim % math.prod(sizes[a] for a in kept) != 0:
                kept = kept[1:]
            if report is not None:
                if kept:
                    report.note(path, name,
                                f"partial: dim {dim} % mesh {span} != 0; "
                                f"dropped {axes[:len(axes) - len(kept)]}, "
                                f"kept {kept}")
                else:
                    report.note(path, name,
                                f"indivisible dim {dim} % mesh {span} != 0")
            if not kept:
                entries.append(None)
                continue
            axes = kept
        used.update(axes)
        entries.append(axes[0] if len(axes) == 1 else axes)
    while entries and entries[-1] is None:      # P("data") == spec, not
        entries.pop()                           # P("data", None, None)
    return P(*entries)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A mesh and a spec (the reference's ``jax.sharding.NamedSharding``)."""
    mesh: Any
    spec: P

    @functools.cached_property
    def placements(self) -> tuple:
        """The DTensor placements the spec implies, one per mesh dim in the
        mesh's order: ``Shard(d)`` where tensor dim d is split over that
        mesh axis, else ``Replicate()``."""
        dim_of = {}
        for d, entry in enumerate(self.spec):
            for axis in ((entry,) if isinstance(entry, str) else entry or ()):
                dim_of[axis] = d
        return tuple(Shard(dim_of[a]) if a in dim_of else Replicate()
                     for a in axis_sizes(self.mesh))


def replicated(mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def batch_sharding(mesh, *, ndim: int, batch_size: int | None = None
                   ) -> NamedSharding:
    """Shard dim 0 over the batch mesh axes (``pod`` x ``data`` when present).

    If ``batch_size`` is given and does not divide the full axis span, outer
    axes are dropped (pod first) until it does — a small smoke-run batch on a
    big mesh replicates rather than erroring.  ``ndim`` is accepted for call
    sites that build specs from shapes; trailing dims are always unsharded
    so it never changes the spec.
    """
    del ndim
    sizes = axis_sizes(mesh)
    axes = tuple(a for a in ("pod", "data") if a in sizes)
    while axes and batch_size is not None and \
            batch_size % math.prod(sizes[a] for a in axes) != 0:
        axes = axes[1:]
    if not axes:
        return replicated(mesh)
    return NamedSharding(mesh, P(axes[0] if len(axes) == 1 else axes))


def tree_shardings(tree, axes_by_path: dict[str, tuple], mesh, rules: dict,
                   report: ShardingReport | None = None
                   ) -> dict[str, NamedSharding]:
    """{path: NamedSharding} for every leaf of ``tree`` (a dict of tensors
    keyed by the port's names, nested dicts flattened to dotted paths, as
    ``paths_from_tree`` gives them), driven by the logical axes of
    ``axes_by_path`` (keyed by the reference's paths, as
    ``Model.param_axes`` and ``train.loop.opt_state_axes`` give them).

    A leaf found in ``axes_by_path`` under its own path takes that entry
    (the reference's stacked leaves); a per-layer leaf takes its stack's
    entry without the leading ``"layers"`` axis.  Leaves without a recorded
    axis entry (auxiliary state) replicate.
    """
    out = {}
    for path, leaf in paths_from_tree(tree).items():
        axes = axes_by_path.get(path)
        if axes is None:
            ref, stacked = reference_path(path)
            axes = axes_by_path.get(ref)
            if axes is not None and stacked:
                if not axes or axes[0] != "layers":
                    raise ValueError(f"{path}: the axes {axes} of its stack "
                                     f"{ref} do not lead with 'layers'")
                axes = axes[1:]
        if axes is None:
            out[path] = replicated(mesh)
        else:
            out[path] = NamedSharding(
                mesh, spec_for(tuple(leaf.shape), axes, rules, mesh, report,
                               path))
    return out


def tree_map_paths(tree: dict, fn, prefix: str = "") -> dict:
    """``tree`` with every leaf replaced by ``fn(path, leaf)``, the nesting
    kept; ``path`` is the leaf's dotted path, as ``paths_from_tree`` names
    it."""
    out = {}
    for k, v in tree.items():
        path = f"{prefix}.{k}" if prefix else k
        out[k] = (tree_map_paths(v, fn, path) if isinstance(v, dict)
                  else fn(path, v))
    return out


def _local_shard(t, sharding: NamedSharding, done: tuple = ()):
    """This rank's shard of ``t`` in ``sharding.placements``: a view, ``t``
    itself where every sharded mesh dim has one rank.  ``t`` is whole, the
    same on every rank, except along the mesh axes named in ``done``, where
    it is this rank's block already (a parameter cut over ``model`` by
    ``Model.shard``) and is not cut again."""
    mesh = sharding.mesh
    names = list(axis_sizes(mesh))
    local = t
    for i, pl in enumerate(sharding.placements):
        n = mesh.size(i)
        if isinstance(pl, Shard) and n > 1 and names[i] not in done:
            local = local.chunk(n, pl.dim)[mesh.get_local_rank(i)]
    return local


def _whole_shape(t, sharding: NamedSharding, done: tuple) -> tuple:
    """The whole shape of a tensor that is this rank's block along the
    mesh axes in ``done`` (equal blocks) and whole along the rest."""
    shape = list(t.shape)
    names = list(axis_sizes(sharding.mesh))
    for i, pl in enumerate(sharding.placements):
        if isinstance(pl, Shard) and names[i] in done:
            shape[pl.dim] *= sharding.mesh.size(i)
    return tuple(shape)


def _contiguous_strides(shape: tuple) -> tuple:
    strides, acc = [], 1
    for n in reversed(shape):
        strides.append(acc)
        acc *= max(n, 1)
    return tuple(reversed(strides))


def place(t, sharding: NamedSharding, done: tuple = ()):
    """``t``, whole and the same on every rank of ``sharding.mesh`` (but
    along the axes in ``done``, see ``_local_shard``), as a DTensor in
    ``sharding.placements``: each rank keeps its own shard, cut locally
    with no communication.  Where every sharded mesh dim has one rank the
    local tensor is ``t`` itself, not a copy."""
    local = _local_shard(t, sharding, done)
    if local is not t:
        local = local.clone()       # let the whole tensor go
    shape = _whole_shape(t, sharding, done)
    return DTensor.from_local(local, sharding.mesh, sharding.placements,
                              run_check=False, shape=shape,
                              stride=(t.stride() if shape == tuple(t.shape)
                                      else _contiguous_strides(shape)))


def place_tree(tree: dict, shardings: dict[str, NamedSharding],
               done: dict[str, tuple] | None = None) -> dict:
    """Every leaf of ``tree`` (whole values, or blocks along the axes that
    ``done`` gives for its path, see ``_local_shard``) placed by its path's
    entry of ``shardings`` (as ``tree_shardings`` keys them)."""
    done = done or {}
    return tree_map_paths(tree, lambda path, t: place(
        t, shardings[path], done.get(path, ())))


def batch_axes(mesh, batch_size: int | None = None) -> tuple[str, ...]:
    """The mesh axes ``batch_sharding`` splits a batch of ``batch_size``
    rows over, outer first: ``("pod", "data")``, ``("data",)`` or ``()``."""
    entry = batch_sharding(mesh, ndim=1, batch_size=batch_size).spec
    entry = entry[0] if entry else None
    return (entry,) if isinstance(entry, str) else tuple(entry or ())


def batch_block(mesh, batch_size: int) -> tuple[int, int]:
    """(this rank's block, the number of blocks) of a batch of
    ``batch_size`` rows split as ``batch_sharding`` splits it: the blocks
    are the axes' coordinates in row-major order (``pod`` outer), as the
    reference's ``P(("pod", "data"))`` lays dim 0 over the devices."""
    sizes = axis_sizes(mesh)
    index, count = 0, 1
    for axis in batch_axes(mesh, batch_size):
        index = index * sizes[axis] + mesh.get_local_rank(axis)
        count *= sizes[axis]
    return index, count


def slot_shard(slot_id: int, n_shards: int) -> int:
    """Shard owning one fleet slot: cyclic ``slot % n_shards``.

    The single source of the fleet-engine partition rule.  Cyclic (rather
    than contiguous-block) assignment keeps shards balanced as recovery
    re-admissions append new slots at the high end, and needs no
    divisibility negotiation — any fleet size lands within one slot of
    perfectly even.
    """
    return int(slot_id) % int(n_shards)


def slot_partition(n_slots: int, n_shards: int) -> np.ndarray:
    """Vectorized ``slot -> shard`` assignment for a whole admission wave.

    Row ``i`` is ``slot_shard(i, n_shards)``; the sharded fleet engine uses
    it to split event batches across per-shard frontiers.
    """
    if n_shards < 1:
        raise ValueError(f"n_shards must be >= 1, got {n_shards}")
    return np.arange(int(n_slots), dtype=np.int64) % int(n_shards)
