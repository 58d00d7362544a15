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


def _local_shard(t, sharding: NamedSharding):
    """This rank's shard of ``t`` (whole, the same on every rank) in
    ``sharding.placements``: a view, ``t`` itself where every sharded mesh
    dim has one rank."""
    mesh = sharding.mesh
    local = t
    for i, pl in enumerate(sharding.placements):
        n = mesh.size(i)
        if isinstance(pl, Shard) and n > 1:
            local = local.chunk(n, pl.dim)[mesh.get_local_rank(i)]
    return local


def place(t, sharding: NamedSharding):
    """``t``, whole and the same on every rank of ``sharding.mesh``, as a
    DTensor in ``sharding.placements``: each rank keeps its own shard, cut
    locally with no communication.  Where every sharded mesh dim has one
    rank the local tensor is ``t`` itself, not a copy."""
    local = _local_shard(t, sharding)
    if local is not t:
        local = local.clone()       # let the whole tensor go
    return DTensor.from_local(local, sharding.mesh, sharding.placements,
                              run_check=False, shape=t.shape,
                              stride=t.stride())


def gather_whole(t):
    """The whole value of a DTensor on every rank (an all-gather over each
    sharded mesh dim, or the local tensor itself where every sharded mesh
    dim has one rank); a plain tensor as it is."""
    if not isinstance(t, DTensor):
        return t
    if all(not isinstance(pl, Shard) or t.device_mesh.size(i) == 1
           for i, pl in enumerate(t.placements)):
        return t.to_local()
    return t.full_tensor()


def place_tree(tree: dict, shardings: dict[str, NamedSharding],
               resting: dict | None = None) -> dict:
    """Every leaf of ``tree`` (whole values) placed by its path's entry of
    ``shardings`` (as ``tree_shardings`` keys them).  Where ``resting``
    (a tree of the same paths) already holds a DTensor of that shape in
    those placements, the new shard is written into its local tensor and
    that DTensor is kept (nothing is written where the whole value was
    updated in place in it): no new DTensor a step."""
    old = paths_from_tree(resting) if resting is not None else {}

    def one(path, t):
        sh, prev = shardings[path], old.get(path)
        if not (isinstance(prev, DTensor) and prev.shape == t.shape
                and prev.placements == sh.placements):
            return place(t, sh)
        local, shard = prev.to_local(), _local_shard(t, sh)
        if shard.data_ptr() != local.data_ptr():
            local.copy_(shard)
        return prev
    return tree_map_paths(tree, one)


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
