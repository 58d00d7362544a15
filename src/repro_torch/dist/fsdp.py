"""Fully sharded data parallelism over the mesh's ``data`` axis: the
port's counterpart of what GSPMD does to the reference's jitted step,
prefill and decode when ``default_rules`` shard a weight's ``embed`` dim
over ``data`` (``in_shardings=p_shard``: XLA's program never holds such a
weight whole).

What is cut is read from the rules, with no knob of its own: a parameter
whose ``spec_for`` (on its whole shape, ``SplitPlan.specs``) names
``data`` on a dim keeps its block of that dim (``shard_data``, in
``Model.shard`` after the ``model`` cut, on the meta device), recorded as
``p.data_cut = (dim, index, n)`` beside the ``model`` cut ``p.cut``.  A
leaf the rules leave whole over ``data`` (an indivisible dim, or a mesh
axis the tensor already uses) stays whole; the ``ShardingReport`` notes
it.  ``pod`` never cuts a weight: it only splits the batch.

For compute a block is gathered whole over the ``data`` group (the
``data`` ranks of this rank's ``pod`` and ``model`` coordinates) where it
is read, one layer at a time (``gathered``: a layer's parameters stand in
its module for the gathered tensors while it runs, and are dropped after),
by ``gather_param``: an all-gather forward whose backward reduce-scatters
(sums) the gradient back to the rank's block.  So a block's gradient
leaves the backward already summed over ``data``.  Under activation
checkpointing the gather sits inside the checkpointed function: the
recompute gathers again, and nothing whole over ``data`` is saved for the
backward.  There is no prefetch and no overlap of a gather with compute.

A model cut over ``data`` with no process group raises at its first
gather; it never runs whole.
"""
from __future__ import annotations

import contextlib

import torch
import torch.distributed as dist
from torch import nn

from repro_torch.dist.sharding import axis_sizes
from repro_torch.dist.tensor_parallel import ModelGroup
from repro_torch.models.params import cut_params

DATA = "data"


def _data_dim(spec) -> int | None:
    for dim, entry in enumerate(spec):
        axes = (entry,) if isinstance(entry, str) else entry or ()
        if DATA in axes:
            return dim
    return None


def shard_data(model, mesh):
    """Cut every parameter of ``model`` (made, and cut over ``model`` by
    ``shard_model``, on the meta device or filled) whose spec in
    ``model.split_plan`` shards a dim over ``data`` to this rank's block of
    that dim, and set ``model.fsdp`` to the ``data`` group (a
    ``ModelGroup``); returns ``model``.  A mesh whose ``data`` axis has one
    rank cuts nothing and leaves ``model.fsdp`` None."""
    n = axis_sizes(mesh).get(DATA, 1)
    if n == 1:
        return model
    rank = mesh.get_local_rank(DATA)
    cuts = {}
    for name, spec in model.split_plan.specs.items():
        dim = _data_dim(spec)
        if dim is not None:
            cuts[name] = (dim, rank, n)
    cut_params(model, cuts, record="data_cut")
    model.fsdp = ModelGroup(mesh.get_group(DATA), n, rank)
    return model


def describe(model) -> str:
    """One line: how many parameters are cut over ``data`` and how many
    stay whole."""
    if model.fsdp is None:
        return "data axis 1: no weight cut"
    params = dict(model.named_parameters())
    cut = sum(hasattr(p, "data_cut") for p in params.values())
    return (f"data axis {model.fsdp.size}: {cut} of {len(params)} weights "
            f"cut (embed), {len(params) - cut} whole")


def weight_gather_bytes(model, n_micro: int) -> int:
    """The bytes a train step's all-gathers write on a rank of ``model``,
    cut over ``data`` (``shard_data``), in ``n_micro`` microbatches, where
    they gather only its weights cut over ``data``: each layer's whole in
    each microbatch's forward, and again in its remat recompute
    (``cfg.remat``); the others (the embedding, ``ln_f``, the head) once
    a microbatch."""
    layers = top = 0
    for name, p in model.named_parameters():
        if hasattr(p, "data_cut"):
            gathered = p.numel() * p.data_cut[2] * p.element_size()
            if name.startswith(("layers.", "dense_layers.")):
                layers += gathered
            else:
                top += gathered
    return n_micro * ((2 if model.cfg.remat else 1) * layers + top)


def all_gather_dim(t: torch.Tensor, dg: ModelGroup, dim: int) -> torch.Tensor:
    """Every rank's ``t`` concatenated along ``dim`` in rank order, a
    contiguous tensor (one ``all_gather_into_tensor`` along dim 0)."""
    moved = t.movedim(dim, 0).contiguous()
    out = moved.new_empty((dg.size * moved.shape[0],) + moved.shape[1:])
    dist.all_gather_into_tensor(out, moved, group=dg.group)
    return out.movedim(0, dim).contiguous()


def reduce_scatter(g: torch.Tensor, dg: ModelGroup, dim: int) -> torch.Tensor:
    """The sum of ``g`` over the group, this rank's block of ``dg.size``
    equal blocks along ``dim``."""
    moved = g.movedim(dim, 0).contiguous()
    out = moved.new_empty((moved.shape[0] // dg.size,) + moved.shape[1:])
    dist.reduce_scatter_tensor(out, moved, group=dg.group)
    return out.movedim(0, dim).contiguous()


class _GatherParam(torch.autograd.Function):
    """All-gather forward along the cut dim; backward the gradient summed
    over the group, this rank's block kept (a reduce-scatter)."""

    @staticmethod
    def forward(ctx, block, dg, dim):
        ctx.dg, ctx.dim = dg, dim
        return all_gather_dim(block, dg, dim)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter(g, ctx.dg, ctx.dim), None, None


def gather_param(p: torch.Tensor, dg: ModelGroup) -> torch.Tensor:
    """The value of parameter ``p``, this rank's block over ``data``
    (``p.data_cut``), gathered whole over ``data``: the blocks concatenated
    in rank order, bit for bit the uncut value.  Recorded by autograd
    (``_GatherParam``) where ``p`` requires grad."""
    if dg is None or dg.group is None:
        raise RuntimeError("a parameter cut over data needs the data "
                           "group to gather it; this model has none")
    dim = p.data_cut[0]
    if torch.is_grad_enabled() and p.requires_grad:
        return _GatherParam.apply(p, dg, dim)
    return all_gather_dim(p.detach(), dg, dim)


def whole(p: torch.Tensor, dg: ModelGroup | None) -> torch.Tensor:
    """``p`` gathered over ``data`` where it is cut over it, else ``p``."""
    return gather_param(p, dg) if hasattr(p, "data_cut") else p


@contextlib.contextmanager
def gathered(module: nn.Module, dg: ModelGroup | None):
    """Context: every parameter of ``module`` cut over ``data`` replaced in
    its owner by its gathered value (``gather_param``, in the order of
    ``module.modules()``, the same on every rank) and put back on exit, so
    that the gathered tensors are dropped when the block ends.  With ``dg``
    None (a model not cut over ``data``) nothing changes."""
    swapped = []
    try:
        if dg is not None:
            for owner in module.modules():
                for leaf, p in list(owner._parameters.items()):
                    if p is not None and hasattr(p, "data_cut"):
                        owner._parameters[leaf] = gather_param(p, dg)
                        swapped.append((owner, leaf, p))
        yield module
    finally:
        for owner, leaf, p in swapped:
            owner._parameters[leaf] = p


__all__ = ["DATA", "all_gather_dim", "describe", "gather_param", "gathered",
           "reduce_scatter", "shard_data", "weight_gather_bytes", "whole"]
