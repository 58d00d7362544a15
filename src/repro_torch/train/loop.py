"""Training step + loop: gradient accumulation (microbatching), clipping,
AdamW, and step-time telemetry feeding the straggler detector
(``repro.train.loop``).

The parameters are the model's own (``nn.Parameter``s that
``init_train_state`` makes trainable); a step writes the new values into
them in place (``optim.adamw_update``).  The LM kernels take part in the
step through their ``torch.autograd.Function``s (``kernels.ops``): forward
on the card, backward by the plain version's vector-Jacobian product.
With a device mesh the step is data parallel over its batch axes
(``pod`` and ``data``) and, for a model cut by ``Model.shard``, tensor
parallel over its ``model`` axis and fully sharded over ``data``
(``make_train_step``'s ``mesh``), its optimizer state resting as
DTensors in the reference's placements, each rank's local tensors the
blocks of its parameters.
"""
from __future__ import annotations

import dataclasses
import math
import time

import numpy as np
import torch
import torch.distributed as dist

from torch.distributed.tensor import DTensor

from repro_torch.dist.collectives import (BucketPlan, bucketed_allreduce,
                                          flatten_grads, process_group,
                                          unflatten_grads)
from repro_torch.dist.fsdp import DATA
from repro_torch.dist.sharding import (axis_sizes, batch_block,
                                       default_rules,
                                       place_tree, tree_map_paths,
                                       tree_shardings)
from repro_torch.dist.tensor_parallel import MODEL, ModelGroup, model_group
from repro_torch.dist.tensor_parallel import all_reduce as tp_all_reduce
from repro_torch.models.model import Model, loss_fn
from repro_torch.models.moe import BatchRouting, routed_over
from repro_torch.models.params import whole_shape
from repro_torch.optim import (AdamWConfig, adamw_init, adamw_update,
                               clip_by_global_norm, cosine_schedule)


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    opt: AdamWConfig = dataclasses.field(default_factory=AdamWConfig)
    max_grad_norm: float = 1.0
    microbatches: int = 1          # gradient accumulation steps
    warmup_steps: int = 100
    total_steps: int = 10_000


def grads_of(model: Model, batch: dict):
    """(loss, metrics, {name: gradient in the parameter's dtype}) of one
    forward and backward of ``loss_fn``; a parameter the loss does not
    read gets zeros, as in the reference, and every ``.grad`` is cleared
    after."""
    loss, metrics = loss_fn(model, batch)
    loss.backward()
    grads = {}
    for name, p in model.named_parameters():
        grads[name] = p.grad if p.grad is not None else torch.zeros_like(p)
        p.grad = None
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, grads


def accumulate_grads(model: Model, batch: dict, n_micro: int):
    """(loss, metrics, {name: gradient in the parameter's dtype}) of
    ``batch``: one ``grads_of``, or with ``n_micro > 1`` the batch split
    along axis 0, each part's gradients (in the parameters' dtype)
    accumulated in float32 with ``loss / n`` and the metrics / n, and the
    sum / n cast to the parameters' dtype, as the reference's ``lax.scan``
    body does."""
    if n_micro == 1:
        return grads_of(model, batch)
    params = dict(model.named_parameters())
    f32 = torch.float32
    dev = model.device
    if any(v.shape[0] % n_micro for v in batch.values()):
        raise ValueError(f"the batch does not split into {n_micro} "
                         "equal microbatches")
    micro = {k: v.split(v.shape[0] // n_micro) for k, v in batch.items()}
    loss = torch.zeros((), dtype=f32, device=dev)
    metrics = {"ce": torch.zeros((), dtype=f32, device=dev),
               "aux": torch.zeros((), dtype=f32, device=dev)}
    acc = {n: torch.zeros(p.shape, dtype=f32, device=dev)
           for n, p in params.items()}
    for i in range(n_micro):
        mb = {k: parts[i] for k, parts in micro.items()}
        l_i, m_i, g_i = grads_of(model, mb)
        for n, g in g_i.items():
            acc[n] += g.to(f32)
        del g_i
        loss = loss + l_i / n_micro
        metrics = {k: metrics[k] + m_i[k] / n_micro for k in metrics}
    grads = {n: (acc.pop(n) / n_micro).to(p.dtype) for n, p in params.items()}
    return loss, metrics, grads


def make_train_step(model: Model, tcfg: TrainConfig, mesh=None,
                    plan: BucketPlan | None = None):
    """Returns step(opt_state, batch) -> (opt_state, metrics); the model's
    parameters are updated in place.

    ``batch``: tensors on the model's device (``tokens``, ``labels`` and,
    for the vision stub, ``patch_embeds``).  With ``microbatches > 1`` the
    batch is split along axis 0 (``accumulate_grads``).  Then the
    gradients are clipped to ``max_grad_norm``, the schedule is read at the
    step before the update, and AdamW runs.

    With a ``mesh`` (a ``DeviceMesh`` with a ``data`` dimension, and
    optionally ``pod`` and ``model`` ones, such as
    ``launch.mesh.make_host_mesh`` and ``make_production_mesh`` give), the
    sharded step, the counterpart of the reference's ``jax.jit(step,
    in_shardings=...)``:

    - every rank passes the same global batch; it splits into equal blocks
      along axis 0 over the batch axes ``batch_sharding`` picks for it
      (``("pod", "data")`` where the mesh has ``pod``, else ``("data",)``,
      outer axes dropped where the rows do not divide), and each rank
      takes its own (``sharding.batch_block``: the rows the reference's
      ``batch_sharding`` gives it) of each microbatch: the global batch
      splits into microbatches first, as the reference's step splits it
      (``rank_rows``); the ranks of one batch coordinate (a ``model``
      axis) compute the same block;
    - a mixture of experts routes each microbatch as the reference's
      program over the whole microbatch does (``models.moe.routed_over``
      the batch group: the whole microbatch's capacity, drops and
      load-balance loss);
    - the model must be cut on the mesh as its rules shard it
      (``build_model(mesh=)`` or ``Model.shard``): a parameter whose spec
      names a mesh axis of more than one rank that it is not cut over
      raises ValueError;
    - a model split over ``model`` computes its block's gradients
      tensor-parallel, each rank its own block of every split parameter's
      gradient (``dist.tensor_parallel``);
    - a model cut over ``data`` (``Model.shard``, ``dist.fsdp``) gathers
      each layer's weights whole over ``data`` for its compute and
      reduce-scatters their gradients back, so that such a leaf's gradient
      leaves the backward as the rank's block, summed over ``data``;
    - each rank computes through the path above, on plain local tensors
      (the kernels launch by raw pointer and take no DTensor);
    - the gradients are averaged over the batch axes only: flattened to
      float32 (``collectives.flatten_grads``), the leaves whole over
      ``data`` summed over the batch group by
      ``collectives.bucketed_allreduce`` with ``plan`` (default: one
      chunk), the leaves cut over ``data`` over ``pod`` alone (where the
      mesh has it; the backward summed them over ``data``), each divided
      by the batch group's size and cast back to each parameter's dtype;
      a gradient is never summed over ``model``; the loss and the metrics
      are averaged likewise;
    - the clip's global norm sums each leaf's squares over the axes it is
      cut on (``model``, ``data``, both) once and each other leaf's once;
    - the module's parameters, the compute copy in their own dtype, rest
      as each rank's blocks: cut over ``model`` where ``Model.shard``
      split them and over ``data`` where it cut them, whole otherwise;
      their reference placements (``step.shardings["params"]``) are where
      ``elastic.reshard_state`` puts them;
    - the optimizer state (the float32 master copy of the parameters, the
      moments, the step) rests between steps as DTensors in the
      placements ``tree_shardings(opt_state, opt_state_axes(axes))``
      gives on the parameters' whole shapes (``step.shardings
      ["opt_state"]``; a state of plain tensors, each leaf shaped as its
      parameter, is placed on the first call, or by ``step.place``): each
      rank's local tensor is shaped as its block of the parameter, so
      AdamW updates the local tensors in place and no leaf is gathered or
      placed again.

    On one rank every sum, division and cast above is exact, so the
    sharded step equals the unsharded one bit for bit.
    """
    n_micro = tcfg.microbatches
    params = dict(model.named_parameters())

    def update(opt_state, grads, gnorm, loss, metrics):
        """The schedule and AdamW on clipped gradients.  The callers clip,
        so that the unclipped gradients are freed before the update."""
        lr_scale = cosine_schedule(opt_state["step"],
                                   warmup=tcfg.warmup_steps,
                                   total=tcfg.total_steps)
        _, opt_state = adamw_update(grads, opt_state, params, tcfg.opt,
                                    lr_scale)
        metrics = dict(metrics, loss=loss, grad_norm=gnorm, lr_scale=lr_scale)
        return opt_state, metrics

    if mesh is None:
        def step(opt_state: dict, batch: dict):
            loss, metrics, grads = accumulate_grads(model, batch, n_micro)
            grads, gnorm = clip_by_global_norm(grads, tcfg.max_grad_norm)
            return update(opt_state, grads, gnorm, loss, metrics)
        return step

    plan = plan or BucketPlan()
    sizes = axis_sizes(mesh)
    if "data" not in sizes:
        raise ValueError(f"the mesh {sizes} has no 'data' dimension")
    rules = default_rules("pod" in sizes)
    group = _batch_group(mesh)
    n_batch = math.prod(sizes[a] for a in ("pod", "data") if a in sizes)
    axes = model.param_axes()
    whole = {n: torch.empty(whole_shape(p), dtype=p.dtype, device="meta")
             for n, p in params.items()}
    p_shard = tree_shardings(whole, axes, mesh, rules)
    # the mesh axes each parameter is cut over: ``model`` where
    # ``Model.shard`` split it, ``data`` where it cut it
    cut_over = {n: (MODEL,) * hasattr(p, "cut") +
                (DATA,) * hasattr(p, "data_cut") for n, p in params.items()}
    for n, sh in p_shard.items():
        uncut = [a for a in _spec_axes(sh.spec)
                 if sizes[a] > 1 and a not in cut_over[n]]
        if uncut:
            raise ValueError(
                f"{n} rests whole over {uncut}, which the mesh's rules "
                f"shard it over ({sh.spec}): cut the model on this mesh "
                f"(build_model(mesh=) or Model.shard) before making its "
                f"sharded step")
    done = {f"{k}.{n}": cut_over[n] for k in ("m", "v", "master")
            for n in params}
    shapes = {"m": whole, "v": whole, "master": whole,
              "step": torch.empty(())}
    o_shard = tree_shardings(shapes, opt_state_axes(axes), mesh, rules)
    mg = model_group(model)
    pod = (mesh, "pod") if "pod" in sizes else None

    def sum_over_model(t):
        return tp_all_reduce(t, mg)

    def sum_over_data(t):
        return tp_all_reduce(t, model.fsdp)

    sum_over = {MODEL: sum_over_model, DATA: sum_over_data}
    sums = {n: tuple(sum_over[a] for a in cut) for n, cut in cut_over.items()
            if cut}

    def averaged(grads: dict, over) -> dict:
        """``grads`` summed over the group ``over`` (None: as they are)
        and divided by the batch group's size, through float32; ``grads``
        is emptied once flattened, so that its tensors can be freed."""
        if not grads:
            return {}
        flat, spec = flatten_grads(grads)
        grads.clear()
        if over is not None:
            flat = bucketed_allreduce(flat, plan, over)
        return unflatten_grads(flat.div_(n_batch), spec)

    def place(opt_state: dict) -> dict:
        return place_tree(opt_state, o_shard, done=done)

    def sharded(opt_state: dict, batch: dict):
        if not isinstance(opt_state["step"], DTensor):
            opt_state = place(opt_state)
        rows = next(iter(batch.values())).shape[0]
        index, count = batch_block(mesh, rows)
        local = {k: rank_rows(v, n_micro, index, count)
                 for k, v in batch.items()}
        with routed_over(model, batch_routing(group, index, count)):
            loss, metrics, grads = accumulate_grads(model, local, n_micro)
        # in the parameters' order, the same on every rank
        blocks = {n: grads.pop(n) for n in params if DATA in cut_over[n]}
        grads = averaged(grads, group)
        grads.update(averaged(blocks, pod))
        grads, gnorm = clip_by_global_norm(grads, tcfg.max_grad_norm, sums)
        scalars = torch.stack([loss, metrics["ce"], metrics["aux"]])
        dist.all_reduce(scalars, group=process_group(group))
        loss, ce, aux = (scalars / n_batch).unbind()
        resting = tree_map_paths(opt_state, lambda _, t: t.to_local())
        new, metrics = update(resting, grads, gnorm, loss,
                              dict(metrics, ce=ce, aux=aux))
        resting["step"].copy_(new["step"])
        return opt_state, metrics

    sharded.shardings = {"params": p_shard, "opt_state": o_shard}
    sharded.place = place
    return sharded


def _spec_axes(spec) -> tuple:
    """The mesh axes a partition spec names, in order."""
    return tuple(a for entry in spec
                 for a in ((entry,) if isinstance(entry, str) else entry or ()))


def rank_rows(t: torch.Tensor, n_micro: int, index: int, count: int
              ) -> torch.Tensor:
    """This rank's rows of a global batch ``t`` for ``n_micro``
    microbatches: block ``index`` of ``count`` of each of the ``n_micro``
    microbatches the reference's step splits ``t`` into, in microbatch
    order, so that ``accumulate_grads``'s split of them gives microbatch
    m's block as its m-th part."""
    rows = t.shape[0]
    if rows % (n_micro * count):
        raise ValueError(f"a batch of {rows} rows does not split into "
                         f"{n_micro} microbatches of {count} equal blocks")
    if n_micro == 1:
        return t.chunk(count)[index]
    return t.unflatten(0, (n_micro, count, -1))[:, index].flatten(0, 1)


def batch_routing(group, index: int, count: int) -> BatchRouting | None:
    """The MoE routing over a batch split into ``count`` blocks over the
    batch group ``group`` (``_batch_group``), this rank holding block
    ``index``; None where the rows do not split (``count`` 1: every rank
    holds the whole batch)."""
    if count == 1:
        return None
    pg = process_group(group)
    mg = ModelGroup(pg, dist.get_world_size(pg), dist.get_rank(pg))
    return BatchRouting(mg, index, count)


def _batch_group(mesh):
    """The process group over the mesh's batch axes at this rank's other
    coordinates: ``(mesh, "data")`` without ``pod``, else a group over the
    ranks of this rank's ``pod`` x ``data`` block."""
    sizes = axis_sizes(mesh)
    if "pod" not in sizes:
        return (mesh, "data")
    # the rank grid as host ints, outside any dispatch mode: the dry run
    # builds its step under a fake-tensor mode, which refuses the mesh's
    # real rank tensor
    from torch.utils._python_dispatch import _disable_current_modes
    with _disable_current_modes():
        ranks = np.array(mesh.mesh.tolist())
    names = list(mesh.mesh_dim_names)
    order = [names.index("pod"), names.index("data")] + [
        i for i in range(len(names)) if names[i] not in ("pod", "data")]
    blocks = ranks.transpose(order).reshape(sizes["pod"] * sizes["data"], -1)
    group, _ = dist.new_subgroups_by_enumeration(
        [blocks[:, j].tolist() for j in range(blocks.shape[1])])
    return group


def opt_state_axes(params_axes: dict[str, tuple]) -> dict[str, tuple]:
    """Optimizer-state logical axes mirror the parameter axes."""
    out = {}
    for name in ("m", "v", "master"):
        for path, ax in params_axes.items():
            out[f"{name}.{path}"] = ax
    out["step"] = ()
    return out


def init_train_state(model: Model, seed: int, tcfg: TrainConfig,
                     abstract: bool = False) -> tuple[dict, dict]:
    """Fill the model's parameters from ``seed`` (``Model.init``), make
    them trainable, and make the AdamW state: (parameters by name,
    optimizer state).  With ``abstract`` the parameters are left as they
    are and the state is made on the ``meta`` device."""
    if not abstract:
        model.init(seed)
    model.requires_grad_(True)
    params = dict(model.named_parameters())
    return params, adamw_init(params, tcfg.opt, abstract=abstract)


class Trainer:
    """Host-side loop: data in, metrics out, step-time telemetry recorded.

    The model carries its device (``build_model``'s explicit ``device``);
    ``seed`` fills its parameters.  Each step's time ends in a device
    synchronise on the card."""

    def __init__(self, model: Model, tcfg: TrainConfig, seed: int):
        self.model = model
        self.tcfg = tcfg
        self.params, self.opt_state = init_train_state(model, seed, tcfg)
        self.step_fn = make_train_step(model, tcfg)
        self.step_times: list[float] = []
        self.metrics_log: list[dict] = []
        self.step = 0

    def _sync(self) -> None:
        if self.model.device.type == "cuda":
            torch.cuda.synchronize(self.model.device)

    def run(self, batches, *, on_step=None) -> list[dict]:
        """``batches``: dicts of numpy arrays or tensors, moved to the
        model's device inside the timed step (the reference's step takes
        host arrays too)."""
        dev = self.model.device
        for batch in batches:
            self._sync()
            t0 = time.perf_counter()
            batch = {k: torch.as_tensor(v).to(dev) for k, v in batch.items()}
            self.opt_state, metrics = self.step_fn(self.opt_state, batch)
            self._sync()
            dt = time.perf_counter() - t0
            self.step_times.append(dt)
            m = {k: float(v) for k, v in metrics.items()}
            m["step_time_s"] = dt
            m["step"] = self.step
            self.metrics_log.append(m)
            if on_step is not None:
                on_step(self.step, m)
            self.step += 1
        return self.metrics_log
