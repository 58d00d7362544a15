"""Training step + loop: gradient accumulation (microbatching), clipping,
AdamW, and step-time telemetry feeding the straggler detector
(``repro.train.loop``).

The parameters are the model's own (``nn.Parameter``s that
``init_train_state`` makes trainable); a step writes the new values into
them in place (``optim.adamw_update``).  The LM kernels take part in the
step through their ``torch.autograd.Function``s (``kernels.ops``): forward
on the card, backward by the plain version's vector-Jacobian product.
With a device mesh the step is data parallel over its ``data`` axis
(``make_train_step``'s ``mesh``), its optimizer state resting as DTensors.
"""
from __future__ import annotations

import dataclasses
import time

import torch
import torch.distributed as dist

from repro_torch.dist.collectives import (BucketPlan, bucketed_allreduce,
                                          flatten_grads, process_group,
                                          unflatten_grads)
from repro_torch.dist.sharding import (axis_sizes, default_rules,
                                       gather_whole, place_tree,
                                       tree_map_paths, tree_shardings)
from repro_torch.models.model import Model, loss_fn
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

    With a ``mesh`` (a ``DeviceMesh`` with a ``data`` dimension, such as
    ``launch.mesh.make_host_mesh`` gives), the sharded step, the
    counterpart of the reference's ``jax.jit(step, in_shardings=...)``:

    - every rank passes the same global batch; it splits into equal blocks
      along axis 0 over ``data``, and each rank takes its own (the
      reference's ``batch_sharding``); the ranks of one ``data``
      coordinate (a ``model`` axis) compute the same block;
    - each rank computes its block's gradients through the path above, on
      plain local tensors (the kernels launch by raw pointer and take no
      DTensor);
    - the gradients are averaged over ``data``: flattened to float32
      (``collectives.flatten_grads``), summed by
      ``collectives.bucketed_allreduce`` with ``plan`` (default: one
      chunk), divided by the ``data`` size and cast back to each
      parameter's dtype; the loss and the metrics are averaged likewise;
    - the optimizer state (the float32 master copy of the parameters, the
      moments, the step) rests between steps as DTensors in the
      placements ``tree_shardings(opt_state, opt_state_axes(axes))``
      gives (``step.shardings["opt_state"]``; a state of plain tensors is
      placed on the first call), and is gathered whole for the update;
    - the module's parameters, the compute copy in their own dtype, are
      kept whole on every rank for the forward; their placements
      (``step.shardings["params"]``) are where ``elastic.reshard_state``
      puts them.

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
    rules = default_rules(False)
    sizes = axis_sizes(mesh)
    if "data" not in sizes:
        raise ValueError(f"the mesh {sizes} has no 'data' dimension")
    n_data, coord = sizes["data"], mesh.get_local_rank("data")
    group = (mesh, "data")
    axes = model.param_axes()
    p_shard = tree_shardings(params, axes, mesh, rules)
    shapes = {"m": params, "v": params, "master": params,
              "step": torch.empty(())}
    o_shard = tree_shardings(shapes, opt_state_axes(axes), mesh, rules)

    def sharded(opt_state: dict, batch: dict):
        if any(v.shape[0] % n_data for v in batch.values()):
            raise ValueError(f"the batch does not split into {n_data} equal "
                             "blocks over 'data'")
        local = {k: v.chunk(n_data)[coord] for k, v in batch.items()}
        loss, metrics, grads = accumulate_grads(model, local, n_micro)
        flat, spec = flatten_grads(grads)
        del grads
        flat = bucketed_allreduce(flat, plan, group).div_(n_data)
        grads = unflatten_grads(flat, spec)
        del flat
        grads, gnorm = clip_by_global_norm(grads, tcfg.max_grad_norm)
        scalars = torch.stack([loss, metrics["ce"], metrics["aux"]])
        dist.all_reduce(scalars, group=process_group(group))
        loss, ce, aux = (scalars / n_data).unbind()
        whole = tree_map_paths(opt_state, lambda _, t: gather_whole(t))
        whole, metrics = update(whole, grads, gnorm, loss,
                                dict(metrics, ce=ce, aux=aux))
        return place_tree(whole, o_shard, opt_state), metrics

    sharded.shardings = {"params": p_shard, "opt_state": o_shard}
    return sharded


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
