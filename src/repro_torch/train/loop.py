"""Training step + loop: gradient accumulation (microbatching), clipping,
AdamW, and step-time telemetry feeding the straggler detector
(``repro.train.loop``).

The parameters are the model's own (``nn.Parameter``s that
``init_train_state`` makes trainable); a step writes the new values into
them in place (``optim.adamw_update``).  The LM kernels take part in the
step through their ``torch.autograd.Function``s (``kernels.ops``): forward
on the card, backward by the plain version's vector-Jacobian product.
"""
from __future__ import annotations

import dataclasses
import time

import torch

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


def make_train_step(model: Model, tcfg: TrainConfig):
    """Returns step(opt_state, batch) -> (opt_state, metrics); the model's
    parameters are updated in place.

    ``batch``: tensors on the model's device (``tokens``, ``labels`` and,
    for the vision stub, ``patch_embeds``).  With ``microbatches > 1`` the
    batch is split along axis 0; each part's gradients (in the parameters'
    dtype) accumulate in float32 with ``loss / n`` and the metrics / n, and
    the sum / n is cast to the parameters' dtype, as the reference's
    ``lax.scan`` body does.  Then the gradients are clipped to
    ``max_grad_norm``, the schedule is read at the step before the update,
    and AdamW runs."""
    n_micro = tcfg.microbatches
    params = dict(model.named_parameters())

    def step(opt_state: dict, batch: dict):
        if n_micro == 1:
            loss, metrics, grads = grads_of(model, batch)
        else:
            f32 = torch.float32
            dev = model.device
            if any(v.shape[0] % n_micro for v in batch.values()):
                raise ValueError(f"the batch does not split into {n_micro} "
                                 "equal microbatches")
            micro = {k: v.split(v.shape[0] // n_micro)
                     for k, v in batch.items()}
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
            grads = {n: (acc.pop(n) / n_micro).to(p.dtype)
                     for n, p in params.items()}
        grads, gnorm = clip_by_global_norm(grads, tcfg.max_grad_norm)
        lr_scale = cosine_schedule(opt_state["step"],
                                   warmup=tcfg.warmup_steps,
                                   total=tcfg.total_steps)
        _, opt_state = adamw_update(grads, opt_state, params, tcfg.opt,
                                    lr_scale)
        metrics = dict(metrics, loss=loss, grad_norm=gnorm, lr_scale=lr_scale)
        return opt_state, metrics

    return step


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
