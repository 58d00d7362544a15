"""Parameter construction, the reference's init rule, and the weight carrier
from the JAX package's parameter trees.

Every parameter is made through ``InitCtx.param``, which allocates it on the
model's device and records how the JAX package initialises it;
``init_params`` then fills every parameter from one ``torch.Generator``.
The rule is the reference's as it is (``repro.models.params.InitCtx.param``
and ``repro.models.model.Model.init``):

- ``normal`` draws N(0, 1) in float32 times ``scale``, then casts to the
  parameter's dtype; ``scale=None`` means 1/sqrt(fan_in), with fan_in the
  leading dimension of the shape;
- a layer of a stack (``InitCtx(stack=n)``) takes its parameters as one
  (n, ...) leaf would be made: its kind from the leaf's name
  (``_leaf_init``), its per-leaf ``scale`` dropped, and its fan-in the
  leading dimension of the stacked shape, i.e. the layer count n.  A
  stacked ``w_in`` of zamba2-7b therefore has std 1/sqrt(81), not
  1/sqrt(3584), and ``conv_w``'s scale 0.5 is not applied.  That is what
  the reference runs, so the port's activations have its scales.

The two packages' generators give different numbers from one seed; the
parity tests carry the reference's weights over with
``load_reference_params``, and its AdamW state with
``opt_state_from_reference``.  ``reference_paths`` and
``opt_state_to_reference`` go the other way (per-layer tensors stacked
into the reference's paths).
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch
from torch import nn


def _leaf_init(path: str) -> str:
    """The kind of a stacked leaf, from its name (the reference's rule)."""
    last = path.rsplit(".", 1)[-1]
    if last in ("bq", "bk", "bv", "conv_b", "dt_bias", "w_base", "A_log"):
        return "zeros"
    if last.startswith(("ln", "norm", "mu_")) or last == "D":
        return "ones"
    return "normal"


@dataclasses.dataclass
class InitCtx:
    """Device, dtype and (for a layer of a stack) the stack's depth."""
    dtype: Any
    device: torch.device
    stack: int = 0                   # > 0: a layer of a stack of this many

    def param(self, name: str, shape: tuple[int, ...], *,
              scale: float | None = None, init: str = "normal"
              ) -> nn.Parameter:
        full = tuple(shape)
        if self.stack:
            init, scale, full = _leaf_init(name), None, (self.stack,) + full
        if init == "normal" and scale is None:
            fan_in = full[0] if len(full) >= 2 else max(full[0], 1)
            scale = 1.0 / np.sqrt(fan_in)
        p = nn.Parameter(torch.empty(shape, dtype=self.dtype,
                                     device=self.device), requires_grad=False)
        p.init_rule = (init, scale)
        return p


@torch.no_grad()
def init_params(module: nn.Module, generator: torch.Generator) -> None:
    """Fill every parameter of ``module`` by its recorded rule, in
    registration order, from ``generator`` (on the parameters' device)."""
    for _, p in module.named_parameters():
        init, scale = p.init_rule
        if init == "zeros":
            p.zero_()
        elif init == "ones":
            p.fill_(1.0)
        elif p.dtype == torch.float32:   # drawn in place: no float32 copy
            torch.randn(p.shape, generator=generator, out=p)
            p.mul_(scale)
        else:
            z = torch.randn(p.shape, generator=generator, device=p.device,
                            dtype=torch.float32)
            p.copy_(z.mul_(scale))


def tree_from_paths(flat: dict[str, Any]) -> dict:
    """{'a.b.c': x} -> {'a': {'b': {'c': x}}}"""
    out: dict = {}
    for path, v in flat.items():
        node = out
        parts = path.split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return out


def paths_from_tree(tree: dict, prefix: str = "") -> dict[str, Any]:
    out = {}
    for k, v in tree.items():
        p = f"{prefix}.{k}" if prefix else k
        if isinstance(v, dict):
            out.update(paths_from_tree(v, p))
        else:
            out[p] = v
    return out


# the reference's trees whose leaves stack one entry per layer (DeepSeek's
# first_k_dense layers are a stack of their own)
STACKED = ("layers", "dense_layers")
# reference leaves the port names otherwise (``Model.embed`` is a method)
RENAMED = {"embed": "embedding"}


def split_reference_paths(flat: dict[str, Any]) -> dict[str, Any]:
    """The reference's flat paths -> the port's parameter names: a stacked
    leaf (``layers.mixer.w_in``, shape (n, ...)) becomes the n entries
    ``layers.<i>.mixer.w_in`` (likewise under ``dense_layers``), and the
    leaves of ``RENAMED`` take the port's names.  Values are indexed, not
    copied."""
    out = {}
    for path, arr in flat.items():
        top, _, rest = path.partition(".")
        if top in STACKED:
            for i in range(np.shape(arr)[0]):
                out[f"{top}.{i}.{rest}"] = arr[i]
        else:
            out[RENAMED.get(path, path)] = arr
    return out


def reference_paths(named: dict[str, Any]) -> dict[str, Any]:
    """The inverse of ``split_reference_paths``: the port's per-layer
    entries (parameters, gradients, optimizer moments or master copies,
    keyed by parameter name) stacked in layer order into the reference's
    flat paths (``torch.stack`` for tensors, ``np.stack`` for arrays), and
    ``RENAMED`` undone."""
    back = {v: k for k, v in RENAMED.items()}
    out: dict[str, Any] = {}
    stacks: dict[str, dict[int, Any]] = {}
    for name, val in named.items():
        top, _, rest = name.partition(".")
        if top in STACKED:
            i, _, leaf = rest.partition(".")
            stacks.setdefault(f"{top}.{leaf}", {})[int(i)] = val
        else:
            out[back.get(name, name)] = val
    for path, by_layer in stacks.items():
        if sorted(by_layer) != list(range(len(by_layer))):
            raise ValueError(f"{path}: layers {sorted(by_layer)} are not "
                             f"0..{len(by_layer) - 1}")
        seq = [by_layer[i] for i in range(len(by_layer))]
        out[path] = (torch.stack([t.detach() for t in seq])
                     if isinstance(seq[0], torch.Tensor) else np.stack(seq))
    return out


@torch.no_grad()
def load_reference_params(model: nn.Module, flat: dict[str, Any]) -> None:
    """Fill ``model`` from the JAX package's parameters.

    ``flat`` is ``paths_from_tree(params)`` of the reference's tree with
    numpy arrays as leaves, named as ``split_reference_paths`` maps them.
    Every parameter of the model must be filled exactly once, each with its
    own shape; values are cast to the parameter's dtype.
    """
    own = dict(model.named_parameters())
    filled = set()
    for name, arr in split_reference_paths(flat).items():
        if name not in own:
            raise KeyError(f"reference parameter {name!r} has no counterpart "
                           "in the port's model")
        p = own[name]
        t = torch.from_numpy(np.array(arr, dtype=np.float32))   # a copy
        if tuple(t.shape) != tuple(p.shape):
            raise ValueError(f"{name}: reference shape {tuple(t.shape)} != "
                             f"port shape {tuple(p.shape)}")
        p.copy_(t.to(device=p.device, dtype=p.dtype))
        filled.add(name)
    missing = sorted(set(own) - filled)
    if missing:
        raise KeyError(f"no reference value for {missing}")


def opt_state_from_reference(state: dict, cfg, device) -> dict:
    """The reference's AdamW state (``{"m", "v", "master"}`` trees, flat or
    nested, with numpy leaves, and ``step``) as the port's
    (``optim.adamw_init``'s layout): per-parameter tensors on ``device``,
    the moments in ``cfg.moment_dtype`` and the master in
    ``cfg.master_dtype`` (any object with those two attributes, such as an
    ``AdamWConfig``)."""
    def convert(tree, dtype):
        return {name: torch.from_numpy(np.array(a, dtype=np.float32)).to(
                    device=device, dtype=dtype)
                for name, a in split_reference_paths(
                    paths_from_tree(tree)).items()}
    return {"m": convert(state["m"], cfg.moment_dtype),
            "v": convert(state["v"], cfg.moment_dtype),
            "master": convert(state["master"], cfg.master_dtype),
            "step": torch.tensor(int(np.asarray(state["step"])),
                                 dtype=torch.int32, device=device)}


def opt_state_to_reference(state: dict) -> dict:
    """The port's AdamW state in the reference's layout: ``m``, ``v`` and
    ``master`` as flat reference paths of stacked tensors
    (``reference_paths``), ``step`` as an int."""
    out = {key: reference_paths(state[key]) for key in ("m", "v", "master")}
    out["step"] = int(state["step"])
    return out
