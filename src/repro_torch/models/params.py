"""Parameter construction, the reference's init rule, and the weight carrier
from the JAX package's parameter trees.

Every parameter is made through ``InitCtx.param``, which allocates it on the
model's device and records how the JAX package initialises it and the
*logical* names of its axes (``p.logical_axes``, which ``dist/sharding.py``
maps onto a device mesh); ``init_params`` then fills every parameter from
one ``torch.Generator``, and ``param_axes`` collects the axes under the
reference's paths.
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

    def param(self, name: str, shape: tuple[int, ...], logical_axes: tuple,
              *, scale: float | None = None, init: str = "normal",
              segments: tuple[int, ...] | None = None) -> nn.Parameter:
        """``segments``: the widths of the parts that its ``"inner"`` dim
        concatenates (Mamba2's fused [z | x | B | C | dt]); a cut over
        ranks keeps its block of each part (``cut_ranges``)."""
        if len(shape) != len(logical_axes):
            raise ValueError(f"{name}: shape {tuple(shape)} has "
                             f"{len(shape)} axes, logical axes "
                             f"{tuple(logical_axes)} {len(logical_axes)}")
        full = tuple(shape)
        if self.stack:
            init, scale, full = _leaf_init(name), None, (self.stack,) + full
        if init == "normal" and scale is None:
            fan_in = full[0] if len(full) >= 2 else max(full[0], 1)
            scale = 1.0 / np.sqrt(fan_in)
        p = nn.Parameter(torch.empty(shape, dtype=self.dtype,
                                     device=self.device), requires_grad=False)
        p.init_rule = (init, scale)
        p.logical_axes = tuple(logical_axes)
        if segments is not None:
            p.segments = tuple(segments)
        return p


def whole_shape(p) -> tuple[int, ...]:
    """The shape of the whole parameter of which ``p`` is this rank's
    block (``cut_params``, over ``model``, ``data`` or both), or ``p``'s
    own shape."""
    return getattr(p, "whole_shape", tuple(p.shape))


# the records of the two cuts a parameter may take: its block over the
# mesh's ``model`` axis (tensor parallelism, ``dist.tensor_parallel``) and
# over ``data`` (FSDP, ``dist.fsdp``), on different dims; a block is cut
# by ``model`` first, then by ``data``
CUTS = ("cut", "data_cut")


def _cuts(p) -> list[tuple]:
    return [c for c in (getattr(p, key, None) for key in CUTS)
            if c is not None]


def cut_ranges(cut, size: int) -> list[tuple[int, int]]:
    """The [start, stop) ranges, in order, that a cut keeps of a dim of
    ``size``: ``cut`` is (dim, index, n) or (dim, index, n, segments).
    Block ``index`` of ``n`` equal blocks; with ``segments`` (widths that
    sum to ``size``) block ``index`` of each segment, concatenated."""
    _, index, n = cut[:3]
    segments = cut[3] if len(cut) > 3 and cut[3] else (size,)
    if sum(segments) != size or any(s % n for s in segments):
        raise ValueError(f"segments {segments} of a dim of {size} do not "
                         f"each split into {n} blocks")
    out, lo = [], 0
    for s in segments:
        out.append((lo + index * (s // n), lo + (index + 1) * (s // n)))
        lo += s
    return out


def _take(whole, dim: int, ranges: list[tuple[int, int]]):
    """The ``ranges`` of ``whole`` (a tensor or array) along ``dim``,
    concatenated: a view where there is one range."""
    def one(lo, hi):
        sl = [slice(None)] * len(whole.shape)
        sl[dim] = slice(lo, hi)
        return whole[tuple(sl)]
    parts = [one(lo, hi) for lo, hi in ranges]
    if len(parts) == 1:
        return parts[0]
    if isinstance(whole, torch.Tensor):
        return torch.cat(parts, dim=dim)
    return np.concatenate(parts, axis=dim)


def local_part(p, whole):
    """This rank's block of ``whole`` (a tensor or array of
    ``whole_shape(p)``) as ``p`` was cut from it, over ``model`` and then
    over ``data`` (``cut_ranges``): ``whole`` itself where ``p`` is not
    cut."""
    for cut in _cuts(p):
        whole = _take(whole, cut[0], cut_ranges(cut, whole.shape[cut[0]]))
    return whole


def assemble(parts: list, cut) -> torch.Tensor:
    """The whole tensor from every rank's block of it (``parts``, in rank
    order), each cut as ``cut`` says but for its index: the inverse of
    ``local_part`` over the ranks."""
    dim, _, n = cut[:3]
    size = sum(t.shape[dim] for t in parts)
    widths = [hi - lo for lo, hi in cut_ranges(cut, size)]
    pieces = [t.split(widths, dim=dim) for t in parts]
    return torch.cat([pieces[r][k] for k in range(len(widths))
                      for r in range(n)], dim=dim)


@torch.no_grad()
def cut_params(module: nn.Module, cuts: dict[str, tuple],
               record: str = "cut") -> None:
    """Replace each parameter named in ``cuts`` by its block: ``{name:
    (dim, index, n)}`` keeps block ``index`` of ``n`` equal blocks along
    ``dim``, and ``(dim, index, n, segments)`` that block of each segment
    (``cut_ranges``), a copy, so that the whole tensor can be freed.  The
    new parameter keeps the init rule, the logical axes, the segments,
    ``requires_grad`` and an earlier cut, and records ``whole_shape`` and
    the cut under ``record`` (one of ``CUTS``: ``"cut"`` over ``model``,
    ``"data_cut"`` over ``data``; ``local_part``)."""
    if record not in CUTS:
        raise ValueError(f"a cut is recorded as one of {CUTS}, not {record!r}")
    for name, cut in cuts.items():
        owner_name, _, leaf = name.rpartition(".")
        owner = module.get_submodule(owner_name) if owner_name else module
        old = getattr(owner, leaf)
        dim = cut[0]
        if old.shape[dim] % cut[2]:
            raise ValueError(f"{name}: dim {dim} of {tuple(old.shape)} does "
                             f"not split into {cut[2]} blocks")
        new = nn.Parameter(
            _take(old, dim, cut_ranges(cut, old.shape[dim])).clone(),
            requires_grad=old.requires_grad)
        _keep_records(old, new)
        new.whole_shape = whole_shape(old)
        setattr(new, record, tuple(cut))
        setattr(owner, leaf, new)


# what ``InitCtx.param`` and ``cut_params`` record on a parameter
_RECORDS = ("init_rule", "logical_axes", "segments", "whole_shape") + CUTS


def _keep_records(old, new) -> None:
    for key in _RECORDS:
        if hasattr(old, key):
            setattr(new, key, getattr(old, key))


@torch.no_grad()
def materialize(module: nn.Module, device) -> None:
    """Replace each parameter of ``module`` on the meta device by an
    uninitialised one of its shape and dtype on ``device``, keeping what
    ``InitCtx.param`` and ``cut_params`` recorded on it and its
    ``requires_grad``."""
    for name, old in list(module.named_parameters()):
        if old.device.type != "meta":
            continue
        owner_name, _, leaf = name.rpartition(".")
        owner = module.get_submodule(owner_name) if owner_name else module
        new = nn.Parameter(torch.empty(old.shape, dtype=old.dtype,
                                       device=device),
                           requires_grad=old.requires_grad)
        _keep_records(old, new)
        setattr(owner, leaf, new)


@torch.no_grad()
def init_params(module: nn.Module, generator: torch.Generator) -> None:
    """Fill every parameter of ``module`` by its recorded rule, in
    registration order, from ``generator`` (on the parameters' device).  A
    parameter cut by ``cut_params`` (over ``model``, ``data`` or both) is
    drawn whole, as the unsplit model draws it, and keeps its block: the
    generator's stream, and so every value, is the unsplit model's."""
    for _, p in module.named_parameters():
        init, scale = p.init_rule
        if init == "zeros":
            p.zero_()
        elif init == "ones":
            p.fill_(1.0)
        elif p.dtype == torch.float32 and not _cuts(p):
            # drawn in place: no float32 copy
            torch.randn(p.shape, generator=generator, out=p)
            p.mul_(scale)
        else:
            z = torch.randn(whole_shape(p), generator=generator,
                            device=p.device, dtype=torch.float32)
            p.copy_(local_part(p, z.mul_(scale)))
            # freed before the next draw: a leaf's float32 copy (14 GiB
            # for a deepseek-v3-671b expert stack) never meets the next's
            del z


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


def reference_path(name: str) -> tuple[str, bool]:
    """A port name (of a parameter, or of an entry of a tree keyed by
    parameter names, such as ``m.layers.3.attn.wq`` of the AdamW state) ->
    (the reference's path, whether the reference stacks it): the layer
    index after a ``STACKED`` name is dropped and ``RENAMED`` undone, so
    ``layers.3.attn.wq`` -> (``layers.attn.wq``, True) and ``embedding`` ->
    (``embed``, False)."""
    back = {v: k for k, v in RENAMED.items()}
    parts, out, stacked = name.split("."), [], False
    i = 0
    while i < len(parts):
        part = parts[i]
        if part in STACKED and i + 1 < len(parts) and parts[i + 1].isdigit():
            out.append(part)
            stacked, i = True, i + 2
            continue
        out.append(back.get(part, part) if i == len(parts) - 1 else part)
        i += 1
    return ".".join(out), stacked


def param_axes(module: nn.Module) -> dict[str, tuple]:
    """{the reference's path: logical axes} of every parameter of
    ``module``, as the reference's ``Model.init`` returns them: a stacked
    leaf (the port's ``layers.<i>.<leaf>``) once, with the leading
    ``"layers"`` axis its stacking adds."""
    out = {}
    for name, p in module.named_parameters():
        path, stacked = reference_path(name)
        out[path] = (("layers",) if stacked else ()) + p.logical_axes
    return out


@torch.no_grad()
def load_reference_params(model: nn.Module, flat: dict[str, Any]) -> None:
    """Fill ``model`` from the JAX package's parameters.

    ``flat`` is ``paths_from_tree(params)`` of the reference's tree with
    numpy arrays as leaves, named as ``split_reference_paths`` maps them.
    Every parameter of the model must be filled exactly once, each with its
    own shape (the whole one, for a parameter ``cut_params`` cut over
    ``model``, ``data`` or both: it takes its block of the reference's
    array); values are cast to the
    parameter's dtype.
    """
    own = dict(model.named_parameters())
    filled = set()
    for name, arr in split_reference_paths(flat).items():
        if name not in own:
            raise KeyError(f"reference parameter {name!r} has no counterpart "
                           "in the port's model")
        p = own[name]
        if tuple(np.shape(arr)) != whole_shape(p):
            raise ValueError(f"{name}: reference shape {tuple(np.shape(arr))}"
                             f" != port shape {whole_shape(p)}")
        # a copy of this rank's block
        t = torch.from_numpy(np.array(local_part(p, arr), dtype=np.float32))
        p.copy_(t.to(device=p.device, dtype=p.dtype))
        filled.add(name)
    missing = sorted(set(own) - filled)
    if missing:
        raise KeyError(f"no reference value for {missing}")


def opt_state_from_reference(state: dict, cfg, device,
                             model: nn.Module | None = None) -> dict:
    """The reference's AdamW state (``{"m", "v", "master"}`` trees, flat or
    nested, with numpy leaves, and ``step``) as the port's
    (``optim.adamw_init``'s layout): per-parameter tensors on ``device``,
    the moments in ``cfg.moment_dtype`` and the master in
    ``cfg.master_dtype`` (any object with those two attributes, such as an
    ``AdamWConfig``).  With ``model``, each leaf is the block of its
    parameter's cuts (``local_part``), as a split model's state holds it."""
    own = dict(model.named_parameters()) if model is not None else {}

    def part(name, a):
        return local_part(own[name], a) if name in own else a

    def convert(tree, dtype):
        return {name: torch.from_numpy(np.array(part(name, a),
                                                dtype=np.float32)).to(
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
