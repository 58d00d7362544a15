"""Multi-pod dry run: run every (architecture x input shape) cell as one
rank of the production meshes would, on fake tensors, and report its
memory, FLOPs and collective bytes (``repro.launch.dryrun``).

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3-405b \
        --shape train_4k [--multi-pod] [--all] [--out results.json]

Torch has no ahead-of-time lowering, so the dry run runs the cell's step
itself, as rank 0 of the mesh: ``torch.distributed`` starts on the
``"fake"`` backend (a process group that hallucinates every collective)
with 256 or 512 ranks, ``make_production_mesh`` builds the (16, 16) or
(2, 16, 16) mesh over it, and the model, its state, the inputs and the
step run under ``FakeTensorMode``.  Like the reference's placeholder
devices, none of this needs a card or allocates a tensor's memory.  The
mesh and the fake tensors take the card's device type where a card is
visible and the CPU's elsewhere: torch built without CUDA refuses even a
fake CUDA tensor's indexing and DTensor placement.

The step runs the plain routes (``cfg.use_kernel=False``): the hand-written
kernels launch by raw pointer, which a fake tensor does not have.

A row's numbers (the reference's keys):

- ``bytes_per_device["argument"]``: the step's inputs at rest, each leaf's
  local shard in the reference's shardings (``tree_shardings`` of the
  parameters on ``Model.param_axes``, the AdamW state on
  ``opt_state_axes`` for ``train``, the cache on ``Model.cache_axes`` for
  ``prefill`` and ``decode``, the batch on ``batch_sharding``), summed;
  ``degraded_shardings`` is the count of dims those shardings replicate.
- ``flops_total``: ``FlopCounterMode`` over the step the port runs on one
  rank.  That step is data parallel (``train.loop.make_train_step``'s
  sharded step for ``train``; ``prefill``/``decode`` on the rank's batch
  block): whole local tensors at the per-rank batch, with no tensor-
  parallel split.  The reference's number is XLA's SPMD partition of one
  program over the mesh; the two are not expected to agree.
  ``FlopCounterMode`` counts the products (matmuls, attention), not the
  elementwise work XLA also counts.
- ``bytes_accessed``: the bytes every op of the step reads and writes (its
  tensor arguments and outputs; views move none): an unfused count.
- ``collective_bytes``: the output bytes of every collective the step
  issues, by a dispatch mode over the ``c10d`` and ``_c10d_functional``
  ops (``CollectiveCounter``), under the reference's keys.
- ``temp``: the most bytes the step allocates and holds at once, from a
  dispatch mode that tracks every live fake tensor's storage
  (``LiveBytes``); ``output``: the bytes of the step's outputs it
  allocated; ``peak``: every live byte on the rank at the step's high-water
  mark (the port's whole compute copy of the parameters, the resting
  shards, the batch, the step's own tensors).
- ``lower_s`` / ``compile_s``: seconds to build the fake model, state and
  shardings / to run the fake step (no lowering or compiling exists here).
"""
import argparse
import contextlib
import dataclasses
import json
import math
import os
import time
import traceback
import warnings
import weakref

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.configs import all_archs, get_config
from repro_torch.dist.sharding import (ShardingReport, axis_sizes,
                                       batch_sharding, default_rules,
                                       place_tree, tree_shardings)
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.shapes import (LONG_CONTEXT_OK, SHAPES,
                                       TRAIN_MICROBATCHES, applicable_cells,
                                       input_specs)
from repro_torch.models import layers
from repro_torch.models.model import build_model
from repro_torch.models.params import paths_from_tree, reference_path
from repro_torch.optim import adamw_init
from repro_torch.train.loop import (TrainConfig, make_train_step,
                                    opt_state_axes)

# op name (without its overload) -> the reference's HLO collective key
COLLECTIVE_KEYS = {
    **dict.fromkeys(("allreduce_", "allreduce_coalesced_", "all_reduce",
                     "all_reduce_", "all_reduce_coalesced",
                     "all_reduce_coalesced_"), "all-reduce"),
    **dict.fromkeys(("allgather_", "_allgather_base_", "allgather_coalesced_",
                     "allgather_into_tensor_coalesced_",
                     "all_gather_into_tensor", "all_gather_into_tensor_out",
                     "all_gather_into_tensor_coalesced"), "all-gather"),
    **dict.fromkeys(("reduce_scatter_", "_reduce_scatter_base_",
                     "reduce_scatter_tensor_coalesced_",
                     "reduce_scatter_tensor", "reduce_scatter_tensor_out",
                     "reduce_scatter_tensor_coalesced"), "reduce-scatter"),
    **dict.fromkeys(("alltoall_", "alltoall_base_", "all_to_all_single"),
                    "all-to-all"),
    # a point-to-point receive is one rank's share of a permute
    **dict.fromkeys(("recv_", "recv_any_source_"), "collective-permute"),
}


def _tensors(tree) -> list[torch.Tensor]:
    """The tensors in a nest of tuples, lists and dicts (an op's arguments
    and outputs, a step's outputs)."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        tree = tree.values()
    elif not isinstance(tree, (list, tuple)):
        return []
    out = []
    for x in tree:
        out += [x] if isinstance(x, torch.Tensor) else _tensors(x)
    return out


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class CollectiveCounter(TorchDispatchMode):
    """Sums the output bytes of every collective dispatched under it by the
    reference's keys (``all-reduce``, ``all-gather``, ``reduce-scatter``,
    ``all-to-all``, ``collective-permute``): the buffers a ``c10d`` op
    writes (its first argument) or the tensors a ``_c10d_functional`` op
    returns."""

    def __init__(self):
        super().__init__()
        self.bytes: dict[str, float] = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        key = COLLECTIVE_KEYS.get(func.overloadpacket.__name__)
        if key is not None and func.namespace in ("c10d", "_c10d_functional"):
            written = args[0] if func.namespace == "c10d" else out
            self.bytes[key] = self.bytes.get(key, 0.0) + float(
                sum(_nbytes(t) for t in _tensors(written)))
        return out


class LiveBytes(TorchDispatchMode):
    """Tracks the storage of every tensor an op under it returns (but a
    ``meta`` stand-in) until the storage dies: ``live`` bytes now, ``high``
    the most since ``mark``, and which storages were made since.
    ``accessed`` sums the bytes every ``aten`` op but a view reads and
    writes.  DTensor ops pass through to their local ops."""

    def __init__(self):
        super().__init__()
        self.live = self.high = self.accessed = 0
        self._known: dict[int, int] = {}
        self._new: set[int] = set()

    def _free(self, key: int) -> None:
        self.live -= self._known.pop(key)
        self._new.discard(key)

    def _track(self, out) -> None:
        for t in _tensors(out):
            if t.device.type == "meta":     # a stand-in, not the rank's
                continue
            st = t.untyped_storage()
            key = id(st)
            if key not in self._known:
                self._known[key] = st.nbytes()
                self._new.add(key)
                self.live += self._known[key]
                weakref.finalize(st, self._free, key)
        self.high = max(self.high, self.live)

    def mark(self) -> None:
        self.high = self.live
        self._new.clear()

    def new_bytes(self, tree) -> int:
        """Bytes of the storages of ``tree``'s tensors made since ``mark``."""
        keys = {id(t.untyped_storage()) for t in _tensors(tree)}
        return sum(self._known[k] for k in keys & self._new)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **(kwargs or {}))
        outs = _tensors(out)
        if func.namespace == "aten" and not func.is_view:
            self.accessed += sum(_nbytes(t) for t in _tensors((args, kwargs))
                                 + outs)
        self._track(outs)
        return out


@contextlib.contextmanager
def fake_process_group(world_size: int):
    """A default process group on the ``"fake"`` backend, this process as
    rank 0 of ``world_size``, destroyed on exit."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("a default process group already exists; run the "
                           "dry run in a process of its own")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


@contextlib.contextmanager
def _fake_mode():
    """A ``FakeTensorMode`` whose tensors the per-device RoPE tables of
    ``models.layers`` cache only while it lasts: a fake table must meet no
    later mode, nor real tensors."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    tables = (layers._inv_freq, layers._section_ids)
    for t in tables:
        t.cache_clear()
    try:
        with FakeTensorMode(), warnings.catch_warnings():
            # ``place_tree`` compares data pointers, which fake tensors
            # lack; it then copies, which moves nothing here
            warnings.filterwarnings(
                "ignore", message="Accessing the data pointer of FakeTensor")
            yield
    finally:
        for t in tables:
            t.cache_clear()


def _stacked(named: dict) -> dict[str, torch.Tensor]:
    """{the reference's path: a ``meta`` stand-in of its stacked shape} of
    tensors keyed by the port's parameter names (per-layer leaves stacked
    along a leading layers axis, as the reference holds them)."""
    depth: dict[str, int] = {}
    leaf: dict[str, torch.Tensor] = {}
    for name, t in named.items():
        path, stacked = reference_path(name)
        leaf[path] = t
        depth[path] = depth.get(path, 0) + 1 if stacked else 0
    return {path: torch.empty(((depth[path],) if depth[path] else ())
                              + tuple(t.shape), dtype=t.dtype, device="meta")
            for path, t in leaf.items()}


def _span(sh) -> int:
    """The number of shards a ``NamedSharding`` cuts a tensor into."""
    sizes = axis_sizes(sh.mesh)
    return math.prod(sizes[axis] for entry in sh.spec
                     for axis in ((entry,) if isinstance(entry, str)
                                  else entry or ()))


def _shard_bytes(tree: dict, shardings: dict) -> int:
    """Bytes of one rank's shards of ``tree`` (flat: meta stand-ins or
    tensors keyed as ``shardings``) in their placements."""
    return sum(_nbytes(tree[path]) // _span(sh)
               for path, sh in shardings.items())


def _global_cache(cache: dict, batch: int) -> dict:
    """Flat ``meta`` stand-ins of the whole cache from a rank's block of
    it: each leaf at ``batch`` rows on axis 1, behind its stack's layers
    axis (``len``, (n, 1), as it is)."""
    out = {}
    for path, t in paths_from_tree(cache).items():
        shp = tuple(t.shape)
        if len(shp) > 2:
            shp = (shp[0], batch) + shp[2:]
        out[path] = torch.empty(shp, dtype=t.dtype, device="meta")
    return out


def _lower_and_analyze(cfg, arch: str, shape, *, multi_pod: bool,
                       micro_override: int | None = None,
                       verbose: bool = True) -> dict:
    """One cell as rank 0 of the production mesh (see the module's
    docstring), inside a fake process group of the mesh's size."""
    from torch.utils.flop_counter import FlopCounterMode
    cfg = dataclasses.replace(cfg, use_kernel=False)
    # the card's device type where there is one (see the module's docstring)
    dev = "cuda" if torch.cuda.is_available() else "cpu"
    mesh = make_production_mesh(multi_pod=multi_pod, device=dev)
    rules = default_rules(multi_pod)
    report = ShardingReport()
    t0 = time.perf_counter()
    with _fake_mode(), LiveBytes() as live:
        model = build_model(cfg, dev, seed=None)
        axes = model.param_axes()
        ref_params = _stacked(dict(model.named_parameters()))
        argument = _shard_bytes(ref_params, tree_shardings(
            ref_params, axes, mesh, rules, report))
        specs = input_specs(cfg, shape, dev)
        b_shard = {k: batch_sharding(mesh, ndim=v.dim(),
                                     batch_size=v.shape[0])
                   for k, v in specs.items()}
        argument += _shard_bytes(specs, b_shard)
        if shape.kind == "train":
            micro = micro_override or TRAIN_MICROBATCHES.get(
                arch, TRAIN_MICROBATCHES["default"])
            tcfg = TrainConfig(microbatches=micro)
            model.requires_grad_(True)
            opt = adamw_init(model, tcfg.opt)
            ref_opt = {k: (_stacked(v) if isinstance(v, dict) else v)
                       for k, v in opt.items()}
            argument += _shard_bytes(paths_from_tree(ref_opt),
                                     tree_shardings(ref_opt,
                                                    opt_state_axes(axes),
                                                    mesh, rules, report))
            step_fn = make_train_step(model, tcfg, mesh=mesh)
            opt = place_tree(opt, step_fn.shardings["opt_state"])

            def step():
                return step_fn(opt, specs)
        else:
            # the rank's block of the batch, and its cache, whole in heads
            rows = shape.global_batch // _span(b_shard["tokens"])
            cache = model.init_cache(rows, shape.seq_len)
            whole = _global_cache(cache, shape.global_batch)
            argument += _shard_bytes(whole, tree_shardings(
                whole, model.cache_axes(), mesh, rules, report))
            block = {k: v[:rows] for k, v in specs.items()}

            @torch.no_grad()
            def step():
                if shape.kind == "prefill":
                    return model.prefill(block["tokens"], cache,
                                         block.get("patch_embeds"))
                return model.decode(block["tokens"], cache)
        t_build = time.perf_counter() - t0
        live.mark()
        base, accessed0 = live.live, live.accessed
        coll = CollectiveCounter()
        flops = FlopCounterMode(display=False)
        with flops, coll:
            out = step()
        output = live.new_bytes(out)
        high, accessed = live.high, live.accessed - accessed0
    t_step = time.perf_counter() - t0 - t_build
    result = {
        "arch": arch, "shape": shape.name,
        "mesh": "2x16x16" if multi_pod else "16x16",
        "n_devices": int(math.prod(mesh.shape)),
        "flops_total": float(flops.get_total_flops()),
        "bytes_accessed": float(accessed),
        "collective_bytes": coll.bytes,
        "collective_bytes_total": float(sum(coll.bytes.values())),
        "bytes_per_device": {
            "argument": float(argument),
            "output": float(output),
            "temp": float(high - base),
            "peak": float(high),
        },
        "degraded_shardings": len(report.degraded),
        "lower_s": round(t_build, 1),
        "compile_s": round(t_step, 1),
    }
    if verbose:
        _print_row(result, report)
    return result


def _print_row(result: dict, report: ShardingReport) -> None:
    print(f"[{result['arch']} x {result['shape']} @ {result['mesh']}] "
          f"build {result['lower_s']:.0f}s step {result['compile_s']:.0f}s")
    mem = result["bytes_per_device"]
    print(f"  memory/device: arg={mem['argument'] / 2**30:.2f}GiB "
          f"temp={mem['temp'] / 2**30:.2f}GiB "
          f"peak={mem['peak'] / 2**30:.2f}GiB")
    print(f"  flops={result['flops_total']:.3e} "
          f"bytes={result['bytes_accessed']:.3e} "
          f"coll={result['collective_bytes_total']:.3e}")
    if report.degraded:
        kinds: dict[str, int] = {}
        for _, _, why in report.degraded:
            kinds[why.split(" ")[0]] = kinds.get(why.split(" ")[0], 0) + 1
        print(f"  degraded shardings: {kinds}")


def run_cost_cell(arch: str, shape_name: str, *, cfg=None,
                  verbose: bool = True) -> dict:
    """FLOPs, bytes and collective bytes for the roofline, by the
    reference's method: the model at full width and two depths on the
    16x16 mesh, attention materialized, one microbatch, and the per-layer
    slope extrapolated to the real depth.  The reference needs this because
    XLA counts a ``lax.scan`` body once; the port's Python loop counts
    every layer, so the extrapolation can be held to a full-depth count.
    ``cfg``: the config to measure (default: ``arch``'s full one)."""
    from repro_torch.kernels import ops as kops
    cfg0 = cfg if cfg is not None else get_config(arch, "full")
    shape = SHAPES[shape_name]

    old_thresh = kops.BLOCKED_ATTENTION_THRESHOLD
    kops.BLOCKED_ATTENTION_THRESHOLD = 1 << 62     # force materialized
    try:
        if cfg0.hybrid_attn_every:
            k = cfg0.hybrid_attn_every
            depths = [k, 2 * k]
            n_units = cfg0.n_layers / k            # fractional final group
            extra = n_units - 1.0
        elif cfg0.first_k_dense:
            depths = [cfg0.first_k_dense + 1, cfg0.first_k_dense + 2]
            n_units = cfg0.n_layers - cfg0.first_k_dense
            extra = n_units - 1
        else:
            depths = [1, 2]
            n_units = cfg0.n_layers
            extra = n_units - depths[0]
        meas = []
        with fake_process_group(256):
            for d in depths:
                meas.append(_lower_and_analyze(
                    dataclasses.replace(cfg0, n_layers=d), arch, shape,
                    multi_pod=False, micro_override=1, verbose=False))
        keys = ("flops_total", "bytes_accessed", "collective_bytes_total")
        (f0, b0, c0), (f1, b1, c1) = ([m[k] for k in keys] for m in meas)
        result = {
            "arch": arch, "shape": shape_name, "mesh": "16x16",
            "mode": "cost",
            "flops_total": f0 + (f1 - f0) * extra,
            "bytes_accessed": b0 + (b1 - b0) * extra,
            "collective_bytes_total": c0 + (c1 - c0) * extra,
            "per_layer_flops": f1 - f0,
            "depths_measured": depths,
        }
        if verbose:
            print(f"[cost {arch} x {shape_name}] "
                  f"flops={result['flops_total']:.3e} "
                  f"bytes={result['bytes_accessed']:.3e} "
                  f"coll={result['collective_bytes_total']:.3e}")
        return result
    finally:
        kops.BLOCKED_ATTENTION_THRESHOLD = old_thresh


def run_cell(arch: str, shape_name: str, *, multi_pod: bool,
             verbose: bool = True) -> dict:
    cfg = get_config(arch, "full")
    with fake_process_group(512 if multi_pod else 256):
        return _lower_and_analyze(cfg, arch, SHAPES[shape_name],
                                  multi_pod=multi_pod, verbose=verbose)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--cost", action="store_true",
                    help="accurate-cost mode (2-depth extrapolation, "
                         "single-pod) for the roofline")
    ap.add_argument("--out", default="dryrun_results.json")
    args = ap.parse_args()

    results = []
    if os.path.exists(args.out):
        with open(args.out) as f:
            results = json.load(f)
    done = {(r["arch"], r["shape"], r["mesh"]) for r in results}

    if args.all:
        cells = applicable_cells()
    else:
        shapes = [args.shape] if args.shape else list(SHAPES)
        archs = [args.arch] if args.arch else all_archs()
        cells = [(a, s) for a in archs for s in shapes
                 if not (s == "long_500k" and a not in LONG_CONTEXT_OK)]

    def save():
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)

    if args.cost:
        runs = [(a, s, False) for a, s in cells]
    else:
        meshes = [False, True] if (args.both_meshes or args.all) \
            else [args.multi_pod]
        runs = [(a, s, mp) for a, s in cells for mp in meshes]
    ok = fail = 0
    for arch, shape, mp in runs:
        mesh_name = "2x16x16" if mp else "16x16"
        if (arch, shape, mesh_name) in done:
            continue
        tag = f"cost {arch} x {shape}" if args.cost \
            else f"{arch} x {shape} @ {mesh_name}"
        try:
            results.append(run_cost_cell(arch, shape) if args.cost
                           else run_cell(arch, shape, multi_pod=mp))
            ok += 1
        except Exception as e:
            print(f"[{tag}] FAILED: {e}")
            traceback.print_exc()
            results.append({"arch": arch, "shape": shape, "mesh": mesh_name,
                            "error": str(e)[:500]})
            fail += 1
        save()
    print(f"{'cost ' if args.cost else ''}dry-run complete: {ok} ok, "
          f"{fail} failed -> {args.out}")


if __name__ == "__main__":
    main()
