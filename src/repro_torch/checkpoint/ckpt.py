"""Sharded, fault-tolerant checkpointing with tuner-driven transfer
parameters.

The writer exposes exactly the paper's three knobs:
  * ``cc`` — concurrent array writers (thread pool width),
  * ``p``  — chunks per array (a large array is split into p files so
             restore can stripe reads),
  * ``pp`` — write-queue depth (arrays enqueued ahead of the pool: pipelines
             serialization against I/O).

Every save/restore appends a LogEntry-shaped record to ``transfers.jsonl``
next to the checkpoints — the historical log that
``repro_torch.checkpoint.tuning.CheckpointTuner`` mines offline, exactly as
the paper mines Globus logs.  Atomicity: writes go to a temp dir that is
renamed into place; restore picks the newest complete step (crash-safe
restart).

Leaves are torch tensors, on the card or on the CPU.  The on-disk format is
the JAX package's, so either package restores the other's checkpoints: one
``.npy`` file per chunk, and a dtype numpy has no name for (bfloat16, the
float8 types) written as its unsigned-integer bits and named in the
manifest by its ``ml_dtypes`` name, which the port maps to torch's dtypes
by its own table.
"""
from __future__ import annotations

import concurrent.futures as cf
import dataclasses
import json
import os
import shutil
import time

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models.params import paths_from_tree, tree_from_paths


@dataclasses.dataclass(frozen=True)
class CkptParams:
    cc: int = 4     # concurrent writers
    p: int = 2      # chunks per array
    pp: int = 4     # queue depth


# torch dtypes without a numpy counterpart: their ml_dtypes names, and the
# integer dtypes of their width that carry their bits through numpy
_BITS_DTYPES = {
    torch.bfloat16: ("bfloat16", torch.int16, np.int16),
    torch.float8_e4m3fn: ("float8_e4m3fn", torch.uint8, np.uint8),
    torch.float8_e5m2: ("float8_e5m2", torch.uint8, np.uint8),
}
_BY_NAME = {name: (dt, np_bits)
            for dt, (name, _, np_bits) in _BITS_DTYPES.items()}


def _host_array(leaf: torch.Tensor) -> tuple[np.ndarray, str]:
    """A host copy of ``leaf`` as numpy, and its dtype's name for the
    manifest; a dtype numpy lacks travels as its bits, viewed unsigned as
    the reference writes them."""
    t = leaf.detach().cpu()
    if t.dtype in _BITS_DTYPES:
        name, bits, _ = _BITS_DTYPES[t.dtype]
        return t.view(bits).numpy().view(f"u{t.element_size()}"), name
    arr = t.numpy()
    return arr, str(arr.dtype)


def _from_host(arr: np.ndarray, name: str) -> torch.Tensor:
    """Inverse of ``_host_array``: bit-exact for the dtypes numpy lacks."""
    if name in _BY_NAME:
        dt, np_bits = _BY_NAME[name]
        return torch.from_numpy(arr.view(np_bits)).view(dt)
    return torch.from_numpy(arr.astype(np.dtype(name)))


def _chunk_bounds(n: int, p: int) -> list[tuple[int, int]]:
    step = -(-n // p)
    return [(i, min(i + step, n)) for i in range(0, n, step)]


def save_checkpoint(directory: str, step: int, tree, *,
                    params: CkptParams = CkptParams(),
                    log_path: str | None = None) -> dict:
    """Write a sharded checkpoint; returns throughput stats."""
    os.makedirs(directory, exist_ok=True)
    tmp = os.path.join(directory, f".tmp_step_{step:08d}")
    final = os.path.join(directory, f"step_{step:08d}")
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)

    flat = paths_from_tree(tree)
    manifest = {}
    t0 = time.perf_counter()
    total_bytes = 0

    def write_chunk(path, arr, ci, lo, hi):
        fn = os.path.join(tmp, f"{path.replace('.', '__')}.{ci}.npy")
        flat_piece = arr.reshape(-1)[lo:hi]
        np.save(fn, np.asarray(flat_piece))
        return arr.nbytes * (hi - lo) // max(arr.size, 1)

    with cf.ThreadPoolExecutor(max_workers=params.cc) as pool:
        pending = []
        for path, leaf in flat.items():
            arr, dtype_name = _host_array(leaf)
            total_bytes += arr.nbytes
            n = arr.size
            bounds = _chunk_bounds(n, params.p) if n >= params.p else [(0, n)]
            manifest[path] = {"shape": list(arr.shape),
                              "dtype": dtype_name,
                              "chunks": len(bounds)}
            for ci, (lo, hi) in enumerate(bounds):
                pending.append(pool.submit(write_chunk, path, arr, ci, lo, hi))
                # pp bounds how far serialization runs ahead of I/O
                while len(pending) > params.cc * params.pp:
                    pending.pop(0).result()
        for f in pending:
            f.result()

    with open(os.path.join(tmp, "manifest.json"), "w") as fh:
        json.dump(manifest, fh)
    os.replace(tmp, final) if not os.path.exists(final) else shutil.rmtree(tmp)
    elapsed = time.perf_counter() - t0
    stats = {
        "step": step, "bytes": total_bytes, "elapsed_s": elapsed,
        "throughput_mbps": total_bytes * 8e-6 / max(elapsed, 1e-9),
        "cc": params.cc, "p": params.p, "pp": params.pp,
        "n_arrays": len(flat),
    }
    if log_path:
        with open(log_path, "a") as fh:
            fh.write(json.dumps(stats) + "\n")
    return stats


def latest_step(directory: str) -> int | None:
    if not os.path.isdir(directory):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(directory)
             if d.startswith("step_")
             and os.path.exists(os.path.join(directory, d, "manifest.json"))]
    return max(steps) if steps else None


def restore_checkpoint(directory: str, step: int | None = None, *,
                       params: CkptParams = CkptParams(),
                       device=None) -> dict:
    """Restore the (newest complete) checkpoint as a tree of torch tensors
    on ``device`` (None: the CUDA card, see ``device.resolve_device``)."""
    device = resolve_device(device)
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no complete checkpoint in {directory}")
    d = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.json")) as fh:
        manifest = json.load(fh)

    def read_array(path, info):
        parts = [np.load(os.path.join(
            d, f"{path.replace('.', '__')}.{ci}.npy"))
            for ci in range(info["chunks"])]
        arr = np.concatenate(parts) if len(parts) > 1 else parts[0]
        t = _from_host(arr, info["dtype"]).reshape(info["shape"])
        return path, t.to(device)

    out = {}
    with cf.ThreadPoolExecutor(max_workers=params.cc) as pool:
        for path, arr in pool.map(lambda kv: read_array(*kv),
                                  manifest.items()):
            out[path] = arr
    return tree_from_paths(out)


def prune_checkpoints(directory: str, keep: int = 3) -> None:
    steps = sorted([int(d.split("_")[1]) for d in os.listdir(directory)
                    if d.startswith("step_")])
    for s in steps[:-keep]:
        shutil.rmtree(os.path.join(directory, f"step_{s:08d}"),
                      ignore_errors=True)
