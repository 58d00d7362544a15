"""Gradient collectives: flatten, bucket, quantize, all-reduce — plus the
paper bridge that tunes the bucketing with ``TransferTuner``
(``repro.dist.collectives``), on ``torch.distributed``.

The paper's tuner (arXiv:1707.09455) optimizes (cc, p, pp) for wide-area
transfers from offline knowledge plus a few adaptive probes.  A gradient
all-reduce over the accelerators' interconnect is the same shaped problem: a
fixed-capacity channel, a setup cost per reconfiguration, and an
interior-maximum response to concurrency (too few buckets underlaps
compute/comm, too many drowns in per-launch overhead).
:func:`ici_environment` models the fabric in the same ``Environment`` law the
tuner already understands (the name is the reference's; here its default
link is an H100 SXM's NVLink, :data:`H100_NVLINK`), and
:func:`plan_from_tuner_params` maps its converged (cc, p, pp) onto a
:class:`BucketPlan`:

  * ``cc``  -> concurrent buckets in flight        -> ``n_buckets``
  * ``p``   -> chunks streamed per bucket          -> ``chunks_per_bucket``
  * ``pp``  -> launch-pipelining depth             -> ``pipeline_depth``

Where the reference runs a collective inside ``shard_map`` over a named mesh
axis, these functions take a process group: ``None`` (the default group), a
``ProcessGroup``, a one-dimensional ``DeviceMesh``, or ``(mesh, dim name)``.
Every rank of the group calls them with a vector of the same size.
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.distributed as dist

from repro_torch.netsim.environment import Environment, LinkSpec, TransferParams
from repro_torch.optim.grad_utils import (dequantize_int8, int8_scale,
                                          quantize_int8)


def process_group(group):
    """The ``ProcessGroup`` named by ``group`` (see the module docstring)."""
    if isinstance(group, tuple):
        mesh, dim = group
        return mesh.get_group(dim)
    if hasattr(group, "get_group"):
        return group.get_group()
    return group


# ------------------------- flatten / unflatten ------------------------- #
def _leaves(tree, prefix: tuple = ()):
    """(key path, tensor) of every leaf of nested dicts, in insertion order."""
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def flatten_grads(tree):
    """Every leaf of ``tree`` (a dict of tensors, nested dicts allowed) in
    one float32 vector, leaves in the dict's order; returns (flat, spec).
    One copy a leaf into a vector allocated once."""
    leaves = list(_leaves(tree))
    spec = [(path, tuple(t.shape), t.dtype) for path, t in leaves]
    dev = leaves[0][1].device if leaves else None
    flat = torch.empty(sum(t.numel() for _, t in leaves),
                       dtype=torch.float32, device=dev)
    off = 0
    for _, t in leaves:
        n = t.numel()
        flat[off:off + n].copy_(t.detach().reshape(-1))
        off += n
    return flat, spec


def unflatten_grads(flat: torch.Tensor, spec) -> dict:
    """Inverse of :func:`flatten_grads`; restores shapes, dtypes and the
    nesting."""
    out: dict = {}
    off = 0
    for path, shape, dtype in spec:
        n = math.prod(shape)
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = flat[off:off + n].reshape(shape).to(dtype)
        off += n
    return out


# ------------------------------ bucketing ------------------------------ #
@dataclasses.dataclass(frozen=True)
class BucketPlan:
    """How a flat gradient is cut up for the all-reduce stream.

    ``n_buckets * chunks_per_bucket`` chunks are reduced in waves of
    ``pipeline_depth``: each wave is issued as ONE collective over the
    stacked chunks, amortizing per-launch overhead exactly like the paper's
    command pipelining ``pp`` amortizes per-file control RTTs.
    """
    n_buckets: int = 1
    chunks_per_bucket: int = 1
    pipeline_depth: int = 1

    @property
    def n_chunks(self) -> int:
        return self.n_buckets * self.chunks_per_bucket


def _chunked(v: torch.Tensor, plan: BucketPlan) -> torch.Tensor:
    """(n_chunks, chunk) copy of the raveled vector, zero-padded."""
    flat = v.reshape(-1)
    n = max(plan.n_chunks, 1)
    per = -(-flat.numel() // n)
    out = torch.zeros(n * per, dtype=v.dtype, device=v.device)
    out[:flat.numel()].copy_(flat)
    return out.reshape(n, per)


def bucketed_allreduce(v: torch.Tensor, plan: BucketPlan, group=None
                       ) -> torch.Tensor:
    """The SUM of ``v`` over the ranks of ``group``, chunk by chunk.

    Each wave of ``pipeline_depth`` chunks is one ``all_reduce`` of a
    contiguous slice of the chunked copy; the waves are issued
    asynchronously and waited for at the end.  Padding is stripped on
    reassembly; ``v`` is not written."""
    pg = process_group(group)
    chunks = _chunked(v, plan)
    depth = max(plan.pipeline_depth, 1)
    works = [dist.all_reduce(chunks[w:w + depth], op=dist.ReduceOp.SUM,
                             group=pg, async_op=True)
             for w in range(0, chunks.shape[0], depth)]
    for work in works:
        work.wait()
    return chunks.reshape(-1)[:v.numel()].reshape(v.shape)


def quantized_allreduce(v: torch.Tensor, plan: BucketPlan, group=None
                        ) -> torch.Tensor:
    """int8 bucketed all-reduce: ~4x less traffic than float32.

    Per chunk: agree on a global scale (one MAX all-reduce of every chunk's
    scale), quantize symmetrically to int8, reduce in int32 (no overflow up
    to 2^23 participants), dequantize.  Worst-case error is half an int8
    step on the chunk's max magnitude.
    """
    if v.numel() == 0:                  # empty param group: nothing to move
        return v
    pg = process_group(group)
    chunks = _chunked(v, plan)
    depth = max(plan.pipeline_depth, 1)
    # one scale-agreement collective for all chunks, not one per wave
    scales = int8_scale(chunks, axis=1)
    dist.all_reduce(scales, op=dist.ReduceOp.MAX, group=pg)
    out = torch.empty(chunks.shape, dtype=torch.float32, device=v.device)
    for w in range(0, chunks.shape[0], depth):
        scale = scales[w:w + depth, None]
        q, _ = quantize_int8(chunks[w:w + depth], scale)  # per-chunk scales
        s = q.to(torch.int32)
        del q
        dist.all_reduce(s, op=dist.ReduceOp.SUM, group=pg)
        out[w:w + depth] = dequantize_int8(s, scale)
        del s
    del chunks
    return out.reshape(-1)[:v.numel()].reshape(v.shape).to(v.dtype)


def allreduce_bytes(n_elems: int, elem_bytes: int,
                    n_devices: int | None = None) -> float:
    """Bytes moved per participant by a ring all-reduce.

    Reduce-scatter + all-gather each move ``(n-1)/n`` of the buffer; the
    asymptotic 2x is used when the ring size is unknown.
    """
    factor = 2.0 if n_devices is None else \
        2.0 * (n_devices - 1) / max(n_devices, 1)
    return float(n_elems) * float(elem_bytes) * factor


# --------------------------- the paper bridge --------------------------- #
# An H100 SXM's interconnect in the tuner's link law.  From NVIDIA's H100
# data sheet: NVLink 4 carries 900 GB/s per GPU, both directions together,
# so 450 GB/s (3.6e6 Mbps) each way; HBM3 reads and writes at 3.35 TB/s
# (2.68e7 Mbps), which bounds a bucket's staging copies as the disks bound
# a WAN transfer.  Every other field has no published source: it is a
# model parameter of the law, not a measurement.
H100_NVLINK = LinkSpec(
    name="nvlink4",
    bandwidth_mbps=3_600_000.0,     # 450 GB/s a direction (data sheet)
    rtt_s=1e-5,                     # model parameter
    tcp_buffer_mb=2.0,              # model parameter: per-channel window
    disk_read_mbps=26_800_000.0,    # HBM3, 3.35 TB/s (data sheet)
    disk_write_mbps=26_800_000.0,
    cores=8,                        # model parameter: concurrency cap
    congestion_knee=0.90,           # model parameter
    loss_sensitivity=1.0,           # model parameter: lossless fabric
    streams_to_saturate=4,          # model parameter
)


def ici_environment(seed: int = 0, *, constant_load: float | None = None,
                    link: LinkSpec = H100_NVLINK) -> Environment:
    """The accelerator fabric as a tunable transfer :class:`Environment`
    (the reference's name; ``link`` defaults to :data:`H100_NVLINK`).

    Background load models compute-phase contention on the links
    (collectives from other replicas / overlap with the producer matmuls)
    with the same diurnal-plus-jitter shape the WAN testbeds use, so the
    tuner's offline load-binning applies unchanged.
    """
    from repro_torch.netsim.traffic import DiurnalTraffic
    if constant_load is not None:
        traffic = DiurnalTraffic.constant(constant_load)
    else:
        traffic = DiurnalTraffic(base_load=0.15, peak_load=0.50,
                                 peak_hour=12.0, peak_width_h=8.0,
                                 jitter=0.05, seed=seed + 23)
    return Environment(link, traffic, noise_sigma=0.02, seed=seed)


def plan_from_tuner_params(params: TransferParams) -> BucketPlan:
    """Map the tuner's converged (cc, p, pp) onto a :class:`BucketPlan`."""
    return BucketPlan(n_buckets=max(int(params.cc), 1),
                      chunks_per_bucket=max(int(params.p), 1),
                      pipeline_depth=max(int(params.pp), 1))
