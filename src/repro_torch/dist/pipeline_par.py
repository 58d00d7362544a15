"""GPipe-style pipeline parallelism over a ``stage`` mesh axis
(``repro.dist.pipeline_par``), on ``torch.distributed``.

Layers are stacked (the reference's layout: each leaf (L, ...)), split into
per-stage sub-stacks, and scheduled round-robin over microbatches: at tick
``t`` stage ``s`` runs microbatch ``t - s`` and hands its activation to
stage ``s + 1`` by a point-to-point send on the ring.  ``M + S - 1`` ticks
drain ``M`` microbatches through ``S`` stages; the first/last ``S - 1``
ticks are the bubble.  Each stage is one rank of the mesh's ``stage``
dimension.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    n_stages: int
    n_microbatches: int

    @property
    def bubble_fraction(self) -> float:
        """Idle fraction of the GPipe schedule: (S-1) / (M+S-1)."""
        s, m = self.n_stages, self.n_microbatches
        return (s - 1) / (m + s - 1)


def split_stages(params: dict, n_stages: int) -> dict:
    """Reshape layer-stacked leaves (L, ...) -> (S, L/S, ...) (views)."""
    def split(a):
        n_layers = a.shape[0]
        if n_layers % n_stages:
            raise ValueError(f"{n_layers} layers not divisible into "
                             f"{n_stages} stages")
        return a.reshape((n_stages, n_layers // n_stages) + tuple(a.shape[1:]))
    return {k: (split_stages(v, n_stages) if isinstance(v, dict) else split(v))
            for k, v in params.items()}


def _take(params: dict, i: int) -> dict:
    return {k: (_take(v, i) if isinstance(v, dict) else v[i])
            for k, v in params.items()}


def make_pipeline_fn(layer_slice, mesh, pcfg: PipelineConfig):
    """Build fn(stage_params, xs) running ``layer_slice`` as a pipeline.

    ``layer_slice(params, x)`` applies one stage's layer sub-stack (leaves
    shaped (L/S, ...)) to a microbatch ``x``.  ``stage_params`` comes from
    :func:`split_stages` (leaves (S, L/S, ...)); each rank takes its own
    stage's entry.  ``xs`` is (n_microbatches, microbatch, ...), the same
    on every rank.  The output matches ``xs``'s shape, is the same on every
    rank, and equals sequential application of the full stack to every
    microbatch.

    ``mesh`` is a ``DeviceMesh`` with a ``stage`` dimension of
    ``n_stages`` ranks.  A stage hands its activation on with
    ``batch_isend_irecv`` (send to stage ``s + 1``, receive from
    ``s - 1``, around the ring, the reference's collective permute); at
    ``S = 1`` the ring is the identity and nothing is sent (torch refuses
    a send to one's own rank).  The last stage's outputs are replicated by
    a SUM all-reduce of every stage's buffer, zero but the last's.
    """
    n_stages, n_micro = pcfg.n_stages, pcfg.n_microbatches
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    if sizes.get("stage") != n_stages:
        raise ValueError(f"the mesh {sizes} has no 'stage' dimension of "
                         f"{n_stages}")
    group = mesh.get_group("stage")
    s = mesh.get_local_rank("stage")
    nxt = dist.get_global_rank(group, (s + 1) % n_stages)
    prv = dist.get_global_rank(group, (s - 1) % n_stages)

    def permute(state: torch.Tensor) -> torch.Tensor:
        if n_stages == 1:
            return state
        got = torch.empty_like(state)
        ops = [dist.P2POp(dist.isend, state.contiguous(), nxt, group),
               dist.P2POp(dist.irecv, got, prv, group)]
        for work in dist.batch_isend_irecv(ops):
            work.wait()
        return got

    def fn(stage_params: dict, xs: torch.Tensor) -> torch.Tensor:
        params = _take(stage_params, s)          # my slice
        state = torch.zeros(xs.shape[1:], dtype=xs.dtype, device=xs.device)
        outputs = torch.zeros_like(xs)
        for t in range(n_micro + n_stages - 1):
            # stage 0 ingests microbatch t (stale re-reads during the drain
            # ticks flow through but are never recorded as output)
            if s == 0:
                state = xs[min(t, n_micro - 1)]
            state = layer_slice(params, state)
            out_idx = t - (n_stages - 1)   # last stage just finished out_idx
            if out_idx >= 0:
                outputs[out_idx] = state
            state = permute(state)
        # every stage wrote its own (mostly garbage) buffer; keep the last
        # stage's and replicate it
        if s != n_stages - 1:
            outputs.zero_()
        dist.all_reduce(outputs, op=dist.ReduceOp.SUM, group=group)
        return outputs

    return fn
