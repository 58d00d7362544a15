"""Dispatch over the hand-written kernels and their plain-torch versions.

The route follows the tensor's device and nothing else: a CUDA tensor goes
to the CUDA kernel (which raises on anything it does not take), a CPU tensor
to the plain version in ``ref.py``.  There is no fallback from one to the
other.  Whether a caller goes through these functions at all is its own
``use_kernel`` choice (see ``device.resolve_use_kernel``).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ref


def cluster_assign(X: torch.Tensor, C: torch.Tensor
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Nearest-centroid assignment: X (N, d) points vs C (M, d) centroids.

    Returns (labels (N,) int32, min squared distance (N,) f32) — the offline
    clustering path's million-row label pass and the additive refit's
    routing of large refresh batches (``core.clustering``).
    """
    if X.is_cuda:
        from repro_torch.kernels.cluster_assign import cluster_assign_cuda
        return cluster_assign_cuda(X, C)
    return ref.cluster_assign_ref(X, C)


def transfer_predict_argmax(values: torch.Tensor, idx: torch.Tensor
                            ) -> tuple[torch.Tensor, torch.Tensor]:
    """Best candidate per (request, surface) over stacked surface lattices.

    values: (S, G) flattened integer-lattice surface values; idx: (B, P)
    flat candidate indices.  Returns (best (B, S) f32, argk (B, S) int32) —
    fleet admission's batched predict/argmax (``core.batched``).
    """
    if values.is_cuda:
        from repro_torch.kernels.transfer_select import (
            batched_predict_argmax_cuda,
        )
        return batched_predict_argmax_cuda(values, idx)
    return ref.batched_predict_argmax_ref(values, idx)


def nat_spline_fit(x: torch.Tensor, Y: torch.Tensor) -> torch.Tensor:
    """Natural-cubic-spline coefficients for many rows over shared knots.

    x: (N,) strictly increasing knots; Y: (R, N) values.  Returns
    (R, N-1, 4) — the batched Thomas solve the additive refit uses to refit
    every touched (cluster, bin) spline row in one call
    (``core.surfaces.fit_surfaces_batched``).
    """
    if Y.is_cuda:
        from repro_torch.kernels.spline_fit import nat_spline_fit_cuda
        return nat_spline_fit_cuda(x, Y)
    return ref.nat_spline_fit_ref(x, Y)
