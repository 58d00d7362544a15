"""Batched surface evaluation for fleet-scale online tuning.

The online phase only ever queries surfaces on the integer protocol lattice
Psi = {1..beta}^3 (Sec. 3.1.2): discriminative probes, surface argmaxima, and
candidate jump targets are all integer ``TransferParams``.  Each fitted spline
surface is therefore losslessly represented by its dense integer-lattice
tensor, and a cluster's surfaces stack into one ``(S, P, C, Q)`` tensor on the
device the knowledge lives on.  Every scalar operation of ``core.online``
(predict, confidence test, closest-surface search, argmax over candidate
points) then becomes a gather or an elementwise op over the stack, batched
over concurrent requests — one call scores B requests x S surfaces x P
candidate points at once.

The argmax-over-candidates hot path dispatches through
``repro_torch.kernels.ops.transfer_predict_argmax`` (the hand-written CUDA
kernel in ``kernels/csrc/transfer_select.cu`` on the card, its plain-torch
version on the CPU).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.surfaces import ThroughputSurface
from repro_torch.device import resolve_device, resolve_use_kernel
from repro_torch.kernels import ops, ref
from repro_torch.netsim.environment import ParamBounds


def closest_surface_index(
    preds: torch.Tensor, achieved: torch.Tensor, direction: torch.Tensor
) -> torch.Tensor:
    """Vectorized FindClosestSurface over a batch of probes.

    ``preds`` (B, S) are the surface predictions at each request's probe
    point, surfaces sorted ascending by load intensity; ``achieved`` (B,) the
    observed rates; ``direction`` (B,) int with -1 = lighter-load candidates
    only (predict <= achieved), +1 = heavier (predict >= achieved), 0 =
    unrestricted.  Mirrors ``core.online._closest_surface`` exactly, including
    the fall-back-to-all-surfaces branch when the direction filter empties the
    candidate set and the lowest-load tie-break of ``min``.
    """
    d = direction[:, None]
    a = achieved[:, None]
    mask = torch.where(d < 0, preds <= a,
                       torch.where(d > 0, preds >= a,
                                   torch.ones_like(preds, dtype=torch.bool)))
    mask = mask | ~mask.any(dim=1, keepdim=True)
    dist = torch.where(mask, (preds - a).abs(),
                       torch.full_like(preds, float("inf")))
    # first index of the minimum, as jnp.argmin: the lowest-load surface
    # wins a tie, and a NaN distance wins outright
    nan = torch.isnan(dist)
    low = torch.where(nan, torch.full_like(dist, float("inf")),
                      dist).amin(dim=1, keepdim=True)
    hit = torch.where(nan.any(dim=1, keepdim=True), nan, dist == low)
    pos = torch.arange(dist.shape[1], device=dist.device).expand_as(dist)
    return torch.where(hit, pos,
                       torch.full_like(pos, dist.shape[1])).amin(dim=1)


def within_band(
    preds: torch.Tensor, sigma: torch.Tensor, achieved: torch.Tensor, z: float
) -> torch.Tensor:
    """Gaussian confidence-band test for B probes x S surfaces -> (B, S)."""
    return (achieved[:, None] - preds).abs() <= z * sigma[None, :]


@dataclasses.dataclass(frozen=True)
class SurfaceStack:
    """A cluster's surfaces stacked for batched evaluation.

    ``values[s, p - 1, cc - 1, pp - 1]`` is surface s evaluated at the integer
    point (p, cc, pp); surfaces are sorted ascending by load intensity so
    vectorized argmins tie-break exactly like the scalar path.  The tensors
    live on the device the stack was built for.
    """

    values: torch.Tensor  # (S, P, C, Q) float32 integer-lattice spline values
    sigma: torch.Tensor  # (S,) float32 confidence-band sigmas
    load: torch.Tensor  # (S,) float32 load-intensity tags, ascending
    argmax_pts: np.ndarray  # (S, 3) int32 (cc, p, pp) precomputed argmaxima
    max_throughput: np.ndarray  # (S,) precomputed maxima

    @classmethod
    def from_surfaces(
        cls, surfaces: list[ThroughputSurface], bounds: ParamBounds,
        device=None,
    ) -> "SurfaceStack":
        """Stack ``surfaces`` on ``device`` (None: the CUDA card)."""
        device = resolve_device(device)
        surfaces = sorted(surfaces, key=lambda s: s.load_intensity)
        axes = (
            np.arange(1.0, bounds.max_p + 1.0),
            np.arange(1.0, bounds.max_cc + 1.0),
            np.arange(1.0, bounds.max_pp + 1.0),
        )
        vals = np.stack([s.surface.dense_eval(*axes) for s in surfaces])
        return cls(
            values=torch.from_numpy(vals.astype(np.float32)).to(device),
            sigma=torch.tensor([s.sigma for s in surfaces],
                               dtype=torch.float32, device=device),
            load=torch.tensor([s.load_intensity for s in surfaces],
                              dtype=torch.float32, device=device),
            argmax_pts=np.array(
                [s.argmax_params.as_tuple() for s in surfaces], np.int32
            ),
            max_throughput=np.array([s.max_throughput for s in surfaces]),
        )

    # ------------------------------------------------------------------ #
    @property
    def n_surfaces(self) -> int:
        return self.values.shape[0]

    @property
    def device(self) -> torch.device:
        return self.values.device

    @property
    def flat_values(self) -> torch.Tensor:
        return self.values.reshape(self.values.shape[0], -1)

    def flat_index(self, pts) -> torch.Tensor:
        """(cc, p, pp) integer points (..., 3) -> flat grid indices (...,)."""
        pts = torch.as_tensor(pts, dtype=torch.int32, device=self.device)
        n_cc, n_pp = self.values.shape[2], self.values.shape[3]
        cc, p, pp = pts[..., 0] - 1, pts[..., 1] - 1, pts[..., 2] - 1
        return (p * n_cc + cc) * n_pp + pp

    def predict(self, pts) -> torch.Tensor:
        """Predict at integer points (..., 3) in (cc, p, pp) order -> (..., S).

        Exact (not interpolated): the lattice holds the spline's own values,
        and online queries never leave the lattice.
        """
        idx = self.flat_index(pts)
        out = ref.take_columns(self.flat_values, idx.reshape(-1))  # (S, K)
        return out.T.reshape(*idx.shape, self.n_surfaces)

    def predict_candidates(self, pts) -> torch.Tensor:
        """Per-request candidate scoring: (B, P, 3) -> (B, S, P)."""
        idx = self.flat_index(pts)
        B, P = idx.shape
        out = ref.take_columns(self.flat_values, idx.reshape(-1))  # (S, B * P)
        return out.reshape(self.n_surfaces, B, P).permute(1, 0, 2)

    def best_candidates(
        self, pts, *, use_kernel: bool | None = None
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """Best candidate per (request, surface): (B, P, 3) -> two (B, S).

        Returns (best value, candidate index) on the stack's device;
        ``use_kernel`` (None: True on CUDA) dispatches through
        ``kernels.ops`` — the CUDA kernel on the card — and False takes the
        plain-torch version wherever the stack lives.
        """
        idx = self.flat_index(pts)
        if resolve_use_kernel(use_kernel, self.device):
            return ops.transfer_predict_argmax(self.flat_values, idx)
        return ref.batched_predict_argmax_ref(self.flat_values, idx)
