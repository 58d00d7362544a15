"""Suitable sampling regions R_s = R_m U R_c (Sec. 3.1.4, Eqs. 21-23).

R_m: neighbourhoods (radius r_d) of every surface's maxima — where the payoff
is.  R_c: the lambda uniform-sample points that maximize the *minimum*
pairwise separation between surfaces (Eq. 22's max-min objective) — where one
probe is most informative about which surface the network is on.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.surfaces import ThroughputSurface
from repro_torch.netsim.environment import ParamBounds, TransferParams


@dataclasses.dataclass(frozen=True)
class SamplingRegion:
    maxima_points: list[TransferParams]        # centers of R_m
    radius: float                              # r_d
    discriminative_points: list[TransferParams]  # R_c
    separations: list[float]                   # Delta_min at each R_c point

    @property
    def all_points(self) -> list[TransferParams]:
        return list(self.maxima_points) + list(self.discriminative_points)


def identify_sampling_regions(surfaces: list[ThroughputSurface],
                              bounds: ParamBounds, *, r_d: float = 1.5,
                              gamma: int = 256, lam: int = 8,
                              seed: int = 0) -> SamplingRegion:
    rng = np.random.default_rng(seed)
    # R_m: maxima neighbourhoods of every surface in the cluster
    maxima_pts: list[TransferParams] = []
    seen = set()
    for s in surfaces:
        for lm in [s.argmax_params] + [m.params for m in s.local_maxima]:
            if lm.as_tuple() not in seen:
                seen.add(lm.as_tuple())
                maxima_pts.append(lm)

    # R_c: max-min surface separation (Eq. 21-22).  Candidates are the gamma
    # uniform samples of Eq. 21 *plus* the R_m maxima (which sit in
    # data-supported territory); candidates whose mean prediction is below
    # the median are dropped — a point where every surface predicts rubbish
    # separates "surfaces" only through interpolation noise.
    disc_pts: list[TransferParams] = []
    seps: list[float] = []
    if len(surfaces) >= 2:
        u = np.stack([rng.uniform(1, bounds.max_p, gamma),
                      rng.uniform(1, bounds.max_cc, gamma),
                      rng.uniform(1, bounds.max_pp, gamma)], axis=-1)
        um = np.array([[m.p, m.cc, m.pp] for m in maxima_pts], np.float64)
        u = np.concatenate([um, u], axis=0)
        vals = np.stack([s.surface.batch_eval(u) for s in surfaces])
        # Delta_min at each sample: min over surface pairs |f_i - f_j|
        diffs = np.abs(vals[:, None, :] - vals[None, :, :])       # (S, S, g)
        iu = np.triu_indices(len(surfaces), k=1)
        delta_min = diffs[iu].min(axis=0)                          # (gamma+,)
        mean_pred = vals.mean(axis=0)
        ok = mean_pred >= np.median(mean_pred)
        delta_min = np.where(ok, delta_min, -np.inf)
        order = np.argsort(-delta_min)[:lam]
        for k in order:
            if not np.isfinite(delta_min[k]):
                continue
            prm = TransferParams(int(round(u[k, 1])), int(round(u[k, 0])),
                                 int(round(u[k, 2]))).clip(bounds)
            disc_pts.append(prm)
            seps.append(float(delta_min[k]))
    return SamplingRegion(maxima_pts, r_d, disc_pts, seps)
