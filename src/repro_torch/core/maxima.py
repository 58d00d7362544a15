"""Surface maxima via the second-partial-derivative test (Sec. 3.1.2).

The parameter domain is the bounded integer box Psi^3 = {1..beta}^3.  We scan
a dense fractional grid for local maxima of the C2 spline surface, classify
interior candidates with the Hessian (negative-definite => local maximum,
Eqs. 18-19; the Hessian is exact central differences of the piecewise-cubic
surface), keep boundary maxima by neighbourhood dominance, and snap the
global argmax back onto the integer grid the protocol actually accepts.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.spline import TricubicSurface
from repro_torch.netsim.environment import ParamBounds, TransferParams


@dataclasses.dataclass(frozen=True)
class LocalMax:
    params: TransferParams
    value: float
    interior: bool         # True if certified by the Hessian test


def _dense_axes(bounds: ParamBounds, step: float) -> list[np.ndarray]:
    return [np.arange(1.0, b + 1e-9, step)
            for b in (bounds.max_p, bounds.max_cc, bounds.max_pp)]


def _shifted_max(V: np.ndarray) -> np.ndarray:
    pad = np.pad(V, 1, constant_values=-np.inf)
    out = np.full_like(V, -np.inf)
    for di in (-1, 0, 1):
        for dj in (-1, 0, 1):
            for dk in (-1, 0, 1):
                if di == dj == dk == 0:
                    continue
                out = np.maximum(out, pad[1 + di:V.shape[0] + 1 + di,
                                          1 + dj:V.shape[1] + 1 + dj,
                                          1 + dk:V.shape[2] + 1 + dk])
    return out


def find_local_maxima(surface: TricubicSurface, bounds: ParamBounds,
                      *, step: float = 1.0, hess_tol: float = 1e-7,
                      top_k: int = 8) -> list[LocalMax]:
    axes = _dense_axes(bounds, step)
    V = surface.dense_eval(*axes)
    is_peak = V >= _shifted_max(V)
    cand_idx = np.argwhere(is_peak)

    out: list[LocalMax] = []
    for (i, j, k) in cand_idx:
        x = np.array([axes[0][i], axes[1][j], axes[2][k]])
        on_boundary = (i in (0, len(axes[0]) - 1) or j in (0, len(axes[1]) - 1)
                       or k in (0, len(axes[2]) - 1))
        interior = False
        if not on_boundary:
            H = surface.hessian_fd(x)
            eig = np.linalg.eigvalsh(0.5 * (H + H.T))
            interior = bool(np.all(eig < hess_tol))
            if not interior:
                continue   # interior non-max saddle: reject per the test
        prm = TransferParams(int(round(x[1])), int(round(x[0])),
                             int(round(x[2]))).clip(bounds)
        out.append(LocalMax(prm, float(V[i, j, k]), interior))
    out.sort(key=lambda lm: -lm.value)
    return out[:top_k]


def integer_argmax(surface: TricubicSurface, bounds: ParamBounds
                   ) -> tuple[TransferParams, float]:
    """Global argmax snapped to the integer protocol domain."""
    maxima = find_local_maxima(surface, bounds)
    best_prm, best_val = None, -np.inf
    seen: set[tuple[int, int, int]] = set()
    cand: list[TransferParams] = []
    for lm in maxima or [LocalMax(TransferParams(1, 1, 1), 0.0, False)]:
        # probe the 27-point integer neighbourhood of each local max
        for dcc in (-1, 0, 1):
            for dp in (-1, 0, 1):
                for dpp in (-1, 0, 1):
                    prm = TransferParams(lm.params.cc + dcc, lm.params.p + dp,
                                         lm.params.pp + dpp).clip(bounds)
                    if prm.as_tuple() not in seen:
                        seen.add(prm.as_tuple())
                        cand.append(prm)
    vals = surface.batch_eval(np.array([[c.p, c.cc, c.pp] for c in cand],
                                       np.float64))
    k = int(np.argmax(vals))
    return cand[k], float(vals[k])
