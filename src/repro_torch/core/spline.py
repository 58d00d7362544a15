"""Piecewise cubic spline interpolation (Sec. 3.1.1, Eqs. 10-14).

Natural ("relaxed") cubic splines with zero second derivative at the
boundaries, solved from the standard tridiagonal system, and the tensor-
product extension to 3-D (spline over pp of bicubic (p, cc) slices) used for
throughput-surface construction.  The numpy machinery of the JAX package,
copied as it is: the offline fit and the online queries both run on the host
in float64, and the additive refit's batched pp-direction solve goes through
``kernels.ops.nat_spline_fit`` (see ``core.surfaces``).
"""
from __future__ import annotations

import dataclasses

import numpy as np


# --------------------------------------------------------------------------- #
# vectorized numpy natural-spline machinery (the offline hot path)
# --------------------------------------------------------------------------- #
def nat_spline_coeffs(x: np.ndarray, Y: np.ndarray) -> np.ndarray:
    """Natural cubic spline coefficients for many rows at once.

    x: (N,) strictly increasing knots; Y: (R, N) values.
    Returns (R, N-1, 4) local coefficients a + b t + c t^2 + d t^3.
    One shared (N, N) solve serves all R rows.
    """
    x = np.asarray(x, np.float64)
    Y = np.atleast_2d(np.asarray(Y, np.float64))
    R, n = Y.shape
    if n == 1:
        return np.concatenate([Y[:, :, None],
                               np.zeros((R, 1, 3))], -1)
    if n == 2:
        slope = (Y[:, 1] - Y[:, 0]) / (x[1] - x[0])
        out = np.zeros((R, 1, 4))
        out[:, 0, 0] = Y[:, 0]
        out[:, 0, 1] = slope
        return out
    h = np.diff(x)
    A = np.zeros((n, n))
    A[0, 0] = A[-1, -1] = 1.0
    idx = np.arange(1, n - 1)
    A[idx, idx - 1] = h[:-1]
    A[idx, idx] = 2.0 * (h[:-1] + h[1:])
    A[idx, idx + 1] = h[1:]
    rhs = np.zeros((n, R))
    rhs[1:-1] = 6.0 * ((Y[:, 2:] - Y[:, 1:-1]) / h[1:]
                       - (Y[:, 1:-1] - Y[:, :-2]) / h[:-1]).T
    M = np.linalg.solve(A, rhs).T                       # (R, N)
    a = Y[:, :-1]
    b = (Y[:, 1:] - Y[:, :-1]) / h - h * (2.0 * M[:, :-1] + M[:, 1:]) / 6.0
    c = M[:, :-1] / 2.0
    d = (M[:, 1:] - M[:, :-1]) / (6.0 * h)
    return np.stack([a, b, c, d], axis=-1)


def nat_spline_eval(x: np.ndarray, coeffs: np.ndarray, xq) -> np.ndarray:
    """Evaluate row-packed coeffs (R, N-1, 4) at points xq (Q,) -> (R, Q)."""
    x = np.asarray(x, np.float64)
    xq = np.atleast_1d(np.asarray(xq, np.float64))
    i = np.clip(np.searchsorted(x, xq, side="right") - 1, 0, coeffs.shape[1] - 1)
    t = xq - x[i]                                       # (Q,)
    c = coeffs[:, i, :]                                 # (R, Q, 4)
    return c[..., 0] + t * (c[..., 1] + t * (c[..., 2] + t * c[..., 3]))


def nat_spline_eval_rowwise(x: np.ndarray, coeffs: np.ndarray,
                            xq: np.ndarray) -> np.ndarray:
    """Evaluate row r of coeffs (R, N-1, 4) at its own point xq[r] -> (R,)."""
    x = np.asarray(x, np.float64)
    xq = np.asarray(xq, np.float64)
    i = np.clip(np.searchsorted(x, xq, side="right") - 1, 0, coeffs.shape[1] - 1)
    t = xq - x[i]
    c = coeffs[np.arange(coeffs.shape[0]), i, :]        # (R, 4)
    return c[:, 0] + t * (c[:, 1] + t * (c[:, 2] + t * c[:, 3]))


@dataclasses.dataclass(frozen=True)
class TricubicSurface:
    """f(p, cc, pp): 1-D natural spline over pp of bicubic (p, cc) slices.

    This is exactly the paper's construction: "We first fix the value of pp.
    The throughput f(p, pp, cc) then becomes f_pp(p, cc) which is a surface"
    plus the 2-D scheme of Fig. 2 along pp.  Vectorized numpy: the
    pp-direction splines are precomputed at fit time; evaluation batches the
    remaining (cc, then p) solves, sharing the knot matrix across rows.
    """
    gp: np.ndarray     # (N,) parallelism knots
    gcc: np.ndarray    # (M,) concurrency knots
    gpp: np.ndarray    # (K,) pipelining knots
    grid: np.ndarray   # (N, M, K) throughput values
    ppc: np.ndarray    # (N*M, K-1, 4) precomputed pp-direction coefficients

    @classmethod
    def fit(cls, gp, gcc, gpp, grid) -> "TricubicSurface":
        gp = np.asarray(gp, np.float64)
        gcc = np.asarray(gcc, np.float64)
        gpp = np.asarray(gpp, np.float64)
        grid = np.asarray(grid, np.float64)
        ppc = nat_spline_coeffs(gpp, grid.reshape(-1, gpp.shape[0]))
        return cls(gp, gcc, gpp, grid, ppc)

    # ---- internal: bicubic slice at fixed pp ---------------------------- #
    def _slice_at_pp(self, pp: float) -> np.ndarray:
        vals = nat_spline_eval(self.gpp, self.ppc, np.array([pp]))[:, 0]
        return vals.reshape(self.gp.shape[0], self.gcc.shape[0])   # (N, M)

    def _eval_scattered_fixed_pp(self, pq: np.ndarray, ccq: np.ndarray,
                                 pp: float) -> np.ndarray:
        """Evaluate at scattered (p, cc) pairs sharing one pp -> (Q,)."""
        slice_pc = self._slice_at_pp(pp)                            # (N, M)
        ccc = nat_spline_coeffs(self.gcc, slice_pc)                 # (N, M-1, 4)
        # value of each grid row at each query's cc -> (N, Q)
        rows_at_cc = nat_spline_eval(self.gcc, ccc, ccq)
        # per-query spline along p through its own column
        pc = nat_spline_coeffs(self.gp, rows_at_cc.T)               # (Q, N-1, 4)
        return nat_spline_eval_rowwise(self.gp, pc, pq)

    # ---- public API ------------------------------------------------------ #
    def __call__(self, p, cc, pp) -> float:
        return float(self._eval_scattered_fixed_pp(
            np.array([float(p)]), np.array([float(cc)]), float(pp))[0])

    def batch_eval(self, pts) -> np.ndarray:
        """Evaluate at (Q, 3) points [p, cc, pp] -> (Q,)."""
        pts = np.asarray(pts, np.float64)
        out = np.empty(pts.shape[0])
        for pp in np.unique(pts[:, 2]):
            m = pts[:, 2] == pp
            out[m] = self._eval_scattered_fixed_pp(pts[m, 0], pts[m, 1],
                                                   float(pp))
        return out

    def dense_eval(self, pq: np.ndarray, ccq: np.ndarray,
                   ppq: np.ndarray) -> np.ndarray:
        """Tensor evaluation -> (len(pq), len(ccq), len(ppq))."""
        pq = np.asarray(pq, np.float64)
        ccq = np.asarray(ccq, np.float64)
        ppq = np.asarray(ppq, np.float64)
        out = np.empty((len(pq), len(ccq), len(ppq)))
        for k, pp in enumerate(ppq):
            slice_pc = self._slice_at_pp(float(pp))
            ccc = nat_spline_coeffs(self.gcc, slice_pc)
            rows_at_cc = nat_spline_eval(self.gcc, ccc, ccq)        # (N, B)
            pc = nat_spline_coeffs(self.gp, rows_at_cc.T)           # (B, N-1, 4)
            out[:, :, k] = nat_spline_eval(self.gp, pc, pq).T       # (A, B)
        return out

    def hessian_fd(self, x: np.ndarray, h: float = 0.2) -> np.ndarray:
        """Central finite-difference Hessian of the C2 surface at x=(p,cc,pp).

        The surface is piecewise-cubic, so central differences with a modest
        step are exact up to the spline's own smoothness (C2).
        """
        x = np.asarray(x, np.float64)
        pts = [x]
        for i in range(3):
            for s in (+1, -1):
                e = np.zeros(3)
                e[i] = s * h
                pts.append(x + e)
        for i in range(3):
            for j in range(i + 1, 3):
                for si in (+1, -1):
                    for sj in (+1, -1):
                        e = np.zeros(3)
                        e[i] = si * h
                        e[j] = sj * h
                        pts.append(x + e)
        vals = self.batch_eval(np.stack(pts))
        f0 = vals[0]
        H = np.zeros((3, 3))
        k = 1
        for i in range(3):
            fp, fm = vals[k], vals[k + 1]
            k += 2
            H[i, i] = (fp - 2 * f0 + fm) / h ** 2
        for i in range(3):
            for j in range(i + 1, 3):
                fpp_, fpm, fmp, fmm = vals[k], vals[k + 1], vals[k + 2], vals[k + 3]
                k += 4
                H[i, j] = H[j, i] = (fpp_ - fpm - fmp + fmm) / (4 * h ** 2)
        return H


# --------------------------------------------------------------------------- #
# regression strawmen (Sec. 3.1.1 models (1) and (2))
# --------------------------------------------------------------------------- #
def _poly_features(pts: np.ndarray, order: int) -> np.ndarray:
    p, cc, pp = pts[:, 0], pts[:, 1], pts[:, 2]
    cols = [np.ones_like(p)]
    for o in range(1, order + 1):
        for i in range(o + 1):
            for j in range(o - i + 1):
                k = o - i - j
                cols.append((p ** i) * (cc ** j) * (pp ** k))
    return np.stack(cols, axis=1)


@dataclasses.dataclass(frozen=True)
class PolySurface:
    """Least-squares polynomial surface (quadratic/cubic regression)."""
    order: int
    w: np.ndarray

    @classmethod
    def fit(cls, pts, th, order: int) -> "PolySurface":
        X = _poly_features(np.asarray(pts, np.float64), order)
        w, *_ = np.linalg.lstsq(X, np.asarray(th, np.float64), rcond=None)
        return cls(order, w)

    def batch_eval(self, pts) -> np.ndarray:
        return _poly_features(np.asarray(pts, np.float64), self.order) @ self.w

    def __call__(self, p, cc, pp):
        return float(self.batch_eval(np.array([[p, cc, pp]]))[0])
