"""HARP: historical analysis + real-time probing with online regression
(Arslan, Guner & Kosar, SC'16 [8]).

Selects historically similar transfers (cosine similarity over request
features, per the original paper), fits a quadratic throughput model, and
refines it online with a few real sample transfers (probes weighted heavily
in the refit) before committing to the model argmax.  The paper's critique
stands: the regression re-runs from scratch for every transfer ("expensive
online optimization ... wasteful as the same optimization needs to be
performed for similar transfers every time"), and a probe landing in TCP
slow start can mislead the refit.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.baselines.common import BaseTuner
from repro_torch.netsim.environment import Environment, ParamBounds, TransferParams
from repro_torch.netsim.loggen import LogEntry
from repro_torch.netsim.workload import Dataset


def _quad_features(x: np.ndarray) -> np.ndarray:
    cc, p, pp = x[:, 0], x[:, 1], x[:, 2]
    return np.stack([np.ones_like(cc), cc, p, pp, cc * p, cc * pp, p * pp,
                     cc ** 2, p ** 2, pp ** 2], axis=1)


def _request_vec(bw, rtt, avg_mb, n_files) -> np.ndarray:
    return np.array([np.log10(bw), np.log10(max(rtt, 1e-5)),
                     np.log10(max(avg_mb, 1e-2)), np.log10(max(n_files, 1))])


class HARP(BaseTuner):
    name = "HARP"

    def __init__(self, history: list[LogEntry],
                 bounds: ParamBounds = ParamBounds(), *, n_probes: int = 3,
                 ridge: float = 1e-3, probe_weight: float = 25.0,
                 top_frac: float = 0.3):
        super().__init__(bounds)
        self.history = history
        self.n_probes = n_probes
        self.ridge = ridge
        self.probe_weight = probe_weight
        self.top_frac = top_frac
        self._grid = np.array([[cc, p, pp]
                               for cc in range(1, bounds.max_cc + 1)
                               for p in range(1, bounds.max_p + 1)
                               for pp in range(1, bounds.max_pp + 1)],
                              np.float64)

    @property
    def n_probe_chunks(self) -> int:
        return self.n_probes

    # ------------------------------------------------------------------ #
    def _fit(self, X: np.ndarray, y: np.ndarray, w: np.ndarray) -> np.ndarray:
        F = _quad_features(X) * w[:, None]
        A = F.T @ F + self.ridge * np.eye(F.shape[1])
        return np.linalg.solve(A, F.T @ (y * w))

    def _argmax(self, coef: np.ndarray) -> TransferParams:
        pred = _quad_features(self._grid) @ coef
        k = int(np.argmax(pred))
        self.predicted_mbps = float(pred[k])   # model's throughput forecast
        return TransferParams(int(self._grid[k, 0]), int(self._grid[k, 1]),
                              int(self._grid[k, 2]))

    def start(self, env: Environment, dataset: Dataset) -> TransferParams:
        # cosine-similar historical transfers (per the HARP paper)
        q = _request_vec(env.link.bandwidth_mbps, env.link.rtt_s,
                         dataset.avg_file_mb, dataset.n_files)
        vecs = np.stack([_request_vec(e.bandwidth_mbps, e.rtt_s,
                                      e.avg_file_mb, e.n_files)
                         for e in self.history])
        sim = (vecs @ q) / (np.linalg.norm(vecs, axis=1)
                            * np.linalg.norm(q) + 1e-12)
        k = max(int(len(self.history) * self.top_frac), 32)
        idx = np.argsort(-sim)[:k]
        self._hX = np.array([[self.history[i].cc, self.history[i].p,
                              self.history[i].pp] for i in idx], np.float64)
        self._hy = np.array([self.history[i].throughput_mbps for i in idx])
        coef = self._fit(self._hX, self._hy, np.ones(len(self._hy)))
        seed = self._argmax(coef)
        # probe schedule: model argmax + perturbations around it
        b = self.bounds
        plan = [
            seed,
            TransferParams(min(seed.cc * 2, b.max_cc),
                           max(seed.p // 2, 1), seed.pp),
            TransferParams(max(seed.cc // 2, 1),
                           min(seed.p * 2, b.max_p), seed.pp),
            TransferParams(seed.cc, seed.p,
                           min(seed.pp * 2, b.max_pp) if seed.pp > 1
                           else max(seed.pp // 2, 1)),
            TransferParams(min(seed.cc + 4, b.max_cc),
                           min(seed.p + 4, b.max_p), seed.pp),
        ]
        while len(plan) < self.n_probes:
            k = len(plan)
            plan.append(TransferParams(
                1 + (seed.cc + 3 * k) % b.max_cc,
                1 + (seed.p + 5 * k) % b.max_p,
                1 + (seed.pp + 7 * k) % b.max_pp))
        self._plan = plan[: self.n_probes]
        self._probes: list[tuple[TransferParams, float]] = []
        self._committed: TransferParams | None = None
        return self._plan[0]

    def observe(self, params: TransferParams, achieved: float,
                chunk_idx: int) -> TransferParams:
        if self._committed is not None:
            return self._committed
        self._probes.append((params, achieved))
        if chunk_idx + 1 < self.n_probes:
            return self._plan[chunk_idx + 1]
        # refit with probes dominating: history supplies curvature, probes
        # anchor today's level
        pX = np.array([[pr.cc, pr.p, pr.pp] for pr, _ in self._probes])
        py = np.array([th for _, th in self._probes])
        X = np.concatenate([self._hX, pX])
        y = np.concatenate([self._hy, py])
        w = np.concatenate([np.ones(len(self._hy)),
                            np.full(len(py), self.probe_weight)])
        self._committed = self._argmax(self._fit(X, y, w))
        return self._committed
