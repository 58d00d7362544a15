"""NMT: Nelder-Mead direct-search tuning (Balaprakash et al., ICPP'16 [12]).

Model-free simplex search over (cc, p, pp): every evaluation is a real chunk
transfer, every parameter change restarts globus-url-copy (setup + slow
start).  Faithful to the paper's critique: convergence can take 16-20 probes
and suboptimal parameters during convergence hurt overall throughput.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.baselines.common import BaseTuner
from repro_torch.netsim.environment import Environment, ParamBounds, TransferParams
from repro_torch.netsim.workload import Dataset


class NelderMeadTuner(BaseTuner):
    name = "NMT"

    def __init__(self, bounds: ParamBounds = ParamBounds(),
                 n_probes: int = 10):
        super().__init__(bounds)
        self.n_probes = n_probes

    @property
    def n_probe_chunks(self) -> int:
        return self.n_probes

    # -- simplex state over continuous (cc, p, pp); evals snap to ints ---- #
    def start(self, env: Environment, dataset: Dataset) -> TransferParams:
        b = self.bounds
        self._simplex = [np.array([2.0, 2.0, 2.0]),
                         np.array([b.max_cc * 0.6, 2.0, 2.0]),
                         np.array([2.0, b.max_p * 0.6, 2.0]),
                         np.array([2.0, 2.0, b.max_pp * 0.6])]
        self._values: list[float] = []
        self._phase = "init"          # init -> reflect/expand/contract
        self._pending = 0
        self._cand: np.ndarray | None = None
        return self._snap(self._simplex[0])

    def _snap(self, x: np.ndarray) -> TransferParams:
        b = self.bounds
        return TransferParams(int(round(x[0])), int(round(x[1])),
                              int(round(x[2]))).clip(b)

    def observe(self, params: TransferParams, achieved: float,
                chunk_idx: int) -> TransferParams:
        if chunk_idx >= self.n_probes:          # bulk phase: stay converged
            return params
        if self._phase == "init":
            self._values.append(achieved)
            self._pending += 1
            if self._pending < len(self._simplex):
                return self._snap(self._simplex[self._pending])
            self._phase = "search"
            return self._snap(self._reflect())
        # search phase: evaluate candidate, update simplex (maximize)
        worst = int(np.argmin(self._values))
        if achieved > self._values[worst]:
            self._simplex[worst] = self._cand
            self._values[worst] = achieved
        nxt = self._reflect()
        return self._snap(nxt)

    def _reflect(self) -> np.ndarray:
        vals = np.array(self._values)
        worst = int(np.argmin(vals))
        others = [s for i, s in enumerate(self._simplex) if i != worst]
        centroid = np.mean(others, axis=0)
        best = int(np.argmax(vals))
        # reflection with a dash of expansion toward the best vertex
        cand = centroid + 1.0 * (centroid - self._simplex[worst])
        cand = 0.7 * cand + 0.3 * self._simplex[best]
        lo = np.ones(3)
        hi = np.array([self.bounds.max_cc, self.bounds.max_p,
                       self.bounds.max_pp], np.float64)
        self._cand = np.clip(cand, lo, hi)
        return self._cand
