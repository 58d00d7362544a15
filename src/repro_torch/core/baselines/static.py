"""SP: static parameters mined from historical logs [44].

Computes, per file-size class, the parameter combination with the best mean
historical throughput, and always uses it — knowledge-informed but blind to
current conditions (the paper's "hysteresis-based" static settings)."""
from __future__ import annotations

from collections import defaultdict

import numpy as np

from repro_torch.core.baselines.common import BaseTuner
from repro_torch.netsim.environment import Environment, ParamBounds, TransferParams
from repro_torch.netsim.loggen import LogEntry
from repro_torch.netsim.workload import Dataset, FILE_CLASSES


def _file_class(avg_file_mb: float) -> str:
    if avg_file_mb < FILE_CLASSES["medium"][0]:
        return "small"
    if avg_file_mb < FILE_CLASSES["large"][0]:
        return "medium"
    return "large"


class StaticParams(BaseTuner):
    name = "SP"

    def __init__(self, history: list[LogEntry],
                 bounds: ParamBounds = ParamBounds()):
        super().__init__(bounds)
        acc: dict[str, dict[tuple, list[float]]] = defaultdict(
            lambda: defaultdict(list))
        for e in history:
            acc[_file_class(e.avg_file_mb)][(e.cc, e.p, e.pp)].append(
                e.throughput_mbps)
        self.policy: dict[str, TransferParams] = {}
        for fclass, table in acc.items():
            # require a few observations so one lucky probe doesn't win
            cand = {k: np.mean(v) for k, v in table.items() if len(v) >= 2}
            if not cand:
                cand = {k: np.mean(v) for k, v in table.items()}
            best = max(cand, key=cand.get)
            self.policy[fclass] = TransferParams(*best)
        for fclass in FILE_CLASSES:
            self.policy.setdefault(fclass, TransferParams(4, 4, 4))

    def start(self, env: Environment, dataset: Dataset) -> TransferParams:
        return self.policy[dataset.file_class]
