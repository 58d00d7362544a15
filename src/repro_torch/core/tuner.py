"""Top-level facade: offline fit + online adaptive transfer.

``TransferTuner`` is the object the rest of the framework composes with: the
checkpoint writer, the input pipeline, and the collective scheduler each own
one, pointed at their own log stream and environment (see DESIGN.md Sec. 2).
"""
from __future__ import annotations

import dataclasses

from repro_torch.core.offline import OfflineDB, offline_analysis
from repro_torch.core.online import AdaptiveSampler, TransferReport
from repro_torch.netsim.environment import Environment, ParamBounds, TransferParams
from repro_torch.netsim.loggen import LogEntry
from repro_torch.netsim.workload import Dataset


@dataclasses.dataclass
class TunerConfig:
    bounds: ParamBounds = dataclasses.field(default_factory=ParamBounds)
    n_load_bins: int = 5
    clustering: str = "kmeans++"
    confidence_z: float = 2.0
    max_samples: int = 3
    bulk_chunks: int = 8
    seed: int = 0
    # where the offline fit runs and later refits run their kernels
    # (None: the CUDA card; pass "cpu" to run on the host)
    device: str | None = None


class TransferTuner:
    """Offline knowledge discovery + online adaptive sampling, composed."""

    def __init__(self, config: TunerConfig | None = None):
        self.config = config or TunerConfig()
        self.db: OfflineDB | None = None
        self._pending: list[LogEntry] = []

    # ---------------- offline ---------------- #
    def fit(self, history: list[LogEntry]) -> "TransferTuner":
        c = self.config
        self.db = offline_analysis(history, bounds=c.bounds,
                                   n_load_bins=c.n_load_bins,
                                   clustering=c.clustering, seed=c.seed,
                                   device=c.device)
        return self

    def update(self, new_entries: list[LogEntry]) -> None:
        """Additive periodic refresh (Fig. 7's once-a-day analysis)."""
        assert self.db is not None, "fit() before update()"
        self.db.update(new_entries)

    # ---------------- online ----------------- #
    def transfer(self, env: Environment, dataset: Dataset) -> TransferReport:
        assert self.db is not None, "fit() before transfer()"
        c = self.config
        sampler = AdaptiveSampler(self.db, z=c.confidence_z,
                                  max_samples=c.max_samples,
                                  bulk_chunks=c.bulk_chunks)
        report = sampler.transfer(env, dataset)
        return report

    def recommend(self, env: Environment, dataset: Dataset) -> TransferParams:
        """Zero-probe recommendation (median-load surface argmax)."""
        assert self.db is not None
        from repro_torch.core.online import _request_features
        cluster = self.db.query(_request_features(env, dataset))
        surfaces = cluster.sorted_by_load()
        return surfaces[len(surfaces) // 2].argmax_params
