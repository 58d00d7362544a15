"""Incremental knowledge ingest with bounded staleness.

Streams completed-session ``LogEntry``s into the cluster model *without* a
full refit: each batch takes one Sculley mini-batch k-means step
(``ClusterModel.partial_fit``), so centroids track regime drift immediately,
while the entries themselves are buffered per cluster.  Two triggers bound
how stale the fitted surfaces may get relative to the drifting centroids:

* **drift** — a cluster whose incrementally-updated centroid has moved more
  than ``drift_threshold`` (euclidean, log-feature space) from its anchor
  (its position at the last full refit) is force-refit;
* **staleness** — a cluster holding buffered entries older than
  ``max_staleness_s`` simulation-seconds is force-refit, so every
  observation is folded into surfaces within a bounded window.

Forced refits flush the buffered entries through ``OfflineDB.update`` —
reusing PR 3's atomic publish-by-slot-swap — then re-anchor the cluster.
Everything is simulation-time driven and assignment goes through the
arithmetic-identical chunked path, so identical ingest sequences produce
identical knowledge states.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.offline import OfflineDB
from repro_torch.device import resolve_device, resolve_use_kernel
from repro_torch.netsim.loggen import LogEntry


@dataclasses.dataclass
class _PendingCluster:
    """Buffered-but-unfitted entries for one cluster."""

    entries: list[LogEntry] = dataclasses.field(default_factory=list)
    first_buffered_s: float | None = None


class IncrementalIngestor:
    """Streaming ingest state for one ``OfflineDB``.

    Not internally locked: the owning ``KnowledgeService`` serializes calls.
    """

    def __init__(
        self,
        db: OfflineDB,
        *,
        max_staleness_s: float | None = 600.0,
        drift_threshold: float = 0.25,
        batched_fit: bool = True,
        use_kernel: bool | None = None,
    ) -> None:
        self.db = db
        self.max_staleness_s = max_staleness_s
        self.drift_threshold = drift_threshold
        self.batched_fit = batched_fit
        self.use_kernel = use_kernel
        # Centroid positions at the last full refit (the drift anchors).
        self._anchors = np.array(db.cluster_model.centroids, np.float64)
        self._pending: dict[int, _PendingCluster] = {}
        self.minibatch_updates = 0
        self.refits_drift = 0
        self.refits_staleness = 0
        self.refits_forced = 0
        self.entries_folded = 0

    # ------------------------------------------------------------------ #
    def drift(self, k: int) -> float:
        """Euclidean distance of cluster k's centroid from its anchor."""
        delta = self.db.cluster_model.centroids[k] - self._anchors[k]
        return float(np.sqrt((delta * delta).sum()))

    def staleness_s(self, k: int, now_s: float) -> float:
        """Age of cluster k's oldest buffered-but-unfitted entry (0 if none)."""
        st = self._pending.get(k)
        if st is None or st.first_buffered_s is None:
            return 0.0
        return now_s - st.first_buffered_s

    @property
    def pending_entries(self) -> int:
        return sum(len(st.entries) for st in self._pending.values())

    # ------------------------------------------------------------------ #
    def ingest(self, entries: list[LogEntry], *, now_s: float) -> set[int]:
        """Fold a batch in; returns the set of force-refit cluster indices.

        Centroids move incrementally on every call; surfaces refit only for
        clusters tripping the drift or staleness bound.
        """
        cm = self.db.cluster_model
        if entries:
            X = np.stack([e.features() for e in entries])
            dev = resolve_device(self.db.device)
            labels = cm.partial_fit(
                X, use_kernel=resolve_use_kernel(self.use_kernel, dev),
                device=dev)
            self.minibatch_updates += 1
            for e, k in zip(entries, labels):
                st = self._pending.setdefault(int(k), _PendingCluster())
                st.entries.append(e)
                if st.first_buffered_s is None:
                    st.first_buffered_s = now_s
        due = []
        for k in sorted(self._pending):
            if not self._pending[k].entries:
                continue
            if self.drift(k) >= self.drift_threshold:
                due.append(k)
                self.refits_drift += 1
            elif (
                self.max_staleness_s is not None
                and self.staleness_s(k, now_s) >= self.max_staleness_s
            ):
                due.append(k)
                self.refits_staleness += 1
        if due:
            self._refit(due)
        return set(due)

    def refresh_now(self) -> set[int]:
        """Force-flush every cluster holding buffered entries."""
        due = [k for k in sorted(self._pending) if self._pending[k].entries]
        if due:
            self._refit(due)
            self.refits_forced += len(due)
        return set(due)

    # ------------------------------------------------------------------ #
    def _refit(self, due: list[int]) -> None:
        """Flush buffered entries of ``due`` clusters through a full refit."""
        flat: list[LogEntry] = []
        assignments: list[int] = []
        for k in due:  # ascending: update() publishes in this order anyway
            st = self._pending[k]
            flat.extend(st.entries)
            assignments.extend([k] * len(st.entries))
            st.entries = []
            st.first_buffered_s = None
        self.db.update(
            flat,
            batched_fit=self.batched_fit,
            use_kernel=self.use_kernel,
            assignments=assignments,
        )
        self.entries_folded += len(flat)
        for k in due:  # re-anchor at the post-refit centroid
            self._anchors[k] = self.db.cluster_model.centroids[k]
