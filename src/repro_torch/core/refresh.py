"""Continuous knowledge refresh: closing the offline <-> online loop.

The paper's offline model is explicitly additive (Sec. 3: "when new logs are
generated ... we do not need to combine it with previous logs and perform
analysis on whole log"), yet nothing in the single-transfer or fleet paths
ever feeds completed transfers back into the ``OfflineDB`` — thousands of
achieved-throughput observations are discarded per fleet run and the
knowledge goes stale the moment the network drifts.  This module closes the
loop, the regime the two-phase follow-up (arXiv:1812.11255) and the
historical-analysis + real-time-tuning line (arXiv:1708.03053) show is what
sustains accuracy on non-dedicated links:

* ``session_log_entries`` converts a finished session's bulk-phase
  ``SampleRecord``s into Globus-schema ``LogEntry``s — each steady chunk is
  one observation of (params, achieved throughput) under the live load.
* ``KnowledgeRefresher`` buffers those entries and drives
  ``OfflineDB.update()`` on a configurable cadence (every K completed
  sessions and/or every T simulated seconds), tracking per-cluster
  staleness.  Refits route through the batched Thomas-solve spline kernel
  (``kernels.ops.nat_spline_fit``; CUDA on the card) and ``OfflineDB.update``
  publishes each refit cluster with a single atomic swap, so in-flight
  sessions and batched admission queries never observe a half-refit cluster.

``FleetScheduler`` owns one refresher when ``FleetConfig.refresh`` is set and
calls :meth:`KnowledgeRefresher.observe` inside each finishing tenant's final
serialized turn, which keeps fleet runs deterministic: refreshes land in
simulated-time finish order, never wall-clock thread order.
"""

from __future__ import annotations

import dataclasses
import threading

import numpy as np

from repro_torch.core.offline import MultiNetworkDB, OfflineDB
from repro_torch.core.online import TransferReport
from repro_torch.netsim.environment import LinkSpec
from repro_torch.netsim.loggen import LogEntry
from repro_torch.netsim.workload import Dataset


@dataclasses.dataclass(frozen=True)
class RefreshConfig:
    """Cadence and fit-path knobs for continuous knowledge refresh."""

    every_completions: int = 8  # refresh after K finished sessions...
    every_sim_s: float | None = None  # ...or after T simulated seconds
    min_entries: int = 8  # defer while fewer fresh entries are buffered
    batched_fit: bool = True  # batched Thomas-solve refits (kernels.ops)
    use_kernel: bool | None = None  # hand-written kernels (None: on CUDA)


@dataclasses.dataclass
class ClusterStaleness:
    """How far one cluster's knowledge lags the live fleet."""

    last_refresh_s: float | None = None  # sim time of the last refit
    entries_since_refresh: int = 0  # observations not yet folded in
    refreshes: int = 0

    def staleness_s(self, now_s: float) -> float:
        """Simulated seconds since this cluster last absorbed fresh logs
        (``inf`` until its first refresh)."""
        if self.last_refresh_s is None:
            return float("inf")
        return max(float(now_s) - self.last_refresh_s, 0.0)


def session_log_entries(
    report: TransferReport,
    link: LinkSpec,
    dataset: Dataset,
    *,
    end_clock_s: float,
    src: str = "fleet",
    dst: str = "fleet",
) -> list[LogEntry]:
    """Convert a finished session's bulk-phase records into log entries.

    Only bulk chunks are folded back: they are steady-state observations at
    the converged parameters, whereas probes are tiny transfers at
    deliberately discriminative points whose effective rates are dominated
    by setup cost.  Timestamps are reconstructed by walking the recorded
    chunk durations back from the session's end clock.  The latent
    ``ext_load`` field (oracle-only; the offline fit never reads it) carries
    the converged surface's load tag — the session's own load estimate.
    Contender-rate fields stay zero: fleet fair-share contention is exactly
    the uncharted traffic the paper's I_s heuristic attributes residually.
    """
    bulk = [r for r in report.samples if not r.was_sample]
    t = float(end_clock_s) - sum(r.elapsed_s for r in bulk)
    out = []
    for r in bulk:
        out.append(
            LogEntry(
                src=src,
                dst=dst,
                bandwidth_mbps=link.bandwidth_mbps,
                rtt_s=link.rtt_s,
                avg_file_mb=dataset.avg_file_mb,
                n_files=dataset.n_files,
                cc=r.params.cc,
                p=r.params.p,
                pp=r.params.pp,
                throughput_mbps=max(float(r.achieved), 0.0),
                timestamp_s=t,
                ext_load=float(r.surface_load),
            )
        )
        t += r.elapsed_s
    return out


class KnowledgeRefresher:
    """Feeds completed transfers back into offline knowledge on a cadence.

    ``observe`` is cheap (buffering plus cluster routing); the refit itself
    runs when the cadence fires and touches only the clusters that received
    fresh entries — the paper's additive update, at fleet scale.  The caller
    is responsible for serializing ``observe`` with respect to in-flight
    queries when determinism matters (the fleet scheduler calls it inside a
    simulated-time turn); the internal lock merely keeps the refresher
    itself consistent under stray concurrent calls.
    """

    def __init__(
        self,
        db: OfflineDB,
        link: LinkSpec | None = None,
        config: RefreshConfig | None = None,
    ):
        self.db = db
        self.link = link
        self.config = config or RefreshConfig()
        self.staleness = {  # guarded-by: _lock
            k: ClusterStaleness() for k in range(len(db.clusters))
        }
        self.refreshes = 0  # guarded-by: _lock -- refresh rounds actually run
        self.entries_folded = 0  # guarded-by: _lock -- entries folded so far
        self._pending: list[LogEntry] = []  # guarded-by: _lock
        self._pending_clusters: list[int] = []  # guarded-by: _lock
        self._completions_since = 0  # guarded-by: _lock
        self._last_refresh_s: float | None = None  # guarded-by: _lock
        self._lock = threading.Lock()

    # ------------------------------------------------------------------ #
    @property
    def pending_entries(self) -> int:
        with self._lock:
            return len(self._pending)

    def stalest_cluster_s(self, now_s: float) -> float:
        """Worst per-cluster staleness at ``now_s`` (monitoring hook)."""
        with self._lock:
            return max(s.staleness_s(now_s) for s in self.staleness.values())

    # ------------------------------------------------------------------ #
    def observe(
        self, report: TransferReport, dataset: Dataset, *, now_s: float
    ) -> bool:
        """Fold one finished session into the buffer; refresh when due.

        Returns True when this observation triggered a refresh round.
        """
        if self.link is None:
            raise ValueError(
                "observe() needs the LinkSpec the refresher was built "
                "without; use ingest() for pre-built LogEntry batches"
            )
        entries = session_log_entries(report, self.link, dataset, end_clock_s=now_s)
        return bool(self.ingest(entries, now_s=now_s))

    def ingest(self, entries: list[LogEntry], *, now_s: float) -> set[int]:
        """Fold pre-built log entries into the buffer; refresh when due.

        The Globus-schema twin of :meth:`observe` — cold-started networks
        specialize through this path, feeding whatever fresh logs their
        endpoint pair produces straight into the additive update.  Each
        call counts as one completion toward the refresh cadence.  Returns
        the refit cluster indices (empty when the cadence did not fire).
        """
        with self._lock:
            for e in entries:
                # route once; the refit reuses this assignment via
                # OfflineDB.update(assignments=...)
                k = int(self.db.cluster_model.assign(e.features()))
                self.staleness[k].entries_since_refresh += 1
                self._pending_clusters.append(k)
            self._pending.extend(entries)
            self._completions_since += 1
            if not self._due(now_s):
                return set()
            return self._refresh_locked(now_s)

    def refresh(self, now_s: float) -> set[int]:
        """Force a refresh round now; returns the refit cluster indices."""
        with self._lock:
            return self._refresh_locked(now_s)

    # ------------------------------------------------------------------ #
    def _due(self, now_s: float) -> bool:  # holds: _lock
        if len(self._pending) < self.config.min_entries:
            return False
        if (
            self.config.every_completions
            and self._completions_since >= self.config.every_completions
        ):
            return True
        if self.config.every_sim_s is not None:
            last = self._last_refresh_s
            return last is None or now_s - last >= self.config.every_sim_s
        return False

    def _refresh_locked(self, now_s: float) -> set[int]:  # holds: _lock
        if not self._pending:
            return set()
        touched = self.db.update(
            self._pending,
            batched_fit=self.config.batched_fit,
            use_kernel=self.config.use_kernel,
            assignments=self._pending_clusters,
        )
        self.entries_folded += len(self._pending)
        self.refreshes += 1
        self._pending = []
        self._pending_clusters = []
        self._completions_since = 0
        self._last_refresh_s = float(now_s)
        for k in touched:
            st = self.staleness[k]
            st.last_refresh_s = float(now_s)
            st.entries_since_refresh = 0
            st.refreshes += 1
        return touched


class MultiNetworkRefresher:
    """Routes fresh log entries to per-network refreshers over a
    ``MultiNetworkDB``.

    Networks appear lazily: the first entries for an unseen endpoint pair
    cold-start that pair's knowledge from the closest known network (by
    centroid distance over the entries' own features), then specialize it
    through the standard per-network refresh cadence.  Every network keeps
    its own ``KnowledgeRefresher`` — and therefore its own staleness
    ledger — so a busy testbed refreshing often never masks a quiet one
    going stale.
    """

    def __init__(self, mdb: MultiNetworkDB, config: RefreshConfig | None = None):
        self.mdb = mdb
        self.config = config or RefreshConfig()
        self._refreshers: dict[tuple[str, str], KnowledgeRefresher] = {}

    def refresher_for(
        self,
        src: str,
        dst: str,
        *,
        features=None,
        link: LinkSpec | None = None,
    ) -> KnowledgeRefresher:
        """The pair's refresher, cold-starting its DB if the pair is new.

        ``features`` (one or more ``LogEntry.features()`` vectors) is only
        required for the cold-start case; ``link`` only if the caller wants
        :meth:`KnowledgeRefresher.observe` on the result.
        """
        pair = (src, dst)
        r = self._refreshers.get(pair)
        if r is not None:
            if r.link is None and link is not None:
                r.link = link  # late-supplied LinkSpec unlocks observe()
            return r
        db = self.mdb.get(src, dst)
        if db is None:
            if features is None:
                raise ValueError(
                    f"unknown network {pair}: cold-start needs features"
                )
            db = self.mdb.bootstrap(src, dst, features)
        r = KnowledgeRefresher(db, link, self.config)
        self._refreshers[pair] = r
        return r

    def ingest(
        self, entries: list[LogEntry], *, now_s: float
    ) -> dict[tuple[str, str], set[int]]:
        """Route a mixed-network entry batch; returns refit clusters per
        pair (only pairs whose cadence fired appear)."""
        groups: dict[tuple[str, str], list[LogEntry]] = {}
        for e in entries:
            groups.setdefault((e.src, e.dst), []).append(e)
        touched: dict[tuple[str, str], set[int]] = {}
        for pair, sel in sorted(groups.items()):
            r = self._refreshers.get(pair)
            if r is None:
                # feature matrix only matters for the cold-start of an
                # unseen pair; skip the per-entry Python loop otherwise
                feats = None
                if self.mdb.get(*pair) is None:
                    feats = np.stack([e.features() for e in sel])
                r = self.refresher_for(pair[0], pair[1], features=feats)
            t = r.ingest(sel, now_s=now_s)
            if t:
                touched[pair] = t
        return touched
