"""``KnowledgeService``: one facade over offline knowledge and its refresh.

PR 7 unified the two fleet engines behind ``run_fleet``/``EngineConfig``;
this module does the same for the knowledge side.  ``OfflineDB`` vs
``MultiNetworkDB`` and ``KnowledgeRefresher`` vs ``MultiNetworkRefresher``
stop being caller-visible plumbing: a ``KnowledgeService`` wraps either DB
shape and exposes

* ``query``   — sub-millisecond admission decisions off the pre-warmed
  ``SurfaceCache`` (never touches spline fitting);
* ``ingest`` / ``observe`` — streaming mini-batch centroid updates with
  bounded-staleness forced refits (``IncrementalIngestor``);
* ``probe_budget`` / ``notify_fault`` — the opt-in probe-rate backoff loop
  (``ProbePolicy``);
* ``refresh_now`` / ``stats`` — operational control and observability.

Legacy interop mirrors the engine API: passing a ``RefreshConfig`` where a
``ServiceConfig`` is expected still works behind a ``DeprecationWarning``,
and ``from_legacy``/``to_legacy`` round-trip refresher objects.
"""

from __future__ import annotations

import dataclasses
import threading
import warnings

import numpy as np

from repro_torch.core.offline import ClusterKnowledge, MultiNetworkDB, OfflineDB
from repro_torch.core.online import TransferReport
from repro_torch.core.refresh import (
    KnowledgeRefresher,
    MultiNetworkRefresher,
    RefreshConfig,
    session_log_entries,
)
from repro_torch.core.service.backoff import ProbeBackoffConfig, ProbePolicy
from repro_torch.core.service.cache import AdmissionDecision, SurfaceCache
from repro_torch.core.service.ingest import IncrementalIngestor
from repro_torch.netsim.environment import LinkSpec
from repro_torch.netsim.loggen import LogEntry
from repro_torch.netsim.workload import Dataset

# Pair key a single-DB service files everything under; matches the
# ``session_log_entries`` defaults so fleet-session entries route home.
DEFAULT_PAIR = ("fleet", "fleet")


@dataclasses.dataclass(frozen=True)
class ServiceConfig:
    """Validated knobs for :class:`KnowledgeService`.

    ``max_staleness_s``/``drift_threshold`` bound the streaming-ingest path
    (see ``service.ingest``); ``every_completions``/``min_entries`` only
    matter for legacy ``RefreshConfig`` interop (``to_refresh_config``).
    """

    max_staleness_s: float | None = 600.0  # force-refit age bound
    drift_threshold: float = 0.25  # centroid-drift force-refit bound
    cache_pairs: int = 64  # LRU capacity of the admission cache
    every_completions: int = 8  # legacy-interop refresh cadence
    min_entries: int = 8  # legacy-interop refresh gate
    batched_fit: bool = True  # batched Thomas-solve refits
    use_kernel: bool | None = None  # kernels for fit + assignment (None: CUDA)
    backoff: ProbeBackoffConfig | None = None  # probe-rate backoff (opt-in)

    def __post_init__(self) -> None:
        self.validate()

    def validate(self) -> None:
        if self.max_staleness_s is not None and self.max_staleness_s <= 0.0:
            raise ValueError("max_staleness_s must be positive (or None)")
        if self.drift_threshold <= 0.0:
            raise ValueError("drift_threshold must be positive")
        if self.cache_pairs < 1:
            raise ValueError("cache_pairs must be >= 1")
        if self.every_completions < 0:
            raise ValueError("every_completions must be non-negative")
        if self.min_entries < 0:
            raise ValueError("min_entries must be non-negative")
        if self.backoff is not None and not isinstance(
            self.backoff, ProbeBackoffConfig
        ):
            raise TypeError("backoff must be a ProbeBackoffConfig or None")

    # ------------------------- legacy interop ------------------------- #
    @classmethod
    def from_refresh_config(cls, rc: RefreshConfig) -> "ServiceConfig":
        """Lift a legacy cadence config into the service config.

        The sim-time cadence becomes the staleness bound (both answer "how
        old may unfolded observations get"); the completion cadence and
        min-entries gate ride along for :meth:`to_refresh_config` round-trips.
        """
        return cls(
            max_staleness_s=rc.every_sim_s,
            every_completions=rc.every_completions,
            min_entries=rc.min_entries,
            batched_fit=rc.batched_fit,
            use_kernel=rc.use_kernel,
        )

    def to_refresh_config(self) -> RefreshConfig:
        """The legacy cadence config this service config stands in for."""
        return RefreshConfig(
            every_completions=self.every_completions,
            every_sim_s=self.max_staleness_s,
            min_entries=self.min_entries,
            batched_fit=self.batched_fit,
            use_kernel=self.use_kernel,
        )


@dataclasses.dataclass(frozen=True)
class ServiceStats:
    """Monotonic counters snapshot (`KnowledgeService.stats`)."""

    queries: int
    cache_hits: int
    cache_misses: int
    cache_evictions: int
    cache_invalidations: int
    minibatch_updates: int
    refits: int
    refits_drift: int
    refits_staleness: int
    refits_forced: int
    entries_folded: int
    probe_backoffs: int
    probe_resets: int


class KnowledgeService:
    """Unified serving facade over offline knowledge (single or multi-DB).

    The query path is lock-free up to the cache's own short critical
    section; ingest/observe/refresh are serialized by a service lock and —
    like ``KnowledgeRefresher`` — must be called from deterministic points
    (the fleet engines call them inside serialized simulated-time turns).
    """

    def __init__(
        self,
        knowledge: OfflineDB | MultiNetworkDB,
        config: ServiceConfig | RefreshConfig | None = None,
    ) -> None:
        if isinstance(config, RefreshConfig):
            warnings.warn(
                "passing RefreshConfig to KnowledgeService is deprecated; "
                "use ServiceConfig (see ServiceConfig.from_refresh_config)",
                DeprecationWarning,
                stacklevel=2,
            )
            config = ServiceConfig.from_refresh_config(config)
        if config is None:
            config = ServiceConfig()
        if not isinstance(config, ServiceConfig):
            raise TypeError(
                f"config must be a ServiceConfig (or legacy RefreshConfig), "
                f"got {type(config).__name__}"
            )
        if not isinstance(knowledge, (OfflineDB, MultiNetworkDB)):
            raise TypeError(
                f"knowledge must be an OfflineDB or MultiNetworkDB, "
                f"got {type(knowledge).__name__}"
            )
        self.config = config
        self._single = knowledge if isinstance(knowledge, OfflineDB) else None
        self._mdb = knowledge if isinstance(knowledge, MultiNetworkDB) else None
        self._cache = SurfaceCache(config.cache_pairs)
        self._policy = (
            ProbePolicy(config.backoff) if config.backoff is not None else None
        )
        self._lock = threading.Lock()
        # pair -> streaming ingest state
        self._ingestors = {}  # guarded-by: _lock
        # Monitoring counter only (racy-by-design under concurrent queries;
        # the hot path takes no service-level lock).
        self.queries = 0

    # --------------------------- db plumbing --------------------------- #
    @property
    def knowledge(self) -> OfflineDB | MultiNetworkDB:
        return self._single if self._single is not None else self._mdb

    def _key(self, pair: tuple[str, str] | None) -> tuple[str, str]:
        return DEFAULT_PAIR if pair is None else pair

    def db_for(
        self,
        pair: tuple[str, str] | None = None,
        features: np.ndarray | None = None,
    ) -> OfflineDB:
        """The pair's ``OfflineDB``; cold-starts unseen multi-DB pairs.

        A single-DB service answers every pair from its one store.  On a
        ``MultiNetworkDB``, an unknown pair bootstraps from the closest
        known network — which needs ``features``; without them the lookup
        raises instead of guessing.
        """
        if self._single is not None:
            return self._single
        pair = self._key(pair)
        db = self._mdb.get(*pair)
        if db is None:
            if features is None:
                raise ValueError(
                    f"unknown network {pair}: cold-start needs features"
                )
            db = self._mdb.bootstrap(pair[0], pair[1], features)
        return db

    # holds: _lock
    def _ingestor(
        self, pair: tuple[str, str], db: OfflineDB
    ) -> IncrementalIngestor:
        ing = self._ingestors.get(pair)
        if ing is None or ing.db is not db:
            ing = IncrementalIngestor(
                db,
                max_staleness_s=self.config.max_staleness_s,
                drift_threshold=self.config.drift_threshold,
                batched_fit=self.config.batched_fit,
                use_kernel=self.config.use_kernel,
            )
            self._ingestors[pair] = ing
        return ing

    # ---------------------------- hot path ----------------------------- #
    def query(
        self,
        pair: tuple[str, str] | None,
        features: np.ndarray,
    ) -> AdmissionDecision:
        """Admission decision ``(cc, p, pp)`` + predicted rate, sub-ms.

        Routes to the nearest cluster and serves its precomputed median-load
        argmax from the LRU cache; spline fitting never runs here — a refit
        published by ingest is picked up via the cache's object-identity
        staleness test.
        """
        db = self.db_for(pair, np.atleast_2d(np.asarray(features, np.float64)))
        k = db.cluster_model.assign(np.asarray(features, np.float64))
        self.queries += 1
        return self._cache.lookup(self._key(pair), db, k)

    def query_cluster(
        self,
        pair: tuple[str, str] | None,
        features: np.ndarray,
    ) -> ClusterKnowledge:
        """The routed cluster object itself — exactly what ``db.query``
        returns, so engine admission snapshots are unchanged by the facade."""
        db = self.db_for(pair, np.atleast_2d(np.asarray(features, np.float64)))
        return db.query(features)

    def warm(self, pair: tuple[str, str] | None = None) -> int:
        """Pre-build the pair's admission cache; returns decisions built."""
        db = self.db_for(pair)
        return self._cache.warm(self._key(pair), db)

    # ----------------------------- ingest ------------------------------ #
    def ingest(
        self, entries: list[LogEntry], *, now_s: float
    ) -> dict[tuple[str, str], set[int]]:
        """Stream completed-session entries in; returns refit clusters per
        pair (pairs with no forced refit are omitted).

        Centroids update incrementally on every call; full refits fire only
        on the drift/staleness bounds (see ``service.ingest``).
        """
        groups: dict[tuple[str, str], list[LogEntry]] = {}
        for e in entries:
            key = DEFAULT_PAIR if self._single is not None else (e.src, e.dst)
            groups.setdefault(key, []).append(e)
        out: dict[tuple[str, str], set[int]] = {}
        with self._lock:
            for pair, sel in sorted(groups.items()):
                feats = np.stack([e.features() for e in sel])
                db = self.db_for(pair, feats)
                touched = self._ingestor(pair, db).ingest(sel, now_s=now_s)
                if touched:
                    out[pair] = touched
        return out

    def observe(
        self,
        report: TransferReport,
        dataset: Dataset,
        *,
        link: LinkSpec,
        now_s: float,
        pair: tuple[str, str] | None = None,
    ) -> set[int]:
        """Fold one finished session in (and feed the backoff policy).

        Interrupted sessions carry no steady bulk evidence and count as
        volatility; collapse-recovery re-probes reset the backoff too.
        """
        key = self._key(pair)
        if report.interrupted or report.collapses > 0:
            self.notify_fault(pair)
            if report.interrupted:
                return set()
        elif self._policy is not None:
            with self._lock:
                self._policy.observe(key, report.steady_mbps)
        entries = session_log_entries(
            report, link, dataset, end_clock_s=now_s, src=key[0], dst=key[1]
        )
        return self.ingest(entries, now_s=now_s).get(key, set())

    def refresh_now(
        self, pair: tuple[str, str] | None = None
    ) -> dict[tuple[str, str], set[int]]:
        """Force-flush buffered entries into full refits, now.

        One pair when given, every pair with an ingestor otherwise.
        """
        out: dict[tuple[str, str], set[int]] = {}
        with self._lock:
            if pair is not None or self._single is not None:
                key = self._key(pair)
                db = self.db_for(pair)
                touched = self._ingestor(key, db).refresh_now()
                if touched:
                    out[key] = touched
                return out
            for key in sorted(self._ingestors):
                touched = self._ingestors[key].refresh_now()
                if touched:
                    out[key] = touched
        return out

    # ------------------------- probe backoff --------------------------- #
    def probe_budget(
        self,
        pair: tuple[str, str] | None,
        now_s: float,
        default: int,
    ) -> int:
        """Probe budget for a session admitted at ``now_s`` (see backoff)."""
        if self._policy is None:
            return default
        with self._lock:
            return self._policy.probe_budget(self._key(pair), now_s, default)

    def notify_fault(self, pair: tuple[str, str] | None = None) -> None:
        """Volatility/fault signal: snap the pair back to full probing."""
        if self._policy is None:
            return
        with self._lock:
            self._policy.notify_fault(self._key(pair))

    # ------------------------------ stats ------------------------------ #
    def stats(self) -> ServiceStats:
        cache = self._cache.stats()
        with self._lock:
            ings = list(self._ingestors.values())
            pol = self._policy.stats() if self._policy is not None else {}
            drift = sum(i.refits_drift for i in ings)
            stale = sum(i.refits_staleness for i in ings)
            forced = sum(i.refits_forced for i in ings)
            return ServiceStats(
                queries=self.queries,
                cache_hits=cache["hits"],
                cache_misses=cache["misses"],
                cache_evictions=cache["evictions"],
                cache_invalidations=cache["invalidations"],
                minibatch_updates=sum(i.minibatch_updates for i in ings),
                refits=drift + stale + forced,
                refits_drift=drift,
                refits_staleness=stale,
                refits_forced=forced,
                entries_folded=sum(i.entries_folded for i in ings),
                probe_backoffs=pol.get("backoffs", 0),
                probe_resets=pol.get("resets", 0),
            )

    # ------------------------- legacy interop -------------------------- #
    @classmethod
    def from_legacy(
        cls, refresher: KnowledgeRefresher | MultiNetworkRefresher
    ) -> "KnowledgeService":
        """Wrap a legacy refresher's DB + cadence config as a service."""
        if isinstance(refresher, KnowledgeRefresher):
            cfg = ServiceConfig.from_refresh_config(refresher.config)
            return cls(refresher.db, cfg)
        if isinstance(refresher, MultiNetworkRefresher):
            cfg = ServiceConfig.from_refresh_config(refresher.config)
            return cls(refresher.mdb, cfg)
        raise TypeError(
            f"expected a KnowledgeRefresher or MultiNetworkRefresher, "
            f"got {type(refresher).__name__}"
        )

    def to_legacy(
        self, link: LinkSpec | None = None
    ) -> KnowledgeRefresher | MultiNetworkRefresher:
        """The legacy refresher equivalent of this service (same DB)."""
        rc = self.config.to_refresh_config()
        if self._single is not None:
            return KnowledgeRefresher(self._single, link, rc)
        return MultiNetworkRefresher(self._mdb, rc)
