"""Pre-warmed admission cache: sub-millisecond ``(cc, p, pp)`` decisions.

The offline phase already precomputes every surface's integer-lattice argmax
(``ThroughputSurface.argmax_params``), and ``SurfaceStack`` carries the same
optima in batched form — the admission hot path therefore never needs spline
math, only (a) nearest-centroid routing and (b) a lookup of the routed
cluster's precomputed decision.  ``SurfaceCache`` keeps those decisions (plus
a pre-warmed ``SurfaceStack``) per endpoint pair with LRU eviction, and
detects refreshed knowledge by object identity: ``OfflineDB.update`` swaps in
*fresh* ``ClusterKnowledge`` objects atomically (PR 3), so ``is`` against the
live cluster list is an exact, O(1) staleness test.
"""

from __future__ import annotations

import dataclasses
import threading

from repro_torch.core.offline import ClusterKnowledge, OfflineDB
from repro_torch.netsim.environment import TransferParams


@dataclasses.dataclass(frozen=True)
class AdmissionDecision:
    """One cluster's precomputed admission answer.

    ``params`` is the argmax of the cluster's median-load surface — the same
    surface the fleet demand predictor starts sessions from — and
    ``predicted_mbps`` its precomputed maximum.
    """

    params: TransferParams
    predicted_mbps: float
    cluster_index: int

    def as_tuple(self) -> tuple[int, int, int]:
        return self.params.as_tuple()


@dataclasses.dataclass
class _CacheEntry:
    """Cached decision + the exact cluster object it was derived from."""

    cluster: ClusterKnowledge
    decision: AdmissionDecision


class SurfaceCache:
    """LRU cache of per-pair, per-cluster admission decisions.

    Keyed by endpoint pair; at most ``capacity`` pairs stay resident, evicted
    in least-recently-used order (dict insertion order maintained by
    pop/reinsert, so eviction is deterministic for a deterministic query
    sequence).  Building an entry pre-warms the cluster's ``SurfaceStack`` so
    a later batched consumer (the vectorized engine) never fits on its hot
    path either.
    """

    def __init__(self, capacity: int = 64) -> None:
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self.capacity = capacity
        self._lock = threading.Lock()
        # pair -> {cluster index -> _CacheEntry}; LRU order over pairs
        self._pairs: dict[tuple[str, str], dict[int, _CacheEntry]] = {}
        self.hits = 0  # guarded-by: _lock
        self.misses = 0  # guarded-by: _lock
        self.evictions = 0  # guarded-by: _lock
        self.invalidations = 0  # guarded-by: _lock

    # ------------------------------------------------------------------ #
    # holds: _lock
    def _build(self, db: OfflineDB, k: int) -> _CacheEntry:
        return self._build_from(db.clusters[k], db.bounds, k)

    # holds: _lock
    @staticmethod
    def _build_from(ck: ClusterKnowledge, bounds, k: int) -> _CacheEntry:
        stack = ck.surface_stack(bounds)  # pre-warm the batched view
        mid = stack.n_surfaces // 2  # median-load surface (ascending sort)
        cc, p, pp = (int(v) for v in stack.argmax_pts[mid])
        decision = AdmissionDecision(
            params=TransferParams(cc=cc, p=p, pp=pp),
            predicted_mbps=float(stack.max_throughput[mid]),
            cluster_index=k,
        )
        return _CacheEntry(cluster=ck, decision=decision)

    def lookup(
        self, pair: tuple[str, str], db: OfflineDB, k: int
    ) -> AdmissionDecision:
        """Decision for cluster ``k`` of ``db``; build/refresh on demand."""
        with self._lock:
            entry_map = self._pairs.pop(pair, None)
            if entry_map is None:
                entry_map = {}
            self._pairs[pair] = entry_map  # pop/reinsert = move to MRU end
            if len(self._pairs) > self.capacity:
                self._pairs.pop(next(iter(self._pairs)))
                self.evictions += 1
            ent = entry_map.get(k)
            if ent is not None and ent.cluster is db.clusters[k]:
                self.hits += 1
                return ent.decision
            if ent is not None:
                self.invalidations += 1  # refresh swapped the cluster object
            else:
                self.misses += 1
            ent = self._build(db, k)
            entry_map[k] = ent
            return ent.decision

    def warm(self, pair: tuple[str, str], db: OfflineDB) -> int:
        """Pre-build every cluster decision for a pair; returns the count.

        One critical section, one ``db.clusters`` snapshot: warming used to
        run a separate locked ``lookup`` per cluster, so an
        ``OfflineDB.update`` landing mid-warm could leave the pair's entry
        map spanning two knowledge generations — and a cluster-*count*
        change between the initial ``len()`` and a later per-cluster build
        raised ``IndexError`` inside ``_build``.  Every entry is now built
        from the same snapshotted cluster list, and decisions for clusters
        beyond the snapshot's count are dropped so the map never mixes
        generations.
        """
        with self._lock:
            clusters = list(db.clusters)
            bounds = db.bounds
            entry_map = self._pairs.pop(pair, None)
            if entry_map is None:
                entry_map = {}
            self._pairs[pair] = entry_map  # pop/reinsert = move to MRU end
            if len(self._pairs) > self.capacity:
                self._pairs.pop(next(iter(self._pairs)))
                self.evictions += 1
            for k, ck in enumerate(clusters):
                ent = entry_map.get(k)
                if ent is not None and ent.cluster is ck:
                    self.hits += 1
                    continue
                if ent is not None:
                    self.invalidations += 1
                else:
                    self.misses += 1
                entry_map[k] = self._build_from(ck, bounds, k)
            for k in [k for k in entry_map if k >= len(clusters)]:
                del entry_map[k]
            return len(clusters)

    def stats(self) -> dict[str, int]:
        with self._lock:
            return {
                "pairs": len(self._pairs),
                "hits": self.hits,
                "misses": self.misses,
                "evictions": self.evictions,
                "invalidations": self.invalidations,
            }
