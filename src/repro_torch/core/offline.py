"""Offline knowledge-discovery phase (Sec. 3.1).

Pipeline per fit: cluster logs hierarchically -> per cluster, bin entries by
external load intensity -> fit a confidence-banded spline surface per bin ->
precompute maxima -> identify sampling regions.  The result is an
``OfflineDB`` the online phase queries in O(#clusters) time.

The model is *additive* (Sec. 3: "when new logs are generated ... we do not
need to combine it with previous logs and perform analysis on whole log"):
``OfflineDB.update(new_entries)`` routes new entries to their nearest cluster
and refits only the touched (cluster, bin) surfaces, keeping raw per-cluster
entry stores so grid aggregation stays exact.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch.device import resolve_device, resolve_use_kernel
from repro_torch.core.clustering import ClusterModel, fit_clusters
from repro_torch.core.contention import (
    load_intensity, residual_intensity_bins,
)
from repro_torch.core.regions import SamplingRegion, identify_sampling_regions
from repro_torch.core.surfaces import (
    ThroughputSurface, fit_surface, fit_surfaces_batched, scale_surface,
)
from repro_torch.netsim.environment import ParamBounds
from repro_torch.netsim.loggen import LogEntry


@dataclasses.dataclass
class ClusterKnowledge:
    """Everything the online phase needs about one cluster."""
    centroid: np.ndarray
    surfaces: list[ThroughputSurface]      # sorted ascending by load intensity
    region: SamplingRegion
    entries: list[LogEntry]                # raw store for additive refits
    region_seed: int = 0                   # persisted so refits are replayable
    dirty: bool = False
    # device of the DB this cluster belongs to, where its batched view lives
    # (None: the CUDA card, see ``device.resolve_device``)
    device: torch.device | None = dataclasses.field(default=None,
                                                    compare=False)
    _stack: object = dataclasses.field(default=None, repr=False, compare=False)

    def sorted_by_load(self) -> list[ThroughputSurface]:
        return sorted(self.surfaces, key=lambda s: s.load_intensity)

    def surface_stack(self, bounds: ParamBounds):
        """Lazily-built batched view of this cluster's surfaces (fleet path),
        on the cluster's device.

        Cached per ``(bounds, device)``; invalidated whenever
        :meth:`OfflineDB.update` refits this cluster.
        """
        key = (bounds, resolve_device(self.device))
        if self._stack is None or self._stack[0] != key:
            from repro_torch.core.batched import SurfaceStack
            self._stack = (key, SurfaceStack.from_surfaces(self.surfaces,
                                                           *key))
        return self._stack[1]


@dataclasses.dataclass
class OfflineDB:
    clusters: list[ClusterKnowledge]
    cluster_model: ClusterModel
    bounds: ParamBounds
    n_load_bins: int
    fit_seconds: float
    # endpoint pair this knowledge was bootstrapped from (cross-network
    # cold-start provenance); None for knowledge mined from own history
    origin: tuple[str, str] | None = None
    # device the knowledge was fit on; refits run their kernels there
    # (None: the CUDA card, see ``device.resolve_device``)
    device: torch.device | None = dataclasses.field(default=None,
                                                    compare=False)

    # ------------------------------------------------------------------ #
    def query(self, features: np.ndarray) -> ClusterKnowledge:
        """Nearest-cluster lookup — the online module's constant-time query."""
        k = self.cluster_model.assign(np.asarray(features, np.float64))
        return self.clusters[k]

    # ------------------------------------------------------------------ #
    def update(self, new_entries: list[LogEntry], *,
               batched_fit: bool = False,
               use_kernel: bool | None = None,
               assignments: list[int] | None = None) -> set[int]:
        """Additive refresh: only touched (cluster, bin) surfaces are refit.

        Each touched cluster is rebuilt into a *fresh* ``ClusterKnowledge``
        and published with a single list-slot swap, so concurrent readers —
        in-flight sessions and batched admission queries hold the old object
        — never observe a half-refit cluster (new surfaces with a stale
        region or ``SurfaceStack``).  The per-cluster region seed persists
        across refits, keeping a refit cluster's sampling region identical
        to a from-scratch fit of the same entries.  ``batched_fit`` routes
        the spline solves through one batched Thomas solve; ``use_kernel``
        (None: True on CUDA) runs it, and the routing of batches of 512 or
        more entries, through the hand-written kernels on the device the DB
        was fit on (``kernels.ops``).
        ``assignments`` are precomputed cluster indices for ``new_entries``
        (the refresher routes entries for staleness tracking anyway, so the
        nearest-centroid pass need not run twice).  Returns the refit
        cluster indices.
        """
        device = resolve_device(self.device)
        use_kernel = resolve_use_kernel(use_kernel, device)
        if assignments is None:
            if len(new_entries) >= 512:
                # million-entry refreshes route through the tiled
                # nearest-centroid kernel instead of a Python loop
                F = np.stack([e.features() for e in new_entries])
                assignments = self.cluster_model.assign_many(
                    F, use_kernel=use_kernel, device=device).tolist()
            else:
                assignments = [int(self.cluster_model.assign(e.features()))
                               for e in new_entries]
        touched = set()
        for e, k in zip(new_entries, assignments):
            self.clusters[k].entries.append(e)
            touched.add(int(k))
        # Refit in ascending cluster order: each refit is independent today,
        # but the publish order is observable (e.g. shared-kernel compile
        # caches, future incremental-refresh hooks), so it must not be left
        # to set hashing.
        for k in sorted(touched):
            ck = self.clusters[k]
            surfaces = _fit_cluster_surfaces(ck.entries, self.n_load_bins,
                                             self.bounds, batched=batched_fit,
                                             use_kernel=use_kernel,
                                             device=device)
            region = identify_sampling_regions(surfaces, self.bounds,
                                               seed=ck.region_seed)
            fresh = ClusterKnowledge(ck.centroid, surfaces, region,
                                     ck.entries, region_seed=ck.region_seed,
                                     device=device)
            if ck._stack is not None:
                # keep the batched admission view warm: build the new stack
                # for the cached bounds *before* publishing the swap
                fresh.surface_stack(ck._stack[0][0])
            self.clusters[k] = fresh
        return touched


def _fit_cluster_surfaces(entries: list[LogEntry], n_load_bins: int,
                          bounds: ParamBounds, *, batched: bool = False,
                          use_kernel: bool = False,
                          device=None) -> list[ThroughputSurface]:
    n_bins = max(1, min(n_load_bins, len(entries) // 24))
    if n_bins <= 1 or len(entries) < 16:
        jobs = [(entries, float(np.mean(
            [load_intensity(e) for e in entries])))]
        return _fit_jobs(jobs, bounds, batched, use_kernel, device)
    # load-agnostic base surface, used to explain away parameter effects
    base = _fit_jobs([(entries, 0.5)], bounds, batched, use_kernel, device)[0]
    bin_idx, centers = residual_intensity_bins(entries, n_bins, base.surface)
    jobs = []
    for b in range(n_bins):
        sel = [e for e, i in zip(entries, bin_idx) if i == b]
        if len(sel) < 8:
            continue
        jobs.append((sel, float(centers[b])))
    out = _fit_jobs(jobs, bounds, batched, use_kernel, device)
    if not out:  # degenerate cluster: single surface over everything
        out.append(base)
    return sorted(out, key=lambda s: s.load_intensity)


def _fit_jobs(jobs, bounds: ParamBounds, batched: bool, use_kernel: bool,
              device) -> list[ThroughputSurface]:
    """Fit one surface per (entries, load) job, scalar or batched-Thomas."""
    if batched and jobs:
        return fit_surfaces_batched(jobs, bounds, use_kernel=use_kernel,
                                    device=device)
    return [fit_surface(e, load, bounds) for e, load in jobs]


def offline_analysis(entries: list[LogEntry], *,
                     bounds: ParamBounds = ParamBounds(),
                     n_load_bins: int = 5,
                     clustering: str = "kmeans++",
                     seed: int = 0,
                     batched: bool | None = None,
                     use_kernel: bool | None = None,
                     device=None) -> OfflineDB:
    """Full offline phase over a historical log.

    ``batched=None`` lets ``fit_clusters`` auto-route k-means++ to the
    batched torch path above ``clustering.BATCHED_THRESHOLD`` rows, so
    million-entry logs never hit the O(n^2)/Python-loop numpy path.
    ``device`` (None: the CUDA card) is where the clustering sweeps run and
    where later refits of the returned DB run their kernels.
    """
    device = resolve_device(device)
    # repro-lint: disable=DET001 -- fit_seconds is wall-time observability
    # metadata (how long discovery took on this host); it never feeds a
    # tuning decision, a trace, or any simulated-time computation.
    t0 = time.perf_counter()
    X = np.stack([e.features() for e in entries])
    cm = fit_clusters(X, method=clustering, seed=seed, batched=batched,
                      use_kernel=use_kernel, device=device)
    clusters: list[ClusterKnowledge] = []
    for k in range(cm.m):
        sel = [e for e, l in zip(entries, cm.labels) if l == k]
        if not sel:
            sel = entries[:8]
        surfaces = _fit_cluster_surfaces(sel, n_load_bins, bounds)
        region = identify_sampling_regions(surfaces, bounds, seed=seed + k)
        clusters.append(ClusterKnowledge(cm.centroids[k], surfaces, region,
                                         sel, region_seed=seed + k,
                                         device=device))
    return OfflineDB(clusters, cm, bounds, n_load_bins,
                     # repro-lint: disable=DET001 -- fit_seconds metadata (see t0)
                     time.perf_counter() - t0, device=device)


# --------------------------------------------------------------------- #
# multi-network knowledge: per-endpoint-pair stores + cold-start transfer
# --------------------------------------------------------------------- #
def _bootstrap_clone(donor: OfflineDB, origin: tuple[str, str],
                     features: np.ndarray) -> OfflineDB:
    """Independent knowledge for a new network, transferred from a donor.

    The donor's surfaces are re-anchored at the target link: throughput is
    rescaled by the capacity ratio ``10**(bw_target - bw_donor)`` read off
    the log-bandwidth feature (the parameter *response shape* — which
    (cc, p, pp) help and by how much, relative to capacity — is what
    transfers across networks; absolute rates do not), and the cluster
    centroids' link coordinates move to the target's so future routing and
    similarity ranking see the network where it actually lives.  The entry
    stores start *empty*: donor observations describe another network's
    throughput axis, so the first additive refits specialize each touched
    cluster from the new network's own logs alone, while the scaled donor
    surfaces serve as the prior until then.  The donor itself is never
    mutated.
    """
    F = np.atleast_2d(np.asarray(features, np.float64))
    bw_t, rtt_t = float(np.median(F[:, 0])), float(np.median(F[:, 1]))
    clusters = []
    for ck in donor.clusters:
        s = float(10.0 ** np.clip(bw_t - ck.centroid[0], -3.0, 3.0))
        cen = ck.centroid.copy()
        cen[0], cen[1] = bw_t, rtt_t
        clusters.append(ClusterKnowledge(
            cen, [scale_surface(ts, s) for ts in ck.surfaces], ck.region,
            [], region_seed=ck.region_seed, device=donor.device))
    cm = donor.cluster_model
    cents = cm.centroids.copy()
    cents[:, 0], cents[:, 1] = bw_t, rtt_t
    # Clone counts start at 1 per centroid, not the donor's: the donor's
    # point mass describes another network, and streaming partial_fit on
    # the clone should let the new network's own observations dominate the
    # Sculley learning rate from the first mini-batch.
    model = ClusterModel(cm.labels.copy(), cents, cm.m, cm.method, cm.ch,
                         counts=np.ones(cm.m, np.float64))
    return OfflineDB(clusters, model, donor.bounds, donor.n_load_bins,
                     0.0, origin=origin, device=donor.device)


@dataclasses.dataclass
class MultiNetworkDB:
    """Per-testbed offline knowledge keyed by endpoint pair (Sec. 3.1's
    "network and data agnostic" claim, made operational).

    Each (src, dst) endpoint pair gets its own ``OfflineDB`` mined from its
    own history.  A pair with *no* history cold-starts from the closest
    known network — smallest mean distance from the requester's feature
    vectors to the candidate store's cluster centroids over
    ``LogEntry.features()`` space — and then specializes via the ordinary
    additive refresh loop (``KnowledgeRefresher`` / ``OfflineDB.update``).
    """
    bounds: ParamBounds = dataclasses.field(default_factory=ParamBounds)
    n_load_bins: int = 5
    clustering: str = "kmeans++"
    seed: int = 0
    batched: bool | None = None
    use_kernel: bool | None = None
    device: str | torch.device | None = None
    dbs: dict[tuple[str, str], OfflineDB] = dataclasses.field(
        default_factory=dict)

    # ------------------------------------------------------------------ #
    def fit(self, entries: list[LogEntry]) -> "MultiNetworkDB":
        """Mine one OfflineDB per endpoint pair present in the log."""
        groups: dict[tuple[str, str], list[LogEntry]] = {}
        for e in entries:
            groups.setdefault((e.src, e.dst), []).append(e)
        for i, (pair, sel) in enumerate(sorted(groups.items())):
            self.dbs[pair] = offline_analysis(
                sel, bounds=self.bounds, n_load_bins=self.n_load_bins,
                clustering=self.clustering, seed=self.seed + 31 * i,
                batched=self.batched, use_kernel=self.use_kernel,
                device=self.device)
        return self

    def networks(self) -> list[tuple[str, str]]:
        return sorted(self.dbs)

    def get(self, src: str, dst: str) -> OfflineDB | None:
        return self.dbs.get((src, dst))

    # ------------------------------------------------------------------ #
    def rank_networks(self, features: np.ndarray
                      ) -> list[tuple[tuple[str, str], float]]:
        """Known networks sorted by centroid distance to ``features``.

        ``features`` is one or more ``LogEntry.features()`` vectors; each
        network's score is the mean (over the query vectors) distance to
        its nearest cluster centroid.  Ties break on the pair key so the
        ranking is deterministic.  Cold-started clones (``origin`` set) are
        excluded while any history-mined store exists: a clone's re-anchored
        centroids sit right on its own link's coordinates without a single
        underlying observation, so letting it outrank the real testbed
        stores would chain second-hand knowledge donor-to-donor.
        """
        F = np.atleast_2d(np.asarray(features, np.float64))
        mined = [p for p in self.networks() if self.dbs[p].origin is None]
        if not (mined or self.dbs):
            raise ValueError("no known networks: fit() some history first")
        out = []
        for pair in mined or self.networks():
            C = self.dbs[pair].cluster_model.centroids
            d = np.sqrt(((F[:, None, :] - C[None]) ** 2).sum(-1))  # (q, m)
            out.append((pair, float(d.min(axis=1).mean())))
        return sorted(out, key=lambda t: (t[1], t[0]))

    def closest_network(self, features: np.ndarray) -> tuple[str, str]:
        return self.rank_networks(features)[0][0]

    # ------------------------------------------------------------------ #
    def bootstrap(self, src: str, dst: str, features: np.ndarray, *,
                  donor: tuple[str, str] | None = None,
                  register: bool = True) -> OfflineDB:
        """Cold-start knowledge for an endpoint pair with no history.

        ``donor=None`` picks the closest known network for ``features``;
        the clone records its provenance in ``OfflineDB.origin`` and, when
        ``register`` is set, becomes the pair's live store (specializing it
        via refresh never touches the donor).
        """
        if donor is None:
            donor = self.closest_network(features)
        db = _bootstrap_clone(self.dbs[donor], donor, features)
        if register:
            self.dbs[(src, dst)] = db
        return db

    def query(self, src: str, dst: str,
              features: np.ndarray) -> ClusterKnowledge:
        """Nearest-cluster lookup, cold-starting unseen endpoint pairs."""
        db = self.dbs.get((src, dst))
        if db is None:
            db = self.bootstrap(src, dst, features)
        return db.query(np.atleast_2d(features)[0])
