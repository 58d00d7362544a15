"""Shard-side plumbing of the sharded fleet engine.

Three support structures, kept out of ``engine/sharded.py`` so the engine
module stays a pure consumer of the shared aggregation funnel (the parity
rules treat engine modules specially):

* :class:`ShardedEventFrontier` — K per-shard :class:`VectorEventHeap`\\ s
  presenting the single-heap push/pop contract, with the fleet-slot
  partition rule imported from ``repro_torch.dist.sharding``;
* :class:`WindowedLinkState` — the bulk-synchronous window view over an
  :class:`~repro_torch.netsim.environment.IndexedSharedLink`, exchanging buffered
  running-sum registrations at window boundaries;
* :class:`WindowTenantEnvironment` — a tenant environment whose external
  load read is cached per window, invalidated through a shared
  :class:`WindowEpoch` cell.
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.engine.heap import VectorEventHeap
from repro_torch.dist.sharding import slot_shard
from repro_torch.netsim.environment import IndexedSharedLink, TenantEnvironment

#: Exclude-id that matches no tenant (slots are non-negative) — used to
#: freeze the *full* window-start aggregate, nobody subtracted.
_NO_TENANT = -1


class ShardedEventFrontier:
    """K per-shard event heaps behind the single-heap contract.

    Slots are partitioned cyclically (``repro_torch.dist.sharding.slot_shard``),
    and ``peek``/``pop`` take the minimum over the K shard roots under the
    same ``(time_s, slot_id)`` tuple comparison the heaps use internally.
    The merged pop sequence is therefore *bit-identical* to one global
    :class:`VectorEventHeap` over the union: the global minimum always sits
    at some shard's root, and equal-time ties still resolve by ascending
    slot id because slot ids are unique and part of the key.
    """

    def __init__(self, n_shards: int, capacity: int = 1024):
        if n_shards < 1:
            raise ValueError(f"n_shards must be >= 1, got {n_shards}")
        self.n_shards = int(n_shards)
        per_shard = max(capacity // self.n_shards, 16)
        self.shards = [
            VectorEventHeap(capacity=per_shard) for _ in range(self.n_shards)
        ]

    def __len__(self) -> int:
        return sum(len(h) for h in self.shards)

    # ------------------------------------------------------------------ #
    def push(self, time_s: float, slot_id: int) -> None:
        self.shards[slot_shard(slot_id, self.n_shards)].push(time_s, slot_id)

    def push_batch(self, times_s, slot_ids) -> None:
        """Route one event batch to its owning shards (vectorized)."""
        times_s = np.asarray(times_s, np.float64)
        slot_ids = np.asarray(slot_ids, np.int64)
        if times_s.shape != slot_ids.shape or times_s.ndim != 1:
            raise ValueError("times_s and slot_ids must be equal-length 1-D")
        if times_s.shape[0] == 0:
            return
        owners = slot_ids % self.n_shards  # slot_shard, vectorized
        for s in range(self.n_shards):
            mask = owners == s
            if mask.any():
                self.shards[s].push_batch(times_s[mask], slot_ids[mask])

    def _best_shard(self) -> int:
        best = -1
        key: tuple[float, int] | None = None
        for s, heap in enumerate(self.shards):
            if len(heap):
                k = heap.peek()
                if key is None or k < key:
                    best, key = s, k
        if best < 0:
            raise IndexError("empty ShardedEventFrontier")
        return best

    def peek(self) -> tuple[float, int]:
        return self.shards[self._best_shard()].peek()

    def pop(self) -> tuple[float, int]:
        return self.shards[self._best_shard()].pop()


class WindowEpoch:
    """Shared monotone counter: the engine bumps it once per window so every
    per-tenant cached read (external load) invalidates in lockstep."""

    __slots__ = ("epoch",)

    def __init__(self) -> None:
        self.epoch = 0

    def advance(self) -> None:
        self.epoch += 1


class WindowedLinkState:
    """Bulk-synchronous window view over an :class:`IndexedSharedLink`.

    The strict engines re-resolve contention at every chunk start; the
    windowed scale regime coarsens that by one level — the same
    quasi-static discipline ``SharedLink`` documents per chunk, applied per
    window:

    * :meth:`begin_window` replays the registrations buffered during the
      previous window into the inner index *in buffer order* (the
      running-sum state exchange at the merge point), then freezes the
      ``(aggregate, count)`` snapshot at the window start;
    * :meth:`snapshot` answers from the frozen aggregate, minus the asking
      tenant's own still-registered flow (``live_flow``), so
      self-exclusion stays exact — post-expiry at the window start, a flow
      is in the inner index if and only if it is in the frozen aggregate;
    * :meth:`register` only buffers: a flow started mid-window becomes
      visible to *other* tenants at the next window boundary (its owner
      never sees it anyway).  Re-registrations within one window overwrite
      in place — only a tenant's *last* interval survives to the boundary,
      which is exactly the state a full replay would leave in the index,
      minus the churn.

    Deterministic by construction: the buffer order is the engine's
    deterministic per-shard burst order.  ``release`` is accepted for
    drop-in compatibility but the engine never calls it mid-window; a
    release only leaves the frozen aggregate at the next boundary.
    """

    def __init__(self, inner: IndexedSharedLink):
        self.inner = inner
        self.link = inner.link
        self._pending: dict[int, tuple[float, float]] = {}
        self._agg = 0.0
        self._count = 0

    def begin_window(self, t0_s: float) -> None:
        for tenant_id, (rate, end) in self._pending.items():
            self.inner.register(tenant_id, rate, end)
        self._pending.clear()
        self._agg, self._count = self.inner.snapshot(t0_s, _NO_TENANT)

    def snapshot(self, now_s: float, exclude: int) -> tuple[float, int]:
        own = self.inner.live_flow(exclude)
        if own is not None:
            return float(self._agg - own[0]), self._count - 1
        return float(self._agg), self._count

    def register(self, tenant_id: int, rate_mbps: float, end_s: float) -> None:
        self._pending[tenant_id] = (float(rate_mbps), float(end_s))

    def release(self, tenant_id: int) -> None:
        self._pending.pop(tenant_id, None)
        self.inner.release(tenant_id)


class WindowTenantEnvironment(TenantEnvironment):
    """Tenant environment with a per-window cache of the external load.

    ``Environment.current_load`` pays a traffic-model evaluation — for
    ``DiurnalTraffic`` including an RNG jitter step — on every chunk.
    Within one bulk-synchronous window the windowed regime treats external
    load as frozen, exactly like the contention aggregate: exact for
    constant-load requests, bounded-stale by one window otherwise.
    """

    def __init__(self, *args, epoch: WindowEpoch, **kwargs):
        super().__init__(*args, **kwargs)
        self._epoch = epoch
        self._load_epoch = -1
        self._load = 0.0
        self._mt_key: tuple | None = None
        self._mt_val = 0.0
        self._cont_epoch = -1
        self._cont = (0.0, 0)

    def _contention(self) -> tuple[float, int]:
        # The frozen aggregate and the inner index are both immutable
        # within a window (mid-window registrations only buffer), so a
        # tenant's contention view is constant until the next boundary.
        if self._epoch.epoch != self._cont_epoch:
            self._cont = self.shared.snapshot(self.clock_s, self.tenant_id)
            self._cont_epoch = self._epoch.epoch
        return self._cont

    def current_load(self) -> float:
        if self._epoch.epoch != self._load_epoch:
            self._load = super().current_load()
            self._load_epoch = self._epoch.epoch
        return self._load

    def mean_throughput(self, params, avg_file_mb, n_files, ext_load,
                        contending_mbps=0.0, n_contending=0,
                        link=None) -> float:
        # Load, contention, and active count are all frozen within a
        # window, so a session re-transferring with unchanged parameters
        # (the common bulk-chunk burst) resolves to the same mean — cache
        # it per window.  The fault path overrides ``link`` per segment
        # and bypasses the cache.
        if link is not None:
            return super().mean_throughput(
                params, avg_file_mb, n_files, ext_load,
                contending_mbps, n_contending, link)
        key = (self._epoch.epoch, params.cc, params.p, params.pp,
               avg_file_mb, n_files, ext_load, contending_mbps, n_contending)
        if key == self._mt_key:
            return self._mt_val
        val = super().mean_throughput(
            params, avg_file_mb, n_files, ext_load,
            contending_mbps, n_contending)
        self._mt_key, self._mt_val = key, val
        return val
