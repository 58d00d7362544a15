"""Device-sharded fleet engine: per-shard frontiers, two execution regimes.

:class:`ShardedFleetEngine` partitions fleet slots cyclically across
``n_shards`` shards (``repro_torch.dist.sharding.slot_shard``; the default shard
count is the host's device count) and runs in one of two regimes:

* **strict** — the parity regime, and the default at parity scale.  The
  engine is the vectorized event loop verbatim with the single global heap
  replaced by a :class:`~repro_torch.core.engine.shard.ShardedEventFrontier`:
  per-shard heaps merged at the root under the exact ``(time, slot)`` tie
  rule.  Because the global minimum always sits at some shard root, the
  merged pop sequence — and with it every RNG stream, the canonical trace,
  and the ``FleetReport`` — is *bit-identical* to
  ``VectorizedFleetEngine`` (``tests/test_torch_scenarios.py`` locks this
  in across the scenario matrix).

* **windowed** — the scale regime, selected automatically above
  ``AUTO_CONTENTION_CUTOVER`` (or forced via
  ``EngineConfig.shard_window_s``).  Zero-lookahead coupling through the
  shared link makes bit-identical parallel execution impossible — every
  chunk's rate depends on every concurrent registration — so above parity
  scale the engine relaxes to bulk-synchronous windows of width
  ``shard_window_s``: each shard drains its own frontier through the
  window as an uninterrupted burst per session (intra-window events never
  touch the heap), contention and external load are frozen at the window
  start (``WindowedLinkState`` / ``WindowTenantEnvironment``), buffered
  flow registrations fold into the ``IndexedSharedLink`` running sum at
  the merge point, and finish bookkeeping (knowledge fold-in, recovery
  re-admission, admission of queued requests) runs at the window barrier
  in global ``(clock, slot)`` order.  Still fully deterministic — same
  config, same report — but one coarsening level beyond the per-chunk
  quasi-static discipline the strict link already documents, which is what
  buys the multi-shard sessions/s scaling (``benchmarks/fleet_shard.py``).

Both regimes funnel their report through the shared
``assemble_fleet_report`` and batch admission routing through
``ClusterModel.assign_many`` (default float64 path — arithmetic-identical
to per-request ``assign``; the float32 kernel path would break routing
parity) whenever the knowledge base is frozen for the run.
"""

from __future__ import annotations

import collections
import dataclasses

import numpy as np
import torch

from repro_torch.core.engine.shard import (
    ShardedEventFrontier,
    WindowedLinkState,
    WindowEpoch,
    WindowTenantEnvironment,
)
from repro_torch.core.engine.vectorized import (
    AUTO_CONTENTION_CUTOVER,
    PHASE_FINISH,
    PHASE_IDLE,
    FleetStateArrays,
    VectorizedFleetEngine,
    _ActiveCounter,
)
from repro_torch.core.fleet import (
    FleetReport,
    FleetRequest,
    ReprobeLimiter,
    assemble_fleet_report,
    auto_concurrency,
)
from repro_torch.core.online import AdaptiveSampler, request_features
from repro_torch.core.refresh import KnowledgeRefresher
from repro_torch.netsim.environment import IndexedSharedLink
from repro_torch.netsim.testbeds import TESTBEDS, make_traffic

#: Window width of the auto-selected windowed regime.  Wide enough that a
#: typical bulk chunk completes inside one window (so sessions burst through
#: several interactions per merge), narrow against the diurnal period (3 h)
#: so frozen load/contention stay representative.
DEFAULT_SHARD_WINDOW_S = 120.0


class _FrozenActiveCount:
    """``n_active_fn`` for the windowed regime.

    The strict engines hand the re-probe limiter the exact active count at
    each gate event; the windowed regime freezes it at the window start —
    the same one-level coarsening as the contention aggregate, and equally
    deterministic.
    """

    def __init__(self, counter: _ActiveCounter):
        self._counter = counter
        self._value = 0

    def freeze(self, t0_s: float) -> None:
        self._value = self._counter(t0_s)

    def __call__(self, now_s: float) -> int:
        return self._value


class ShardedFleetEngine(VectorizedFleetEngine):
    """Run N concurrent sessions over ``n_shards`` per-shard event frontiers.

    ``config`` is an ``EngineConfig`` with ``engine="sharded"``;
    ``n_shards=None`` resolves to the host's device count and
    ``shard_window_s=None`` picks the regime automatically (strict at
    parity scale, windowed above the contention cutover).
    """

    def __init__(self, db, config):
        super().__init__(db, config)
        self.n_shards = self._resolve_n_shards(config)
        self.windows_run = 0
        self._cluster_idx: np.ndarray | None = None

    # ------------------------------------------------------------------ #
    @staticmethod
    def _resolve_n_shards(config) -> int:
        n = getattr(config, "n_shards", None)
        if n is not None:
            return int(n)
        return max(torch.cuda.device_count(), 1)

    def _make_heap(self, n: int):
        if self.n_shards == 1:
            return super()._make_heap(n)
        return ShardedEventFrontier(self.n_shards, capacity=max(2 * n, 16))

    def _query_cluster(self, i: int, link, dataset):
        idx = self._cluster_idx
        if idx is not None and i < idx.shape[0]:
            return self.db.clusters[int(idx[i])]
        return super()._query_cluster(i, link, dataset)

    def _precompute_admissions(self, requests: list[FleetRequest]) -> None:
        """Batch the initial wave's cluster routing through ``assign_many``.

        Only when the knowledge base is frozen for the run (no refresher,
        no knowledge service) — a mid-run ``OfflineDB.update`` would
        invalidate precomputed indices.  Always the default chunked float64
        path, which is arithmetic-identical to per-request ``assign``
        regardless of ``use_kernel`` (the kernel path is float32 and would
        break routing parity).  Recovery re-admissions occupy slots beyond
        the initial wave and fall back to scalar ``db.query``.
        """
        cfg = self.config
        self._cluster_idx = None
        if cfg.refresh is not None or getattr(cfg, "knowledge", None) is not None:
            return
        model = getattr(self.db, "cluster_model", None)
        if model is None or not requests:
            return
        link = TESTBEDS[cfg.testbed]
        feats = np.stack(
            [
                np.asarray(request_features(link, r.dataset), np.float64)
                for r in requests
            ]
        )
        self._cluster_idx = np.asarray(model.assign_many(feats), np.int64)

    def _window_s(self, n: int) -> float | None:
        """Window width for this run, or ``None`` for the strict regime."""
        if self.n_shards <= 1:
            return None  # nothing to reconcile across shards
        w = getattr(self.config, "shard_window_s", None)
        if w is None:
            return DEFAULT_SHARD_WINDOW_S if n > AUTO_CONTENTION_CUTOVER else None
        if w <= 0.0:
            return None  # 0 forces strict at any scale
        return float(w)

    # ------------------------------------------------------------------ #
    def run(self, requests: list[FleetRequest]) -> FleetReport:
        self._precompute_admissions(requests)
        window = self._window_s(len(requests))
        if window is None:
            return super().run(requests)
        return self._run_windowed(requests, window)

    # ------------------------------------------------------------------ #
    def _run_windowed(
        self, requests: list[FleetRequest], window: float
    ) -> FleetReport:
        """The bulk-synchronous scale regime (see the module docstring).

        Structurally the vectorized ``run`` with the event loop replaced by
        window rounds: burst per-shard until the window end, then a barrier
        that exchanges link state and processes finishes in global order.
        """
        cfg = self.config
        n = len(requests)
        if n == 0:
            return FleetReport([], 0.0, 0.0, 0.0, 0.0, 0.0, 0, 0, 0)
        link = TESTBEDS[cfg.testbed]
        shared = WindowedLinkState(IndexedSharedLink(link))
        epoch = WindowEpoch()
        counter = _ActiveCounter()
        frozen_active = _FrozenActiveCount(counter)
        limiter = ReprobeLimiter(cfg.reprobe_interval_s, n_active_fn=frozen_active)
        knowledge = getattr(cfg, "knowledge", None)
        if knowledge is not None and knowledge.db_for(None) is not self.db:
            raise ValueError(
                "knowledge service must serve the same OfflineDB the "
                "engine runs against"
            )
        refresher = (
            KnowledgeRefresher(self.db, link, cfg.refresh)
            if cfg.refresh is not None and knowledge is None
            else None
        )
        k_stats0 = knowledge.stats() if knowledge is not None else None
        cap = cfg.max_concurrent or auto_concurrency(
            self.db,
            requests,
            link,
            testbed=cfg.testbed,
            overcommit=cfg.overcommit,
            use_kernel=cfg.use_kernel,
        )
        recovery = cfg.recovery

        reqs: list[FleetRequest] = list(requests)
        origin = list(range(n))
        attempt_no = [0] * n
        reports = [None] * n
        end_clock = [0.0] * n
        admit_time = [0.0] * n
        gens: list = [None] * n
        envs: list = [None] * n
        state = FleetStateArrays.allocate(n)
        self.state = state
        frontier = ShardedEventFrontier(self.n_shards, capacity=max(2 * n, 16))
        pending = collections.deque(
            sorted(range(n), key=lambda i: (reqs[i].start_clock_s, i))
        )
        n_kills = 0
        n_recoveries = 0
        # Constant-load traffic carries no per-tenant state worth isolating
        # (its load never varies), so one shared instance per load level
        # serves the whole fleet — at scale that is one object instead of N.
        const_traffic: dict[float, object] = {}

        def admit_next(now_s: float) -> None:
            if not pending:
                return
            i = pending.popleft()
            admit_time[i] = max(reqs[i].start_clock_s, now_s)
            state.admit_s[i] = admit_time[i]
            if knowledge is not None:
                feats = request_features(link, reqs[i].dataset)
                cluster = knowledge.query_cluster(None, feats)
                budget = knowledge.probe_budget(
                    None, admit_time[i], cfg.max_samples
                )
            else:
                cluster = self._query_cluster(i, link, reqs[i].dataset)
                budget = cfg.max_samples
            if reqs[i].traffic is not None:
                traffic = reqs[i].traffic
            elif reqs[i].constant_load is not None:
                load = float(reqs[i].constant_load)
                traffic = const_traffic.get(load)
                if traffic is None:
                    traffic = make_traffic(cfg.testbed, constant_load=load)
                    const_traffic[load] = traffic
            else:
                traffic = make_traffic(cfg.testbed, seed=reqs[i].env_seed)
            env = WindowTenantEnvironment(
                link,
                traffic,
                shared,
                i,
                seed=reqs[i].env_seed,
                turn_gate=None,
                faults=cfg.faults,
                epoch=epoch,
            )
            env.clock_s = admit_time[i]
            envs[i] = env
            counter.admit(admit_time[i])
            sampler = AdaptiveSampler(
                self.db,
                z=cfg.z,
                max_samples=budget,
                bulk_chunks=cfg.bulk_chunks,
                reprobe_gate=limiter,
                recovery=recovery,
            )
            gens[i] = sampler.session(env, reqs[i].dataset, cluster)
            self._advance(i, gens, envs, reports, state, frontier)

        def enqueue_recovery(i: int, now_s: float) -> None:
            nonlocal n_kills, n_recoveries
            rep = reports[i]
            if rep is None or not rep.interrupted:
                return
            n_kills += 1
            if (
                recovery is None
                or attempt_no[i] >= recovery.max_restarts
                or rep.moved_mb >= reqs[i].dataset.total_mb - 1e-9
            ):
                return
            n_recoveries += 1
            nxt = dataclasses.replace(
                reqs[i],
                dataset=reqs[i].dataset.residual(rep.moved_mb),
                start_clock_s=now_s + recovery.restart_delay_s,
                env_seed=reqs[i].env_seed + 101,
            )
            j = len(reqs)
            reqs.append(nxt)
            origin.append(origin[i])
            attempt_no.append(attempt_no[i] + 1)
            reports.append(None)
            end_clock.append(0.0)
            admit_time.append(0.0)
            gens.append(None)
            envs.append(None)
            state.grow_to(len(reqs))
            pending.append(j)

        for _ in range(min(cap, n)):
            admit_next(float("-inf"))

        # ---------------- the window loop ---------------- #
        while len(frontier):
            t0 = frontier.peek()[0]
            w_end = t0 + window
            self.windows_run += 1
            epoch.advance()  # invalidate every per-tenant load cache
            shared.begin_window(t0)  # fold buffered flows, freeze aggregate
            frozen_active.freeze(t0)
            finished: list[tuple[float, int]] = []
            for shard in frontier.shards:
                while len(shard) and shard.peek()[0] < w_end:
                    _, i = shard.pop()
                    if state.phase[i] == PHASE_FINISH:
                        finished.append((float(state.next_event_s[i]), i))
                        continue
                    self._burst(
                        i, w_end, gens, envs, reports, state, shard, finished
                    )
            # Window barrier: finish bookkeeping in global (clock, slot)
            # order — the same per-finish sequence as the strict loop.
            for now, i in sorted(finished):
                self.events_processed += 1
                end_clock[i] = now
                state.end_s[i] = now
                rep = reports[i]
                if knowledge is not None and rep is not None:
                    knowledge.observe(
                        rep, reqs[i].dataset, link=link, now_s=now
                    )
                elif (
                    refresher is not None
                    and rep is not None
                    and not rep.interrupted
                ):
                    refresher.observe(rep, reqs[i].dataset, now_s=now)
                enqueue_recovery(i, now)
                admit_next(now)
                counter.finish(now)
                state.phase[i] = PHASE_IDLE
                gens[i] = None
                envs[i] = None

        return assemble_fleet_report(
            self.db,
            cfg.testbed,
            requests,
            reqs=reqs,
            origin=origin,
            attempt_no=attempt_no,
            reports=reports,
            end_clock=end_clock,
            admit_time=admit_time,
            score_vs_single=cfg.score_vs_single,
            reprobe_grants=limiter.grants,
            reprobe_denials=limiter.denials,
            admitted_concurrency=min(cap, n),
            refreshes=(
                knowledge.stats().refits - k_stats0.refits
                if knowledge is not None
                else (refresher.refreshes if refresher is not None else 0)
            ),
            refreshed_entries=(
                knowledge.stats().entries_folded - k_stats0.entries_folded
                if knowledge is not None
                else (refresher.entries_folded if refresher is not None else 0)
            ),
            kills=n_kills,
            recoveries=n_recoveries,
        )

    # ------------------------------------------------------------------ #
    def _burst(self, i, w_end, gens, envs, reports, state, shard, finished):
        """Resume slot ``i`` through every interaction before ``w_end``.

        Intra-window events are absorbed without heap traffic: only the
        first yield at or beyond the window end goes back on the shard heap
        (or, if the session returns first, its finish record into the
        window's merge buffer).  Per-slot state arrays are written at the
        burst boundary only — mid-burst phases are never observable at a
        barrier, so ``live_histogram`` stays consistent where it is read.
        """
        gen = gens[i]
        while True:
            try:
                t, phase, prm = next(gen)
            except StopIteration as stop:
                reports[i] = stop.value
                state.phase[i] = PHASE_FINISH
                t_fin = envs[i].clock_s
                state.next_event_s[i] = t_fin
                if t_fin < w_end:
                    finished.append((t_fin, i))
                else:
                    shard.push(t_fin, i)
                return
            self.events_processed += 1
            if t >= w_end:
                state.phase[i] = phase
                state.params[i] = prm.as_tuple()
                state.next_event_s[i] = t
                shard.push(t, i)
                return
