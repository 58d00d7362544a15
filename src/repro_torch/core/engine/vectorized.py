"""Event-driven vectorized fleet engine (the ROADMAP's million-session item).

The threaded ``FleetScheduler`` is correct and deterministic but structurally
capped: one Python thread per session, each interaction serialized through a
condition-variable handshake.  This engine keeps the *logical* schedule —
interactions execute in ascending ``(simulated clock, tenant id)`` order, the
same conservative discrete-event discipline as ``_FleetClock`` — but replaces
the threads with a single event loop over suspended session generators:

* every session is an ``AdaptiveSampler.session`` generator that yields
  ``(clock_s, phase, params)`` immediately before each environment
  interaction (probe transfer, bulk chunk, re-probe-gate consultation);
* per-session scheduling state is stacked in flat numpy arrays
  (:class:`FleetStateArrays`: phase, last-yielded params, next-event time,
  admit/end clocks);
* the next interaction fleet-wide is popped from a
  :class:`~repro_torch.core.engine.heap.VectorEventHeap` keyed ``(clock, slot)``
  with the clock's exact tie rule, and exactly one generator is resumed per
  event.

Because both engines execute the same per-session code (the generator) under
the same global interleaving (same keys, same tie-break), with the same RNG
streams, the same admission/recovery/refresh bookkeeping at the same
simulated instants, and a report assembled by the shared
``assemble_fleet_report``, the ``FleetReport`` is *bit-identical* to the
threaded oracle — ``tests/test_torch_scenarios.py`` locks this in across
the scenario matrix.  What changes is capacity: no thread stacks, no handshakes,
O(log N) scheduling, and (above the parity regime) O(log N) contention
bookkeeping via ``IndexedSharedLink``, which is what takes fleets from
hundreds of sessions to 1e5+ (``benchmarks/fleet_scale.py``).

The batched-kernel path is unchanged: admission demand prediction still goes
through ``SurfaceStack.best_candidates`` (the CUDA ``transfer_select``
kernel on the card) via the shared module-level ``predict_demands``.
"""

from __future__ import annotations

import collections
import dataclasses
import heapq

import numpy as np

from repro_torch.core.fleet import (
    FleetReport,
    FleetRequest,
    ReprobeLimiter,
    assemble_fleet_report,
    auto_concurrency,
)
from repro_torch.core.offline import OfflineDB
from repro_torch.core.online import (
    AdaptiveSampler,
    TransferReport,
    request_features,
)
from repro_torch.core.refresh import KnowledgeRefresher
from repro_torch.core.engine.heap import VectorEventHeap
from repro_torch.netsim.environment import (
    IndexedSharedLink,
    SharedLink,
    TenantEnvironment,
)
from repro_torch.netsim.testbeds import TESTBEDS, make_testbed

# Slot phases: 1-3 mirror the ``AdaptiveSampler.session`` yield tags
# (PHASE_PROBE / PHASE_BULK / PHASE_GATE); the engine adds the two
# scheduling-only states.
PHASE_IDLE = 0  # not admitted yet, or fully retired
PHASE_FINISH = 4  # session returned; finish bookkeeping event is queued

#: Above this fleet size ``contention="auto"`` switches from the exact
#: ``SharedLink`` (bit-identical to the threaded oracle, O(N) per snapshot)
#: to ``IndexedSharedLink`` (numerically equal, O(log N)).  Parity tests run
#: far below this line, so "auto" is both oracle-exact where it is checked
#: and scalable where it matters.
AUTO_CONTENTION_CUTOVER = 1024


@dataclasses.dataclass
class FleetStateArrays:
    """Per-slot session state stacked as flat numpy arrays.

    One row per admitted attempt slot: the yield tag the session is paused
    on (``phase``), the parameters it is about to use (``params``), when its
    next interaction fires (``next_event_s``), and its admit/end clocks.
    ``phase`` drives event dispatch in the engine loop; the rest make fleet
    state O(1)-inspectable mid-run (``live_histogram``) instead of buried in
    N generator frames.
    """

    phase: np.ndarray  # int8 — PHASE_IDLE/PROBE/BULK/GATE/FINISH
    params: np.ndarray  # int32 (n, 3) — last yielded (cc, p, pp)
    next_event_s: np.ndarray  # float64 — heap key of the pending event
    admit_s: np.ndarray  # float64
    end_s: np.ndarray  # float64

    @classmethod
    def allocate(cls, n: int) -> "FleetStateArrays":
        n = max(n, 1)
        return cls(
            phase=np.zeros(n, np.int8),
            params=np.zeros((n, 3), np.int32),
            next_event_s=np.full(n, np.inf, np.float64),
            admit_s=np.zeros(n, np.float64),
            end_s=np.zeros(n, np.float64),
        )

    def grow_to(self, n: int) -> None:
        cap = self.phase.shape[0]
        if n <= cap:
            return
        while cap < n:
            cap *= 2
        for name in ("phase", "params", "next_event_s", "admit_s", "end_s"):
            old = getattr(self, name)
            shape = (cap,) + old.shape[1:]
            fill = np.inf if name == "next_event_s" else 0
            new = np.full(shape, fill, old.dtype)
            new[: old.shape[0]] = old
            setattr(self, name, new)

    def live_histogram(self, n_slots: int) -> dict[int, int]:
        """``{phase: count}`` over the first ``n_slots`` slots."""
        tags, counts = np.unique(self.phase[:n_slots], return_counts=True)
        return {int(t): int(c) for t, c in zip(tags, counts)}


class _ActiveCounter:
    """Exact incremental replacement for ``_FleetClock.n_active_at``.

    The threaded clock answers "how many tenants are live at ``t``" by
    scanning every tenant; at 1e5+ sessions the limiter would turn that into
    the quadratic hot path.  This counter maintains the same quantity
    incrementally: +1 when a tenant's admit time is reached, -1 when its
    finish event is processed.  Queries arrive in event order — the engine
    serializes interactions by ascending ``(clock, slot)`` exactly like the
    threaded turn discipline — so time is monotone and a tenant's activation
    can be drained lazily from a min-heap of future admit times.  A finished
    tenant stops counting from its finish *event* onward, which is precisely
    when ``_FleetClock.finish`` flips ``done`` in the threaded engine (both
    engines order that event by the same ``(end_clock, slot)`` key).
    """

    def __init__(self):
        self._active = 0
        self._future: list[float] = []  # min-heap of pending admit times

    def admit(self, admit_s: float) -> None:
        heapq.heappush(self._future, admit_s)

    def finish(self, now_s: float) -> None:
        self(now_s)  # the finishing tenant's own +1 lands before the -1
        self._active -= 1

    def __call__(self, now_s: float) -> int:
        while self._future and self._future[0] <= now_s:
            heapq.heappop(self._future)
            self._active += 1
        return self._active


class VectorizedFleetEngine:
    """Run N concurrent sessions as one event loop, oracle-parity guaranteed.

    ``config`` is an ``EngineConfig`` (see ``repro_torch.core.engine.api``); the
    engine reads its fleet knobs (testbed, admission, limiter, refresh,
    faults, recovery, sampler parameters) and the ``contention`` selector.
    """

    def __init__(self, db: OfflineDB, config):
        self.db = db
        self.config = config
        self.events_processed = 0
        self.state: FleetStateArrays | None = None

    # ------------------------------------------------------------------ #
    def _make_heap(self, n: int) -> VectorEventHeap:
        """Event frontier for an N-slot fleet; the sharded engine overrides
        this with a per-shard frontier merge (same push/pop contract, same
        global ``(time, slot)`` order)."""
        return VectorEventHeap(capacity=max(2 * n, 16))

    def _query_cluster(self, i: int, link, dataset):
        """Admission-time cluster snapshot for slot ``i`` on the raw-DB path
        (no knowledge service).  The sharded engine overrides this with a
        batch-precomputed assignment when the DB is frozen for the run —
        which is why feature extraction happens inside the hook."""
        return self.db.query(request_features(link, dataset))

    def _make_shared(self, link, n: int):
        mode = getattr(self.config, "contention", "auto")
        if mode == "exact" or (mode == "auto" and n <= AUTO_CONTENTION_CUTOVER):
            return SharedLink(link)
        return IndexedSharedLink(link)

    def _make_tenant_env(
        self, req: FleetRequest, tenant_id: int, shared
    ) -> TenantEnvironment:
        base = make_testbed(
            self.config.testbed,
            seed=req.env_seed,
            constant_load=req.constant_load,
        )
        traffic = req.traffic if req.traffic is not None else base.traffic
        return TenantEnvironment(
            base.link,
            traffic,
            shared,
            tenant_id,
            noise_sigma=base.noise_sigma,
            seed=req.env_seed,
            turn_gate=None,  # the event loop itself is the serializer
            faults=self.config.faults,
        )

    # ------------------------------------------------------------------ #
    def run(self, requests: list[FleetRequest]) -> FleetReport:
        cfg = self.config
        n = len(requests)
        if n == 0:
            return FleetReport([], 0.0, 0.0, 0.0, 0.0, 0.0, 0, 0, 0)
        link = TESTBEDS[cfg.testbed]
        shared = self._make_shared(link, n)
        counter = _ActiveCounter()
        # The limiter is consulted directly (no turn wrapper): gate events
        # already arrive in simulated-time order through the event heap.
        limiter = ReprobeLimiter(cfg.reprobe_interval_s, n_active_fn=counter)
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
        # Service counters are cumulative across runs; report the delta.
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

        # Attempt-indexed state, laid out exactly like the threaded
        # scheduler's: slots 0..n-1 are first attempts, recovery
        # re-admissions append further slots.
        reqs: list[FleetRequest] = list(requests)
        origin = list(range(n))
        attempt_no = [0] * n
        reports: list[TransferReport | None] = [None] * n
        end_clock = [0.0] * n
        admit_time = [0.0] * n
        gens: list = [None] * n
        envs: list[TenantEnvironment | None] = [None] * n
        state = FleetStateArrays.allocate(n)
        self.state = state
        heap = self._make_heap(n)
        pending = collections.deque(
            sorted(range(n), key=lambda i: (reqs[i].start_clock_s, i))
        )
        n_kills = 0
        n_recoveries = 0

        def admit_next(now_s: float) -> None:
            if not pending:
                return
            i = pending.popleft()
            admit_time[i] = max(reqs[i].start_clock_s, now_s)
            state.admit_s[i] = admit_time[i]
            # Knowledge snapshot resolved at admission, in event order —
            # the same refresh-consistency point as the threaded engine.
            if knowledge is not None:
                feats = request_features(link, reqs[i].dataset)
                cluster = knowledge.query_cluster(None, feats)
                budget = knowledge.probe_budget(
                    None, admit_time[i], cfg.max_samples
                )
            else:
                cluster = self._query_cluster(i, link, reqs[i].dataset)
                budget = cfg.max_samples
            env = self._make_tenant_env(reqs[i], i, shared)
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
            self._advance(i, gens, envs, reports, state, heap)

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

        # Initial admission wave, before any event runs — mirrors the
        # threaded engine admitting (and clock-registering) the whole wave
        # before starting worker threads.
        for _ in range(min(cap, n)):
            admit_next(float("-inf"))

        # ---------------- the event loop ---------------- #
        while len(heap):
            _, i = heap.pop()
            self.events_processed += 1
            if state.phase[i] == PHASE_FINISH:
                env = envs[i]
                now = env.clock_s
                end_clock[i] = now
                state.end_s[i] = now
                rep = reports[i]
                # Same per-finish order as the threaded worker's final
                # serialized turn: fold knowledge in, re-admit the killed
                # session's residual, admit the next queued request, then
                # stop counting as active.
                if knowledge is not None and rep is not None:
                    # The service handles interrupted/collapsed sessions
                    # itself (fault signal, no fold-in).
                    knowledge.observe(rep, reqs[i].dataset, link=link, now_s=now)
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
                envs[i] = None  # free generator frame + env at scale
                continue
            self._advance(i, gens, envs, reports, state, heap)

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
    @staticmethod
    def _advance(i, gens, envs, reports, state, heap) -> None:
        """Resume slot ``i``'s generator through exactly one interaction.

        The generator performs the environment interaction it announced with
        its previous yield, then either announces the next one (re-queue at
        its new clock) or returns its ``TransferReport`` (queue the finish
        event at the session's final clock — the same key as the threaded
        worker's final turn).
        """
        try:
            t, phase, prm = next(gens[i])
        except StopIteration as stop:
            reports[i] = stop.value
            state.phase[i] = PHASE_FINISH
            state.next_event_s[i] = envs[i].clock_s
            heap.push(envs[i].clock_s, i)
            return
        state.phase[i] = phase
        state.params[i] = prm.as_tuple()
        state.next_event_s[i] = t
        heap.push(t, i)
