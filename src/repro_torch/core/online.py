"""Online adaptive sampling (Algorithm 1, Sec. 3.2).

On a transfer request: query the offline DB for the matching cluster, sort its
surfaces by external load intensity, and start from the *median*-load
surface's precomputed argmax.  Each sample transfer's achieved throughput is
checked against the surface's Gaussian confidence band; a miss jumps to the
closest surface in the direction the miss indicates (lighter load if we
overshot the band, heavier if we undershot), eliminating about half of the
candidate surfaces per probe.  After convergence the rest of the dataset is
transferred chunk-by-chunk with the converged parameters, re-triggering the
surface search if mid-transfer throughput drifts out of band (the paper's
"harsh network change" detection).
"""
from __future__ import annotations

import dataclasses

from repro_torch.core.offline import ClusterKnowledge, OfflineDB
from repro_torch.core.surfaces import ThroughputSurface
from repro_torch.netsim.environment import Environment, TransferParams
from repro_torch.netsim.faults import SessionKilled
from repro_torch.netsim.workload import Dataset


@dataclasses.dataclass
class SampleRecord:
    params: TransferParams
    predicted: float
    achieved: float
    surface_load: float
    elapsed_s: float
    was_sample: bool


@dataclasses.dataclass(frozen=True)
class RecoveryConfig:
    """Fault-recovery knobs for sessions and fleets (None everywhere = the
    exact pre-recovery behaviour).

    ``collapse_frac``: a bulk chunk whose achieved rate is both out of the
    confidence band *and* below this fraction of the session's own previous
    observed rate is a throughput *collapse* — not ordinary drift — and
    triggers an immediate re-entry into adaptive probing from the
    historical-knowledge prior (fresh ``converge`` over the cluster's
    surface stack) instead of the two-strike closest-surface jump.  The
    reference is the session's *own* trailing observation, not the surface
    prediction: under fleet fair-share contention every chunk sits
    systematically below the single-tenant surfaces, and anchoring on the
    prediction would misread steady contention as a fault.
    ``surge_frac``: the symmetric detector — an above-band chunk more than
    this factor *over* the previous observation means the fault cleared (a
    flap ended, capacity restored — or contention drained after fleet
    churn) and the session re-probes back up immediately instead of
    waiting out the two-strike drift path.  Armed
    only after a collapse recovery: a fleet's tail (several contenders
    finishing inside one chunk) can also multiply a session's rate, so the
    surge path is reserved for sessions that know they are sitting in a
    fault-degraded regime.  ``reprobe_budget`` bounds the
    probes either re-entry may spend.  ``max_restarts``/``restart_delay_s``
    govern fleet re-admission of killed sessions.
    """

    collapse_frac: float = 0.5
    surge_frac: float = 2.0
    dead_frac: float = 0.1  # below this ratio the link is effectively dark:
    # probing it teaches nothing (every parameter choice is capacity-bound),
    # so the session just pins the closest prior surface and waits, armed,
    # for the surge that marks the fault clearing
    reprobe_budget: int = 2
    max_restarts: int = 3
    restart_delay_s: float = 2.0


@dataclasses.dataclass(frozen=True)
class SessionCheckpoint:
    """Progress checkpoint of an interrupted session (arXiv:1812.11255's
    transfer-state checkpointing, reduced to what re-admission needs)."""

    moved_mb: float                 # MB delivered before the interruption
    params: tuple[int, int, int]    # last live parameter tuple
    clock_s: float                  # simulated time of the interruption


@dataclasses.dataclass
class TransferReport:
    params: TransferParams          # converged parameters
    achieved_mbps: float            # whole-transfer effective throughput
    samples: list[SampleRecord]
    n_samples: int
    total_s: float
    param_changes: int
    moved_mb: float = 0.0           # MB actually delivered by this session
    interrupted: bool = False       # killed mid-transfer (see checkpoint)
    checkpoint: SessionCheckpoint | None = None
    collapses: int = 0              # collapse-recovery re-probes performed

    @property
    def predicted_mbps(self) -> float:
        return self.samples[-1].predicted if self.samples else 0.0

    @property
    def steady_mbps(self) -> float:
        """Time-weighted steady rate of the bulk phase (excludes probing).

        Degenerate reports stay well-defined: with no bulk records the
        whole-transfer rate stands in, and zero-duration records (instant
        chunks from an empty dataset or a mocked environment) fall back to
        the unweighted mean instead of dividing by zero.
        """
        bulk = [r for r in self.samples if not r.was_sample]
        if not bulk:
            return self.achieved_mbps
        w = sum(max(r.elapsed_s, 0.0) for r in bulk)
        if w <= 0.0:
            return float(sum(r.achieved for r in bulk) / len(bulk))
        return sum(r.achieved * max(r.elapsed_s, 0.0) for r in bulk) / w

    @property
    def prediction_accuracy(self) -> float:
        """Eq. 25 accuracy of the converged surface's prediction (%).

        0% with no bulk phase (nothing to score); 100% when prediction and
        achieved are both exactly zero (a vacuously exact prediction); 0%
        for any other non-positive pair (a negative extrapolated prediction
        against a stalled transfer must not score well).
        """
        bulk = [r for r in self.samples if not r.was_sample]
        if not bulk:
            return 0.0
        pred = bulk[-1].predicted
        ach = self.steady_mbps
        if pred <= 0.0 and ach <= 0.0:
            return 100.0 if pred == 0.0 and ach == 0.0 else 0.0
        # max(pred, ach) > 0 here, so the relative error is well-defined
        return float(max(0.0, 100.0 * (1.0 - abs(ach - pred) / max(pred, ach))))


def _closest_surface(surfaces: list[ThroughputSurface], prm: TransferParams,
                     achieved: float, *, lighter: bool | None
                     ) -> ThroughputSurface:
    """FindClosestSurface: surface whose value at the probed point is nearest
    to the achieved throughput, restricted to the load direction implied by
    the band miss (lighter=True -> lower I_s tags only)."""
    if lighter is True:
        cand = sorted(surfaces, key=lambda s: s.load_intensity)
        mid = [s for s in cand if s.predict(prm) <= achieved]
        cand = mid or cand
    elif lighter is False:
        cand = [s for s in sorted(surfaces, key=lambda s: s.load_intensity)
                if s.predict(prm) >= achieved] or surfaces
    else:
        cand = surfaces
    return min(cand, key=lambda s: abs(s.predict(prm) - achieved))


# Session-phase tags carried by ``AdaptiveSampler.session`` yields: what the
# session is about to do when its driver resumes it.  The vectorized fleet
# engine mirrors them into its stacked per-session state arrays.
PHASE_PROBE = 1     # next interaction is a probe transfer (converge loop)
PHASE_BULK = 2      # next interaction is a bulk chunk transfer
PHASE_GATE = 3      # next interaction is a re-probe-gate consultation


class AdaptiveSampler:
    """The paper's Adaptive Sampling Module (ASM).

    ``reprobe_gate`` is an optional callable ``(now_s) -> bool`` consulted
    before a mid-transfer re-parameterization; the fleet scheduler passes a
    shared rate limiter here so a capacity drop does not trigger a fleet-wide
    re-probe storm.  ``None`` (single-tenant) preserves the original
    behaviour exactly.

    The session logic itself lives in :meth:`session`, a generator that
    yields ``(clock_s, phase, params)`` immediately before every environment
    interaction (each probe/bulk ``env.transfer`` and each ``reprobe_gate``
    consultation) and returns the ``TransferReport``.  :meth:`transfer`
    drives it to completion in place — the single-tenant path and the
    threaded fleet (whose ``TenantEnvironment.turn_gate`` serializes each
    interaction) both go through it — while the vectorized fleet engine
    interleaves many sessions by resuming whichever generator's yielded
    clock is the fleet minimum.  One code path, two schedulers: per-session
    behaviour is identical by construction.
    """

    def __init__(self, db: OfflineDB, *, z: float = 2.0, max_samples: int = 3,
                 bulk_chunks: int = 8, reprobe_gate=None,
                 recovery: RecoveryConfig | None = None):
        self.db = db
        self.z = z
        self.max_samples = max_samples
        self.bulk_chunks = bulk_chunks
        self.reprobe_gate = reprobe_gate
        self.recovery = recovery

    # ------------------------------------------------------------------ #
    def converge(self, env: Environment, dataset: Dataset,
                 cluster: ClusterKnowledge,
                 records: list[SampleRecord],
                 probe_mb: float | None = None,
                 budget: int | None = None) -> ThroughputSurface:
        """Probe phase: locate the surface matching current external load.

        Driver around :meth:`_converge` for callers outside a fleet engine;
        see there for the algorithm.
        """
        gen = self._converge(env, dataset, cluster, records, probe_mb, budget)
        try:
            while True:
                next(gen)
        except StopIteration as stop:
            return stop.value

    def _converge(self, env: Environment, dataset: Dataset,
                  cluster: ClusterKnowledge,
                  records: list[SampleRecord],
                  probe_mb: float | None = None,
                  budget: int | None = None):
        """Probe phase: locate the surface matching current external load.

        Sample 1 goes to the most *discriminative* point of the precomputed
        sampling region R_c (Sec. 3.1.4) — the coordinate where the cluster's
        surfaces are maximally separated — which identifies the load level in
        a single probe.  Subsequent samples run the Algorithm-1 loop: probe
        the current surface's argmax, check the Gaussian band, and jump to the
        closest surface on a miss (discarding half the stack each time).

        Generator: yields ``(clock_s, PHASE_PROBE, params)`` before each
        probe transfer; returns the converged surface.

        A budget of 1 is the *reduced-probe* session the knowledge
        service's probe-rate backoff relies on (``core.service.backoff``):
        the discriminative probe consumes the whole budget, the Algorithm-1
        loop is skipped, and the session proceeds on the closest surface
        that single probe identified — one probe instead of up to
        ``max_samples``, with the fleet engines restoring the full budget
        whenever the policy deems the link volatile again.
        """
        surfaces = cluster.sorted_by_load()
        if probe_mb is None:
            probe_mb = dataset.sample_chunks(
                self.bulk_chunks + self.max_samples)[0]
        cur = surfaces[len(surfaces) // 2]          # median load intensity
        remaining = list(surfaces)
        if budget is None:
            budget = self.max_samples

        # --- sample 1: discriminative probe from R_c ------------------- #
        region = cluster.region
        if len(surfaces) > 1 and region.discriminative_points:
            prm = region.discriminative_points[0]
            yield env.clock_s, PHASE_PROBE, prm
            res = env.transfer(prm, probe_mb, dataset.avg_file_mb,
                               dataset.n_files, is_sample=True)
            achieved = res.steady_mbps
            cur = min(surfaces, key=lambda s: abs(s.predict(prm) - achieved))
            records.append(SampleRecord(prm, cur.predict(prm), achieved,
                                        cur.load_intensity, res.elapsed_s,
                                        True))
            budget -= 1

        # --- Algorithm-1 loop over surface argmaxima ------------------- #
        for _ in range(budget):
            prm = cur.argmax_params
            yield env.clock_s, PHASE_PROBE, prm
            res = env.transfer(prm, probe_mb, dataset.avg_file_mb,
                               dataset.n_files, is_sample=True)
            achieved = res.steady_mbps     # monitored steady rate, post-ramp
            predicted = cur.predict(prm)
            records.append(SampleRecord(prm, predicted, achieved,
                                        cur.load_intensity, res.elapsed_s, True))
            if cur.in_confidence(prm, achieved, self.z):
                break                                # converged
            lighter = cur.above_band(prm, achieved, self.z)
            # discard the half of the stack on the wrong side of cur
            if lighter:
                remaining = [s for s in remaining
                             if s.load_intensity <= cur.load_intensity]
            else:
                remaining = [s for s in remaining
                             if s.load_intensity >= cur.load_intensity]
            nxt = _closest_surface(remaining or surfaces, prm, achieved,
                                   lighter=lighter)
            if nxt is cur:
                break
            cur = nxt
        return cur

    # ------------------------------------------------------------------ #
    def transfer(self, env: Environment, dataset: Dataset,
                 cluster: ClusterKnowledge | None = None) -> TransferReport:
        """Run one full transfer session (probe phase + bulk phase).

        Thin driver over :meth:`session`; see there for the semantics.
        """
        gen = self.session(env, dataset, cluster)
        try:
            while True:
                next(gen)
        except StopIteration as stop:
            return stop.value

    def session(self, env: Environment, dataset: Dataset,
                cluster: ClusterKnowledge | None = None):
        """One full transfer session (probe phase + bulk phase) as a
        generator yielding ``(clock_s, phase, params)`` immediately before
        every environment interaction; returns the ``TransferReport``.

        ``cluster`` pins the session's knowledge snapshot; ``None`` queries
        the DB here, which is identical as long as the DB is not refreshed
        concurrently.  The fleet scheduler resolves the snapshot at admission
        time (inside its simulated-time serializer) so sessions racing a
        continuous refresh still see deterministic, fully-consistent
        knowledge.
        """
        if cluster is None:
            cluster = self.db.query(_request_features(env, dataset))
        records: list[SampleRecord] = []
        t0 = env.clock_s
        probe_mb = dataset.sample_chunks(self.bulk_chunks + self.max_samples)[0]
        params: TransferParams | None = None
        bulk_moved_mb = 0.0   # bulk MB delivered (kill/collapse bookkeeping)
        partial_mb = 0.0      # MB a killed chunk moved before dying
        sampled_mb = 0.0      # probe MB delivered
        # (records-at-start, probe size) of the converge call in flight, so a
        # kill mid-probe-phase still yields byte-exact progress accounting
        probe_ctx: tuple[int, float] | None = (0, probe_mb)
        interrupted = False
        collapses = 0
        try:
            surface = yield from self._converge(env, dataset, cluster,
                                                records, probe_mb)
            params = surface.argmax_params

            # bulk phase: chunked transfer with drift detection
            probe_ctx = None
            sampled_mb = len(records) * probe_mb
            remaining = max(dataset.total_mb - sampled_mb, 0.0)
            chunk_mb = remaining / self.bulk_chunks
            surfaces = cluster.sorted_by_load()
            strikes = 0
            chunks_left = self.bulk_chunks
            # Collapse reference: the session's own last observed rate (the
            # converged probe before the first chunk, then each bulk chunk).
            baseline = records[-1].achieved if records else None
            armed = False  # surge re-probe armed by a preceding collapse
            hold = False   # regime outside the prior: freeze the drift path
            while chunks_left > 0:
                if chunk_mb <= 0:
                    break
                yield env.clock_s, PHASE_BULK, params
                res = env.transfer(params, chunk_mb, dataset.avg_file_mb,
                                   dataset.n_files)
                chunks_left -= 1
                bulk_moved_mb += chunk_mb
                achieved = res.steady_mbps
                records.append(SampleRecord(params, surface.predict(params),
                                            achieved, surface.load_intensity,
                                            res.elapsed_s, False))
                prev_rate = baseline
                baseline = achieved
                if not surface.in_confidence(params, achieved, self.z):
                    collapsed = (prev_rate is not None
                                 and achieved < self.recovery.collapse_frac
                                 * prev_rate) if self.recovery else False
                    # No above-band requirement on the surge: an armed
                    # session sits on the *lowest-predicting* prior surface,
                    # which can still over-predict a dark link by an order
                    # of magnitude, so post-fault rates may surge well
                    # before they re-enter any band.  Arming (a preceding
                    # collapse) is the guard that keeps fault-free fleets
                    # from ever reaching this test.
                    surged = (armed and prev_rate is not None
                              and prev_rate > 0.0
                              and achieved > self.recovery.surge_frac
                              * prev_rate) if self.recovery else False
                    if (self.recovery is not None and chunks_left > 0
                            and (collapsed or surged)):
                        # Throughput *collapse* (or the symmetric surge when
                        # a fault clears), not drift: the link changed under
                        # us.  Checkpoint progress and re-enter adaptive
                        # probing from the historical prior instead of a
                        # single surface jump.
                        ratio = achieved / prev_rate if prev_rate else 1.0
                        if collapsed and ratio < self.recovery.dead_frac:
                            # Link effectively dark: every parameter choice
                            # is capacity-bound, so probing teaches nothing.
                            # Pin the closest prior surface and wait, armed,
                            # for the surge that marks the fault clearing.
                            # No gate check: this path spawns no process and
                            # sends no probe, so it cannot join a storm.
                            collapses += 1
                            surface = _closest_surface(surfaces, params,
                                                       achieved, lighter=False)
                            armed = True
                            hold = True  # the prior has no dark-link surface
                            strikes = 0
                            continue
                        # Recovery re-probes respawn processes and transfer
                        # probe chunks, so they answer to the same fleet-wide
                        # limiter as the drift path — a fleet-wide capacity
                        # swing must not trigger N simultaneous re-probe
                        # storms.  Denied sessions fall through to ordinary
                        # strike accounting and retry through the drift path.
                        if self.reprobe_gate is not None:
                            yield env.clock_s, PHASE_GATE, params
                            if not self.reprobe_gate(env.clock_s):
                                strikes += 1
                                continue
                        collapses += 1
                        n_before = len(records)
                        # Probe size scaled to the observed rate ratio: a
                        # full-size probe at a collapsed rate would cost more
                        # time than the bulk chunks it is trying to rescue.
                        re_probe_mb = probe_mb * float(
                            min(max(ratio, 0.05), 1.0))
                        probe_ctx = (n_before, re_probe_mb)
                        surface = yield from self._converge(
                            env, dataset, cluster, records, re_probe_mb,
                            budget=self.recovery.reprobe_budget)
                        params = surface.argmax_params
                        probe_ctx = None
                        sampled_mb += (len(records) - n_before) * re_probe_mb
                        left = max(dataset.total_mb - sampled_mb
                                   - bulk_moved_mb, 0.0)
                        chunk_mb = left / chunks_left
                        strikes = 0
                        # re-anchor on the re-probe's own observation
                        baseline = records[-1].achieved
                        # If even the re-probe's chosen surface cannot
                        # explain what the probe measured, this regime is
                        # outside the prior's support — hold the
                        # empirically probed parameters instead of letting
                        # the drift path chase surfaces that all mispredict.
                        # A holding session stays armed (a surge out of the
                        # unexplained regime must still be able to re-probe
                        # it); a session whose re-probe was explained
                        # disarms back to ordinary drift handling.
                        hold = not surface.in_confidence(
                            records[-1].params, records[-1].achieved, self.z)
                        armed = collapsed or hold
                        continue
                    # Require two consecutive out-of-band chunks before
                    # acting: re-parameterizing on a single noisy reading
                    # costs a process respawn + slow start (Sec. 3.2:
                    # changes are expensive).  A *holding* session skips the
                    # drift path entirely: its last re-probe showed that no
                    # prior surface describes this fault regime, so chasing
                    # them surface-to-surface only walks the parameters off
                    # the empirically probed optimum — only another collapse
                    # or the clearing surge may move a holding session.
                    strikes += 1
                    if strikes >= 2 and not hold:
                        if self.reprobe_gate is not None:
                            yield env.clock_s, PHASE_GATE, params
                            if not self.reprobe_gate(env.clock_s):
                                continue  # denied: keep strikes, retry later
                        surface = _closest_surface(
                            surfaces, params, achieved,
                            lighter=surface.above_band(params, achieved,
                                                       self.z))
                        if surface.argmax_params.as_tuple() != params.as_tuple():
                            params = surface.argmax_params
                        strikes = 0
                else:
                    strikes = 0
                    # Back in band: the regime settled, so a later rate jump
                    # is ordinary fleet churn again, not a fault clearing.
                    armed = False
                    hold = False
        except SessionKilled as kill:
            interrupted = True
            if probe_ctx is not None:  # killed inside a converge() call
                n0, psize = probe_ctx
                sampled_mb += (len(records) - n0) * psize
            partial_mb = kill.moved_mb
            if params is None:  # killed during the probe phase
                params = records[-1].params if records else TransferParams(1, 1, 1)
        total_s = env.clock_s - t0
        if interrupted:
            moved_mb = sampled_mb + bulk_moved_mb + partial_mb
        else:
            # Whole-transfer rate divides the MB actually moved: probes on a
            # tiny dataset can exceed total_mb (then the bulk phase is empty
            # and the session still moved sampled_mb), so the numerator must
            # not be clamped to the dataset size.  In the normal
            # remaining > 0 case the probes + bulk chunks add up to exactly
            # total_mb.
            moved_mb = max(dataset.total_mb, sampled_mb)
        achieved_total = moved_mb * 8.0 / max(total_s, 1e-9)
        # Parameter changes = actual session switches the protocol paid for
        # (initial spawn + every consecutive-record parameter transition),
        # not distinct tuples — a probe revisiting an earlier tuple is a new
        # switch, and a discriminative probe colliding with the argmax is not.
        param_changes = _count_param_switches(records)
        checkpoint = SessionCheckpoint(moved_mb, params.as_tuple(),
                                       env.clock_s) if interrupted else None
        return TransferReport(params, achieved_total, records,
                              n_samples=sum(r.was_sample for r in records),
                              total_s=total_s, param_changes=param_changes,
                              moved_mb=moved_mb, interrupted=interrupted,
                              checkpoint=checkpoint, collapses=collapses)


def _count_param_switches(records: list[SampleRecord]) -> int:
    """Number of parameter switches a session actually paid setup cost for:
    one for the initial spawn plus one per consecutive-record transition."""
    if not records:
        return 0
    return 1 + sum(a.params.as_tuple() != b.params.as_tuple()
                   for a, b in zip(records, records[1:]))


def request_features(link, dataset: Dataset):
    """Cluster-query feature vector of a transfer request (link + dataset).

    The single canonical definition — the fleet admission path reuses it, so
    online queries and fleet demand prediction can never disagree on cluster
    routing.
    """
    import numpy as np
    return np.array([
        np.log10(link.bandwidth_mbps),
        np.log10(max(link.rtt_s, 1e-5)),
        np.log10(dataset.avg_file_mb),
        np.log10(dataset.n_files),
    ])


def _request_features(env: Environment, dataset: Dataset):
    return request_features(env.link, dataset)
