"""Declarative scenario matrix: (testbed x traffic x fault x fleet size).

Every scenario is a frozen, seed-complete description of one fleet run; the
runner produces a *canonical trace* — a nested tuple of admissions, probe /
bulk records, parameter switches, recoveries, and refresh counts — that must
be identical across repeated in-process runs (the fleet scheduler is a
conservative discrete-event simulation) and satisfies the physical
invariants ``check_invariants`` enforces:

  * no session lost: with recovery on, every request's final attempt
    completes uninterrupted;
  * bytes conserved: the attempts serving one request deliver at least the
    request's bytes, and each continuation carries exactly the residual of
    its predecessor;
  * fault-free fleets behave identically with and without the recovery
    layer configured (the collapse/surge detectors must never fire on
    ordinary contention).

The same machinery drives ``benchmarks/fault_recovery.py``, which gates
recovery-on strictly beating recovery-off on delivered goodput and
completion-weighted tracking accuracy under every fault class.
"""
from __future__ import annotations

import dataclasses
import warnings

from repro_torch.core import (
    EngineConfig,
    FleetReport,
    FleetRequest,
    RecoveryConfig,
    RefreshConfig,
    TransferTuner,
    TunerConfig,
    run_fleet,
)
from repro_torch.netsim import (
    CapacityDrop,
    FaultSchedule,
    LinkFlap,
    LossBurst,
    RegimeShiftTraffic,
    TenantKill,
    generate_history,
    make_dataset,
    make_testbed,
)

START_CLOCK_S = 4 * 3600.0  # off-peak morning, shared by every scenario

FAULT_KINDS = ("none", "flap", "drop", "burst", "kill", "churn")
TRAFFIC_KINDS = ("constant", "shift")


@dataclasses.dataclass(frozen=True)
class Scenario:
    """One cell of the scenario matrix — everything needed to reproduce a
    fleet run bit-for-bit lives in this frozen record."""

    name: str
    testbed: str = "xsede"
    fleet_size: int = 3
    file_class: str = "medium"
    fault: str = "none"
    traffic: str = "constant"
    recovery: bool = True
    refresh: bool = False
    seed: int = 0

    def __post_init__(self):
        if self.fault not in FAULT_KINDS:
            raise ValueError(f"unknown fault kind {self.fault!r}")
        if self.traffic not in TRAFFIC_KINDS:
            raise ValueError(f"unknown traffic kind {self.traffic!r}")


# --------------------------------------------------------------------- #
# scenario -> concrete run inputs
# --------------------------------------------------------------------- #
def build_scenario_db(testbed: str, *, seed: int = 0, days: float = 4.0,
                      transfers_per_day: int = 120, device=None):
    """The offline knowledge a scenario's fleet runs against (one fresh fit
    per call, so refresh-enabled runs never leak state across scenarios),
    fit on ``device`` (None: the CUDA card)."""
    env = make_testbed(testbed, seed=seed + 3)
    hist = generate_history(env, days=days,
                            transfers_per_day=transfers_per_day, seed=seed)
    return TransferTuner(TunerConfig(seed=seed, device=device)).fit(hist).db


def build_faults(sc: Scenario) -> FaultSchedule | None:
    """The scenario's fault schedule, anchored shortly after fleet start.

    Severities are deliberately harsh — the classes exist to exercise the
    collapse / surge / kill machinery, not to tickle the confidence band.
    """
    t = START_CLOCK_S
    if sc.fault == "none":
        return None
    if sc.fault == "flap":
        return FaultSchedule((LinkFlap(t + 25.0, 240.0),))
    if sc.fault == "drop":
        return FaultSchedule((CapacityDrop(t + 20.0, 600.0, factor=0.15),))
    if sc.fault == "burst":
        return FaultSchedule((LossBurst(t + 20.0, 400.0,
                                        loss_sensitivity_mult=4.0,
                                        streams_to_saturate_mult=8.0,
                                        goodput_factor=0.3),))
    if sc.fault == "kill":
        # endpoints die while a capacity cut is in force: the restarted
        # sessions must re-tune under conditions the first attempt never saw
        kills = tuple(TenantKill(t + 30.0 + 15.0 * i, tenant_id=i % sc.fleet_size)
                      for i in range(min(2, sc.fleet_size)))
        return FaultSchedule(kills + (CapacityDrop(t + 25.0, 300.0, factor=0.3),))
    # churn: a seeded random mix over the fleet's opening minutes
    return FaultSchedule.generate(sc.seed + 11, start_s=t, horizon_s=90.0,
                                  n_flaps=0, n_drops=1, n_bursts=0,
                                  n_kills=3, n_tenants=sc.fleet_size)


def build_requests(sc: Scenario) -> list[FleetRequest]:
    traffic = None
    constant_load: float | None = 0.15
    if sc.traffic == "shift":
        traffic = RegimeShiftTraffic(shift_s=START_CLOCK_S + 40.0,
                                     before=0.10, after=0.60)
        constant_load = None
    return [
        FleetRequest(
            dataset=make_dataset(sc.file_class, 30 + sc.seed * 100 + i),
            env_seed=200 + sc.seed * 100 + i,
            start_clock_s=START_CLOCK_S,
            constant_load=constant_load,
            traffic=traffic,
        )
        for i in range(sc.fleet_size)
    ]


def run_scenario(db, sc: Scenario, *, recovery: bool | None = None,
                 engine: str = "threaded",
                 service: bool = False) -> FleetReport:
    """Run one scenario against a pre-built DB via the ``run_fleet`` facade.

    ``recovery`` overrides the scenario's own flag (the on-vs-off
    comparisons use this); ``engine`` selects the scheduler — the
    engine-parity tests run every cell through ``"threaded"``,
    ``"vectorized"``, and ``"sharded"`` (strict regime) and assert
    bit-identical traces.
    ``service=True`` routes knowledge through a ``KnowledgeService``
    (streaming ingest in place of the cadence refresher) — opt-in, so the
    default path stays bit-identical to the legacy golden traces."""
    rec = sc.recovery if recovery is None else recovery
    knowledge = None
    if service:
        from repro_torch.core.service import KnowledgeService, ServiceConfig
        knowledge = KnowledgeService(db, ServiceConfig(
            max_staleness_s=120.0, drift_threshold=0.1))
    with warnings.catch_warnings():
        # Fault-free cells deliberately configure recovery — the matrix's
        # "recovery must not perturb fault-free fleets" invariant — so the
        # recovery-without-faults advisory is expected here.
        warnings.simplefilter("ignore", UserWarning)
        config = EngineConfig(
            engine=engine,
            testbed=sc.testbed,
            max_concurrent=sc.fleet_size,
            faults=build_faults(sc),
            recovery=RecoveryConfig() if rec else None,
            refresh=RefreshConfig(every_completions=2, min_entries=4)
            if sc.refresh and not service else None,
            knowledge=knowledge,
        )
    return run_fleet(db, build_requests(sc), config)


# --------------------------------------------------------------------- #
# canonical traces + invariants
# --------------------------------------------------------------------- #
def canonical_trace(fleet: FleetReport) -> tuple:
    """A run's observable history as one nested tuple.

    Contains every admission (request, attempt, tenant, admit/end clocks),
    every probe and bulk record (params, predicted, achieved, duration),
    interruption checkpoints, and the fleet-level counters — rounded to
    fixed decimals so the trace is printable, while remaining exact enough
    (1e-6) that any behavioural divergence shows up.
    """
    sessions = []
    for s in fleet.sessions:
        recs = tuple(
            (r.params.as_tuple(), bool(r.was_sample),
             round(r.predicted, 6), round(r.achieved, 6),
             round(r.elapsed_s, 6))
            for r in s.report.samples
        )
        ck = s.report.checkpoint
        sessions.append((
            s.request_index, s.attempt, s.tenant_id,
            round(s.admit_s, 6), round(s.end_s, 6),
            bool(s.report.interrupted),
            round(s.report.moved_mb, 6),
            s.report.collapses,
            None if ck is None else (round(ck.moved_mb, 6), ck.params,
                                     round(ck.clock_s, 6)),
            recs,
        ))
    return (
        tuple(sessions),
        fleet.kills,
        fleet.recoveries,
        fleet.refreshes,
        fleet.refreshed_entries,
        round(fleet.goodput_mbps, 6),
        round(fleet.makespan_s, 6),
        (fleet.reprobe_grants, fleet.reprobe_denials),
    )


def delivered_fraction(fleet: FleetReport, requests: list[FleetRequest]
                       ) -> float:
    """Delivered bytes / requested bytes (continuations roll up into their
    original request; probe overshoot on tiny datasets never counts above
    1.0 per request)."""
    total = sum(req.dataset.total_mb for req in requests)
    got = 0.0
    for i, req in enumerate(requests):
        moved = sum(a.report.moved_mb for a in fleet.attempts_for(i))
        got += min(moved, req.dataset.total_mb)
    return got / max(total, 1e-9)


def tracking_accuracy(fleet: FleetReport) -> float:
    """Mean per-chunk Eq. 25 accuracy of the active surface over every bulk
    chunk of every session attempt — how well the online model *tracked*
    the link while the fleet was moving bytes."""
    accs = []
    for s in fleet.sessions:
        for r in s.report.samples:
            if r.was_sample:
                continue
            m = max(r.predicted, r.achieved)
            accs.append(100.0 * (1.0 - abs(r.achieved - r.predicted) / m)
                        if m > 0 else 100.0)
    if not accs:
        return 0.0
    return float(sum(max(a, 0.0) for a in accs) / len(accs))


def check_invariants(sc: Scenario, fleet: FleetReport,
                     requests: list[FleetRequest], *,
                     recovery: bool | None = None) -> list[str]:
    """Physical invariants of one finished run; returns violations.

    ``recovery`` is the flag the run actually used — pass it whenever
    ``run_scenario`` was called with an override, else the scenario's own
    flag is assumed.
    """
    rec = sc.recovery if recovery is None else recovery
    bad: list[str] = []
    n = len(requests)
    if len(fleet.reports) != n:
        bad.append(f"{sc.name}: {len(fleet.reports)} final reports for "
                   f"{n} requests")
    has_kills = any(isinstance(e, TenantKill)
                    for e in (build_faults(sc) or FaultSchedule(())).events)
    for i, req in enumerate(requests):
        attempts = fleet.attempts_for(i)
        if not attempts:
            bad.append(f"{sc.name}: request {i} has no attempts")
            continue
        moved = sum(a.report.moved_mb for a in attempts)
        final = attempts[-1].report
        if rec:
            if final.interrupted:
                bad.append(f"{sc.name}: request {i} lost (final attempt "
                           f"interrupted with recovery on)")
            if moved < req.dataset.total_mb - 1e-6:
                bad.append(f"{sc.name}: request {i} delivered {moved:.3f} of "
                           f"{req.dataset.total_mb:.3f} MB")
        # each continuation must have been admitted for at least the residual
        # its predecessors left over (byte-exact checkpointing; probes may
        # overshoot a tiny residual, so "at least", not "exactly")
        residual = req.dataset.total_mb
        for a in attempts[:-1]:
            residual = max(residual - a.report.moved_mb, 0.0)
        if (len(attempts) > 1 and not final.interrupted
                and final.moved_mb < residual - 1e-6):
            bad.append(f"{sc.name}: request {i} final attempt moved "
                       f"{final.moved_mb:.3f}, residual was {residual:.3f}")
        for a in attempts:
            if a.admit_s < START_CLOCK_S - 1e-9:
                bad.append(f"{sc.name}: attempt admitted before fleet start")
            if a.end_s < a.admit_s - 1e-9:
                bad.append(f"{sc.name}: attempt ends before it is admitted")
    if not has_kills and fleet.kills:
        bad.append(f"{sc.name}: {fleet.kills} kills without kill events")
    if fleet.recoveries and not rec:
        bad.append(f"{sc.name}: recoveries counted with recovery off")
    if fleet.makespan_s <= 0 or fleet.goodput_mbps <= 0:
        bad.append(f"{sc.name}: degenerate makespan/goodput")
    return bad


# --------------------------------------------------------------------- #
# the matrix
# --------------------------------------------------------------------- #
def _matrix() -> list[Scenario]:
    """The shipped grid: a full fault sweep on the reference cell plus a
    pruned cross of the other axes (testbed, fleet size, traffic) over the
    faults whose dynamics depend on them most."""
    out = []
    # full fault sweep at the reference point
    for fault in FAULT_KINDS:
        out.append(Scenario(name=f"xsede-3-{fault}-constant",
                            testbed="xsede", fleet_size=3, fault=fault))
    # cross the remaining axes over {none, drop} (+ kill on the lossy WAN)
    for testbed in ("xsede", "didclab-xsede"):
        for fleet in (1, 3):
            for fault in ("none", "drop"):
                for traffic in TRAFFIC_KINDS:
                    name = f"{testbed}-{fleet}-{fault}-{traffic}"
                    if any(s.name == name for s in out):
                        continue
                    out.append(Scenario(name=name, testbed=testbed,
                                        fleet_size=fleet, fault=fault,
                                        traffic=traffic))
    out.append(Scenario(name="didclab-xsede-3-kill-constant",
                        testbed="didclab-xsede", fleet_size=3, fault="kill"))
    return out


SCENARIO_MATRIX: list[Scenario] = _matrix()
