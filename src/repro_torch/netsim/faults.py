"""Fault injection for simulated transfer paths.

The paper's online phase exists because real links misbehave *mid-transfer*:
background load shifts, loss regimes change, capacity collapses, endpoints
die.  HARP (arXiv:1708.03053) re-tunes when observed throughput diverges from
the historical model, and the two-phase follow-up (arXiv:1812.11255)
checkpoints transfer state to survive disruption — neither scenario class is
reachable with a smooth-contention-only simulator.  This module adds a
seeded, simulated-time-scheduled ``FaultSchedule`` of:

  * ``LinkFlap``        — the link goes (nearly) dark for an interval;
  * ``CapacityDrop``    — a sudden capacity cut that later restores;
  * ``LossBurst``       — a loss-regime change, modelled by perturbing the
                          link's ``loss_sensitivity`` / ``streams_to_saturate``
                          Mathis-law constants;
  * ``TenantKill``      — a session (one tenant, or whoever is on the link)
                          is killed at an instant — endpoint churn.

A schedule composes onto ``Environment``/``TenantEnvironment`` via the
``faults=`` constructor argument; ``faults=None`` (the default everywhere)
leaves the fault-free fast path untouched, byte-for-byte.  All fault state is
a pure function of simulated time, so faulted runs stay exactly as
deterministic as fault-free ones.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.netsim.environment import LinkSpec


class SessionKilled(Exception):
    """Raised by ``Environment.transfer`` when a ``TenantKill`` lands inside
    the chunk being transferred.  Carries what the chunk moved before dying
    so the recovery layer can checkpoint byte-exact progress."""

    def __init__(self, moved_mb: float, at_s: float):
        super().__init__(f"session killed at t={at_s:.3f}s "
                         f"after moving {moved_mb:.3f} MB of this chunk")
        self.moved_mb = float(moved_mb)
        self.at_s = float(at_s)


# --------------------------------------------------------------------- #
# fault event classes
# --------------------------------------------------------------------- #
@dataclasses.dataclass(frozen=True)
class LinkFlap:
    """Link (nearly) dark on [start_s, start_s + duration_s)."""
    start_s: float
    duration_s: float
    residual: float = 0.02    # capacity fraction that survives the flap

    @property
    def end_s(self) -> float:
        return self.start_s + self.duration_s

    def active(self, t_s: float) -> bool:
        return self.start_s <= t_s < self.end_s

    def capacity_factor(self, t_s: float) -> float:
        return self.residual if self.active(t_s) else 1.0


@dataclasses.dataclass(frozen=True)
class CapacityDrop:
    """Capacity multiplied by ``factor`` on [start_s, end_s), then restored."""
    start_s: float
    duration_s: float
    factor: float = 0.3

    @property
    def end_s(self) -> float:
        return self.start_s + self.duration_s

    def active(self, t_s: float) -> bool:
        return self.start_s <= t_s < self.end_s

    def capacity_factor(self, t_s: float) -> float:
        return self.factor if self.active(t_s) else 1.0


@dataclasses.dataclass(frozen=True)
class LossBurst:
    """Loss-regime change on [start_s, end_s): the path needs more streams to
    fill the pipe and over-subscription hurts harder — the Mathis-law knobs
    of the throughput law, perturbed multiplicatively.  ``goodput_factor``
    models the capacity the loss itself burns in retransmissions (without
    it a flow whose rate is capacity-bound rather than window/loss-bound
    would sail through the burst untouched)."""
    start_s: float
    duration_s: float
    loss_sensitivity_mult: float = 4.0
    streams_to_saturate_mult: float = 3.0
    goodput_factor: float = 0.7

    @property
    def end_s(self) -> float:
        return self.start_s + self.duration_s

    def active(self, t_s: float) -> bool:
        return self.start_s <= t_s < self.end_s

    def capacity_factor(self, t_s: float) -> float:
        return self.goodput_factor if self.active(t_s) else 1.0


@dataclasses.dataclass(frozen=True)
class TenantKill:
    """Kill the session of ``tenant_id`` at ``at_s`` (``None`` = whichever
    session's chunk spans the instant — single-tenant runs, or fleet-wide
    churn where every in-flight session dies at once)."""
    at_s: float
    tenant_id: int | None = None

    def matches(self, tenant_id: int | None) -> bool:
        return self.tenant_id is None or self.tenant_id == tenant_id


# --------------------------------------------------------------------- #
# the schedule
# --------------------------------------------------------------------- #
@dataclasses.dataclass(frozen=True)
class FaultSchedule:
    """An immutable, simulated-time-indexed set of fault events.

    Interval events (flaps, drops, bursts) may overlap; capacity factors
    multiply and Mathis-knob multipliers compound.  All queries are pure
    functions of time, so one schedule instance can be shared by every
    tenant of a fleet and replayed bit-for-bit.
    """
    events: tuple = ()

    def __post_init__(self):
        object.__setattr__(self, "events", tuple(self.events))

    # ---------------- interval-event state ---------------- #
    def _intervals(self):
        return (e for e in self.events if not isinstance(e, TenantKill))

    def capacity_factor(self, t_s: float) -> float:
        f = 1.0
        for e in self._intervals():
            f *= e.capacity_factor(t_s)
        return f

    def link_at(self, link: LinkSpec, t_s: float) -> LinkSpec:
        """The link as the faults active at ``t_s`` leave it.

        Returns ``link`` itself (is-identical) when nothing is active, so
        callers can cheaply detect the unperturbed case.
        """
        cap = 1.0
        ls_mult = 1.0
        sts_mult = 1.0
        for e in self._intervals():
            cap *= e.capacity_factor(t_s)
            if isinstance(e, LossBurst) and e.active(t_s):
                ls_mult *= e.loss_sensitivity_mult
                sts_mult *= e.streams_to_saturate_mult
        if cap == 1.0 and ls_mult == 1.0 and sts_mult == 1.0:
            return link
        return dataclasses.replace(
            link,
            bandwidth_mbps=link.bandwidth_mbps * cap,
            loss_sensitivity=link.loss_sensitivity * ls_mult,
            streams_to_saturate=max(
                1, int(round(link.streams_to_saturate * sts_mult))),
        )

    def next_change(self, t_s: float) -> float:
        """Earliest interval-event boundary strictly after ``t_s`` (``inf``
        when the fault state never changes again)."""
        nxt = float("inf")
        for e in self._intervals():
            for b in (e.start_s, e.end_s):
                if b > t_s:
                    nxt = min(nxt, b)
        return nxt

    # ---------------- kills ---------------- #
    def next_kill(self, tenant_id: int | None, after_s: float) -> float | None:
        """Earliest matching kill at or after ``after_s`` (None if none)."""
        times = [e.at_s for e in self.events
                 if isinstance(e, TenantKill) and e.matches(tenant_id)
                 and e.at_s >= after_s]
        return min(times) if times else None

    def kills(self) -> list[TenantKill]:
        return [e for e in self.events if isinstance(e, TenantKill)]

    # ---------------- constructors ---------------- #
    @staticmethod
    def generate(seed: int, *, start_s: float, horizon_s: float,
                 n_flaps: int = 1, n_drops: int = 1, n_bursts: int = 1,
                 n_kills: int = 0, n_tenants: int = 1,
                 mean_duration_s: float = 60.0) -> "FaultSchedule":
        """Seeded random schedule over [start_s, start_s + horizon_s).

        Event instants are uniform over the horizon, durations exponential
        around ``mean_duration_s``, severities drawn from fixed ranges —
        everything from one ``default_rng(seed)`` stream, so a scenario's
        fault mix is reproducible from its seed alone.
        """
        rng = np.random.default_rng(seed)

        def t0():
            return float(start_s + rng.uniform(0.0, horizon_s))

        def dur():
            return float(max(rng.exponential(mean_duration_s), 5.0))

        events: list = []
        for _ in range(n_flaps):
            events.append(LinkFlap(t0(), dur(),
                                   residual=float(rng.uniform(0.01, 0.05))))
        for _ in range(n_drops):
            events.append(CapacityDrop(t0(), dur(),
                                       factor=float(rng.uniform(0.15, 0.5))))
        for _ in range(n_bursts):
            events.append(LossBurst(
                t0(), dur(),
                loss_sensitivity_mult=float(rng.uniform(2.0, 6.0)),
                streams_to_saturate_mult=float(rng.uniform(2.0, 4.0))))
        for _ in range(n_kills):
            events.append(TenantKill(t0(),
                                     tenant_id=int(rng.integers(n_tenants))))
        events.sort(key=lambda e: (
            e.at_s if isinstance(e, TenantKill) else e.start_s, repr(e)))
        return FaultSchedule(tuple(events))
