"""Diurnal background traffic: peak/off-peak external load.

The paper evaluates under peak and off-peak hours (XSEDE: generic diurnal WAN
load; DIDCLAB: university LAN peaking 11am-3pm).  External load is the fraction
of link capacity consumed by unlogged traffic, i.e. the quantity the paper's
load-intensity heuristic I_s = (bw - th_out)/bw estimates.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np

DAY_S = 24 * 3600.0


@dataclasses.dataclass
class DiurnalTraffic:
    """Sinusoidal-plus-noise diurnal load pattern in [0, 1)."""
    base_load: float = 0.10          # off-peak floor
    peak_load: float = 0.55          # added at the busiest hour
    peak_hour: float = 13.0          # center of the busy period
    peak_width_h: float = 4.0        # gaussian width of the busy period
    jitter: float = 0.04             # slow random walk amplitude
    seed: int = 0

    def __post_init__(self):
        self._rng = np.random.default_rng(self.seed)
        self._walk = 0.0

    def load_at(self, t_s: float) -> float:
        hour = (t_s % DAY_S) / 3600.0
        # circular distance to the peak hour
        d = min(abs(hour - self.peak_hour), 24.0 - abs(hour - self.peak_hour))
        diurnal = self.peak_load * math.exp(-0.5 * (d / self.peak_width_h) ** 2)
        self._walk = 0.98 * self._walk + self._rng.normal(0.0, self.jitter)
        load = self.base_load + diurnal + self._walk
        return float(min(max(load, 0.0), 0.95))

    def is_peak(self, t_s: float) -> bool:
        hour = (t_s % DAY_S) / 3600.0
        d = min(abs(hour - self.peak_hour), 24.0 - abs(hour - self.peak_hour))
        return d <= self.peak_width_h

    @staticmethod
    def constant(load: float) -> "DiurnalTraffic":
        t = DiurnalTraffic(base_load=load, peak_load=0.0, jitter=0.0)
        return t


@dataclasses.dataclass
class StepTraffic:
    """Piecewise-constant external load: ``steps`` is [(start_s, load), ...].

    The load at time t is the value of the last step whose start is <= t
    (``initial`` before the first step).  Deterministic — fleet tests use it
    to script harsh load changes that hit every tenant at the same instant,
    where DiurnalTraffic's per-instance random walk would decorrelate them.
    """
    steps: list[tuple[float, float]]
    initial: float = 0.0

    def __post_init__(self):
        self.steps = sorted(self.steps)

    def load_at(self, t_s: float) -> float:
        load = self.initial
        for start, level in self.steps:
            if t_s < start:
                break
            load = level
        return float(min(max(load, 0.0), 0.95))

    def is_peak(self, t_s: float) -> bool:
        return self.load_at(t_s) >= 0.5


@dataclasses.dataclass(frozen=True)
class RegimeShiftTraffic:
    """Abrupt mean-load regime change at ``shift_s`` — the paper's "harsh
    network change" at fleet scale.  External load sits at ``before`` until
    the shift instant, then jumps to ``after`` and stays there; an optional
    sinusoidal ripple adds bounded variation around either level.

    Deterministic and stateless (load is a pure function of t): one frozen
    instance can be shared across fleet tenants, hashed into benchmark
    caches, and replayed bit-for-bit — which is why the ripple is a sinusoid
    rather than DiurnalTraffic's stateful random walk.
    """
    shift_s: float
    before: float = 0.10
    after: float = 0.60
    ripple: float = 0.0              # peak amplitude of the sinusoidal ripple
    ripple_period_s: float = 900.0

    def load_at(self, t_s: float) -> float:
        base = self.before if t_s < self.shift_s else self.after
        wave = self.ripple * math.sin(2.0 * math.pi * t_s / self.ripple_period_s)
        return float(min(max(base + wave, 0.0), 0.95))

    def is_peak(self, t_s: float) -> bool:
        return self.load_at(t_s) >= 0.5
