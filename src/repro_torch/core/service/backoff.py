"""Probe-rate backoff: quiescent links earn exponentially longer probe intervals.

The adaptive-sampling loop spends real bandwidth on probes (Sec. 3.2); on a
link whose observed steady rates barely move, most of that spend buys no new
information.  ``ProbePolicy`` watches the coefficient of variation of recent
completed-session rates per endpoint pair and lengthens the full-probe
interval exponentially while the link stays quiet, resetting to the base
interval the moment volatility or a fault-collapse signal appears (the
variance-driven adaptive sampling-interval loop of the edge-implementation
reference, applied to probe budgets).  Between full probes a session runs
with a reduced probe budget instead of the full Algorithm-1 convergence loop.

Opt-in mirrors ``RecoveryConfig``: no config, no behavior change — engines
without a backoff policy probe exactly as before, bit for bit.
"""

from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class ProbeBackoffConfig:
    """Validated knobs for :class:`ProbePolicy` (frozen, shareable)."""

    # Interval between full-budget probe sessions while the link is quiet;
    # the first session on a pair always probes at full budget.
    base_interval_s: float = 300.0
    # Ceiling the exponential backoff saturates at.
    max_interval_s: float = 7200.0
    # Interval multiplier applied after each quiescent variance window.
    growth: float = 2.0
    # Coefficient of variation (sigma/mean of windowed steady rates) at or
    # below which the link counts as quiescent.
    cv_threshold: float = 0.05
    # Completed sessions per variance window.
    window: int = 4
    # Probe budget (max_samples) for sessions inside a backoff interval.
    reduced_budget: int = 1

    def __post_init__(self) -> None:
        self.validate()

    def validate(self) -> None:
        if self.base_interval_s <= 0.0:
            raise ValueError("base_interval_s must be positive")
        if self.max_interval_s < self.base_interval_s:
            raise ValueError("max_interval_s must be >= base_interval_s")
        if self.growth < 1.0:
            raise ValueError("growth must be >= 1.0")
        if self.cv_threshold < 0.0:
            raise ValueError("cv_threshold must be non-negative")
        if self.window < 2:
            raise ValueError("window must be >= 2")
        if self.reduced_budget < 1:
            raise ValueError("reduced_budget must be >= 1")


@dataclasses.dataclass
class _PairBackoff:
    """Per-pair backoff state.  Serialized by the owning service's lock."""

    interval_s: float
    last_full_probe_s: float | None = None
    rates: list[float] = dataclasses.field(default_factory=list)
    backoffs: int = 0  # interval lengthenings
    resets: int = 0  # volatility / fault resets


class ProbePolicy:
    """Per-pair exponential probe-interval backoff on low observed variance.

    Not internally locked: callers (``KnowledgeService``) serialize access,
    and all timestamps are simulation time passed in by the caller — the
    policy never reads a clock, so identical observation sequences produce
    identical budget decisions.
    """

    def __init__(self, config: ProbeBackoffConfig | None = None) -> None:
        self.config = config or ProbeBackoffConfig()
        self._pairs: dict[tuple[str, str], _PairBackoff] = {}

    def _state(self, pair: tuple[str, str]) -> _PairBackoff:
        st = self._pairs.get(pair)
        if st is None:
            st = _PairBackoff(interval_s=self.config.base_interval_s)
            self._pairs[pair] = st
        return st

    # ------------------------------------------------------------------ #
    def observe(self, pair: tuple[str, str], rate_mbps: float) -> None:
        """Fold one completed session's steady rate into the variance window.

        A full window with coefficient of variation at or below the
        threshold lengthens the probe interval (x growth, saturating at the
        ceiling); a noisy window snaps it back to the base interval.  The
        window is consumed either way, so each decision sees fresh data.
        """
        cfg = self.config
        st = self._state(pair)
        if not math.isfinite(rate_mbps) or rate_mbps <= 0.0:
            # A collapsed/zero-rate session is volatility by definition —
            # and a non-finite rate (NaN slips through any `<= 0` guard,
            # inf saturates the mean) is a broken measurement path, not a
            # sample: folding either would poison the window mean and read
            # as an ordinary noisy window instead of a fault.
            self.notify_fault(pair)
            return
        st.rates.append(float(rate_mbps))
        if len(st.rates) < cfg.window:
            return
        n = float(len(st.rates))
        mean = sum(st.rates) / n
        var = sum((r - mean) ** 2 for r in st.rates) / n
        cv = (var**0.5) / mean if mean > 0.0 else float("inf")
        st.rates.clear()
        if cv <= cfg.cv_threshold:
            st.interval_s = min(st.interval_s * cfg.growth, cfg.max_interval_s)
            st.backoffs += 1
        else:
            if st.interval_s != cfg.base_interval_s:
                st.resets += 1
            st.interval_s = cfg.base_interval_s

    def notify_fault(self, pair: tuple[str, str]) -> None:
        """Fault/collapse signal: reset to the base interval immediately."""
        st = self._state(pair)
        if st.interval_s != self.config.base_interval_s:
            st.resets += 1
        st.interval_s = self.config.base_interval_s
        st.rates.clear()
        # Force the next session to probe at full budget.
        st.last_full_probe_s = None

    def probe_budget(
        self, pair: tuple[str, str], now_s: float, default: int
    ) -> int:
        """Probe budget for a session admitted at ``now_s``.

        Returns ``default`` (and restarts the interval clock) when the pair
        is due a full probe — first session ever, or the current backoff
        interval has elapsed — and the reduced budget otherwise.
        """
        st = self._state(pair)
        if (
            st.last_full_probe_s is None
            or now_s - st.last_full_probe_s >= st.interval_s
        ):
            st.last_full_probe_s = now_s
            return default
        return min(self.config.reduced_budget, default)

    def interval_s(self, pair: tuple[str, str]) -> float:
        """Current backoff interval for a pair (base if never seen)."""
        st = self._pairs.get(pair)
        return st.interval_s if st is not None else self.config.base_interval_s

    def stats(self) -> dict[str, int]:
        return {
            "backoffs": sum(s.backoffs for s in self._pairs.values()),
            "resets": sum(s.resets for s in self._pairs.values()),
        }
