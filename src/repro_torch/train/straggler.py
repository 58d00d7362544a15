"""Straggler detection + mitigation.

Detection: robust z-score of per-host step times against the fleet median
(MAD-scaled).  Mitigation hooks: (1) rebalance input-pipeline shards away
from slow hosts, (2) re-tune collective bucket plans (a straggling host makes
the all-reduce latency-bound: fewer, larger buckets amortize its lag), and
(3) flag hosts for eviction -> elastic re-carve when persistent.
"""
from __future__ import annotations

import dataclasses
from collections import deque

import numpy as np


@dataclasses.dataclass
class StragglerPolicy:
    z_threshold: float = 3.5        # robust z-score to flag
    window: int = 16                # step-time history window
    evict_after: int = 8            # consecutive flags before eviction


class StragglerDetector:
    def __init__(self, n_hosts: int, policy: StragglerPolicy = StragglerPolicy()):
        self.n_hosts = n_hosts
        self.policy = policy
        self.history = [deque(maxlen=policy.window) for _ in range(n_hosts)]
        self.flag_streak = np.zeros(n_hosts, np.int64)

    def record(self, step_times: np.ndarray) -> dict:
        """step_times: (n_hosts,) wall-time of this step per host."""
        for h, t in enumerate(step_times):
            self.history[h].append(float(t))
        med = np.median(step_times)
        mad = np.median(np.abs(step_times - med)) + 1e-9
        z = (step_times - med) / (1.4826 * mad)
        flagged = z > self.policy.z_threshold
        self.flag_streak = np.where(flagged, self.flag_streak + 1, 0)
        evict = np.where(self.flag_streak >= self.policy.evict_after)[0]
        return {
            "z": z, "flagged": np.where(flagged)[0],
            "evict": evict,
            "slowdown": float(step_times.max() / max(med, 1e-9)),
        }

    def shard_weights(self) -> np.ndarray:
        """Input-shard weights inversely proportional to recent host speed."""
        speeds = np.array([
            1.0 / max(np.median(h) if h else 1.0, 1e-9)
            for h in self.history])
        return speeds / speeds.sum()


def rebalance_buckets(base_buckets: int, slowdown: float) -> int:
    """Straggler mitigation on the collective schedule: when the slowest
    host lags, fewer/larger buckets cut per-bucket latency overhead."""
    if slowdown <= 1.25:
        return base_buckets
    return max(1, int(base_buckets / min(slowdown, 4.0)))
