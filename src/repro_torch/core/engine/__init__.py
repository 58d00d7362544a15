"""Unified fleet engines: one ``run_fleet`` facade over three schedulers.

``engine="threaded"`` is the original thread-per-session oracle
(``repro_torch.core.fleet.FleetScheduler``); ``engine="vectorized"`` is the
event-loop engine that produces bit-identical ``FleetReport``s at parity
scale and runs 1e5+ concurrent sessions (``repro_torch.core.engine.vectorized``);
``engine="sharded"`` partitions fleet slots across per-device event
frontiers — bit-identical to the vectorized engine at parity scale,
bulk-synchronous windows above it (``repro_torch.core.engine.sharded``).
"""

from repro_torch.core.engine.api import (
    VALID_CONTENTION,
    VALID_ENGINES,
    EngineConfig,
    run_fleet,
)
from repro_torch.core.engine.heap import VectorEventHeap
from repro_torch.core.engine.shard import (
    ShardedEventFrontier,
    WindowedLinkState,
)
from repro_torch.core.engine.sharded import (
    DEFAULT_SHARD_WINDOW_S,
    ShardedFleetEngine,
)
from repro_torch.core.engine.vectorized import (
    AUTO_CONTENTION_CUTOVER,
    FleetStateArrays,
    VectorizedFleetEngine,
)

__all__ = [
    "AUTO_CONTENTION_CUTOVER",
    "DEFAULT_SHARD_WINDOW_S",
    "EngineConfig",
    "FleetStateArrays",
    "ShardedEventFrontier",
    "ShardedFleetEngine",
    "VALID_CONTENTION",
    "VALID_ENGINES",
    "VectorEventHeap",
    "VectorizedFleetEngine",
    "WindowedLinkState",
    "run_fleet",
]
