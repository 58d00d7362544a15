"""The blessed fleet entry point: ``run_fleet(db, requests, config)``.

One validated :class:`EngineConfig` replaces the config sprawl that grew
across PRs 2-5 (``FleetConfig`` plus separately-threaded ``RecoveryConfig``/
``RefreshConfig``/``faults`` objects and the scheduler's loose ``z``/
``max_samples``/``bulk_chunks``/``use_kernel`` keyword tail), with an
``engine="threaded" | "vectorized"`` selector.  Both engines return the same
``FleetReport``/``SessionOutcome`` schema; the vectorized engine is
bit-identical to the threaded oracle at parity scale (see
``repro_torch.core.engine.vectorized``).

Old call sites keep working: ``run_fleet`` accepts a legacy ``FleetConfig``
and converts it (with a ``DeprecationWarning``), and ``FleetScheduler``
itself remains importable as the oracle implementation.
"""

from __future__ import annotations

import dataclasses
import warnings

from repro_torch.core.engine.sharded import ShardedFleetEngine
from repro_torch.core.engine.vectorized import VectorizedFleetEngine
from repro_torch.core.fleet import (
    FleetConfig,
    FleetReport,
    FleetRequest,
    FleetScheduler,
)
from repro_torch.core.offline import OfflineDB
from repro_torch.core.online import RecoveryConfig
from repro_torch.core.refresh import RefreshConfig

VALID_ENGINES = ("threaded", "vectorized", "sharded")
VALID_CONTENTION = ("auto", "exact", "indexed")


@dataclasses.dataclass
class EngineConfig:
    """Everything one fleet run needs, validated at construction.

    Fleet knobs (``testbed`` ... ``recovery``) carry the exact semantics of
    the legacy ``FleetConfig`` fields of the same names; sampler knobs
    (``z``, ``max_samples``, ``bulk_chunks``, ``use_kernel``) absorb the
    keyword tail that previously rode on the ``FleetScheduler`` constructor.

    ``engine`` selects the scheduler: ``"threaded"`` is the original
    thread-per-session oracle, ``"vectorized"`` the event-loop engine that
    scales to 1e5+ sessions, and ``"sharded"`` the device-sharded engine
    (per-shard event frontiers; bit-identical to the vectorized engine at
    parity scale, bulk-synchronous windows above it).  ``contention`` tunes
    the vectorized engine's shared-link bookkeeping: ``"auto"`` (default)
    is oracle-exact up to 1024 sessions and switches to the O(log N)
    indexed structure above; ``"exact"``/``"indexed"`` force either side.
    """

    engine: str = "threaded"
    testbed: str = "xsede"
    max_concurrent: int | None = None  # None = auto from batched predictions
    overcommit: float = 2.0
    reprobe_interval_s: float = 5.0
    score_vs_single: bool = True
    refresh: RefreshConfig | None = None
    faults: object | None = None  # netsim.FaultSchedule | None
    recovery: RecoveryConfig | None = None
    z: float = 2.0
    max_samples: int = 3
    bulk_chunks: int = 8
    use_kernel: bool | None = None
    contention: str = "auto"  # vectorized engine only; threaded is always exact
    # Sharded engine only.  ``n_shards=None`` resolves to the host's device
    # count at run time; ``shard_window_s`` picks the execution regime:
    # None = auto (strict frontier merge at parity scale, bulk-synchronous
    # windows above the contention cutover), 0 = force strict at any scale,
    # > 0 = force windowed with that window width.
    n_shards: int | None = None
    shard_window_s: float | None = None
    # Streaming knowledge service (core.service.KnowledgeService).  When set,
    # both engines resolve admission snapshots, fold completed sessions, and
    # ask for probe budgets through the service instead of the raw-DB +
    # refresher plumbing; it supersedes ``refresh`` (setting both is an
    # error).  None (the default) keeps the legacy path bit-identical.
    knowledge: object | None = None

    def __post_init__(self):
        self.validate()

    def validate(self) -> None:
        if self.engine not in VALID_ENGINES:
            raise ValueError(
                f"unknown engine {self.engine!r}; valid engines: "
                f"{', '.join(VALID_ENGINES)}"
            )
        if self.contention not in VALID_CONTENTION:
            raise ValueError(
                f"unknown contention mode {self.contention!r}; valid modes: "
                f"{', '.join(VALID_CONTENTION)}"
            )
        if self.n_shards is not None and self.n_shards < 1:
            raise ValueError(
                "n_shards must be >= 1 or None (host device count), "
                f"got {self.n_shards}"
            )
        if self.shard_window_s is not None and self.shard_window_s < 0.0:
            raise ValueError(
                "shard_window_s must be >= 0 (0 forces the strict regime) "
                f"or None (auto), got {self.shard_window_s}"
            )
        if self.engine != "sharded" and (
            self.n_shards is not None or self.shard_window_s is not None
        ):
            raise ValueError(
                "n_shards/shard_window_s only apply to engine='sharded'"
            )
        if self.max_concurrent is not None and self.max_concurrent <= 0:
            raise ValueError(
                "max_concurrent must be positive or None (auto), "
                f"got {self.max_concurrent}"
            )
        if self.knowledge is not None:
            from repro_torch.core.service.api import KnowledgeService

            if not isinstance(self.knowledge, KnowledgeService):
                raise TypeError(
                    "knowledge must be a KnowledgeService or None, "
                    f"got {type(self.knowledge).__name__}"
                )
            if self.refresh is not None:
                raise ValueError(
                    "knowledge and refresh are mutually exclusive: the "
                    "service's own ServiceConfig governs how completed "
                    "sessions fold back into the DB"
                )
        if self.recovery is not None and self.faults is None:
            warnings.warn(
                "EngineConfig: recovery is configured but faults is None — "
                "no session can be killed, so the recovery re-admission "
                "layer will never trigger",
                UserWarning,
                stacklevel=3,
            )

    # ---------------- legacy interop ---------------- #
    @classmethod
    def from_fleet_config(
        cls,
        config: FleetConfig,
        *,
        engine: str = "threaded",
        z: float = 2.0,
        max_samples: int = 3,
        bulk_chunks: int = 8,
        use_kernel: bool | None = None,
    ) -> "EngineConfig":
        """Fold a legacy ``FleetConfig`` (+ scheduler keywords) into an
        ``EngineConfig`` — the shim ``run_fleet`` uses for old call sites."""
        with warnings.catch_warnings():
            # The legacy config could silently carry recovery-without-faults;
            # conversion preserves behaviour, the new validation only warns
            # on directly-constructed EngineConfigs.
            warnings.simplefilter("ignore", UserWarning)
            return cls(
                engine=engine,
                testbed=config.testbed,
                max_concurrent=config.max_concurrent,
                overcommit=config.overcommit,
                reprobe_interval_s=config.reprobe_interval_s,
                score_vs_single=config.score_vs_single,
                refresh=config.refresh,
                faults=config.faults,
                recovery=config.recovery,
                z=z,
                max_samples=max_samples,
                bulk_chunks=bulk_chunks,
                use_kernel=use_kernel,
            )

    def to_fleet_config(self) -> FleetConfig:
        """The legacy fleet-knob subset (what ``FleetScheduler`` consumes)."""
        return FleetConfig(
            testbed=self.testbed,
            max_concurrent=self.max_concurrent,
            overcommit=self.overcommit,
            reprobe_interval_s=self.reprobe_interval_s,
            score_vs_single=self.score_vs_single,
            refresh=self.refresh,
            faults=self.faults,
            recovery=self.recovery,
        )


def run_fleet(
    db: OfflineDB,
    requests: list[FleetRequest],
    config: EngineConfig | FleetConfig | None = None,
) -> FleetReport:
    """Run one fleet of transfer requests and return its ``FleetReport``.

    The single blessed entry point: picks the engine from
    ``config.engine`` (default ``EngineConfig()``, i.e. threaded).  A legacy
    ``FleetConfig`` is accepted for migration and converted in place with a
    ``DeprecationWarning``.
    """
    if config is None:
        config = EngineConfig()
    elif isinstance(config, FleetConfig):
        warnings.warn(
            "passing FleetConfig to run_fleet is deprecated; construct an "
            "EngineConfig (repro_torch.core.engine.EngineConfig) instead",
            DeprecationWarning,
            stacklevel=2,
        )
        config = EngineConfig.from_fleet_config(config)
    elif not isinstance(config, EngineConfig):
        raise TypeError(
            "config must be EngineConfig, FleetConfig, or None, "
            f"got {type(config).__name__}"
        )
    if config.engine == "sharded":
        return ShardedFleetEngine(db, config).run(requests)
    if config.engine == "vectorized":
        return VectorizedFleetEngine(db, config).run(requests)
    return FleetScheduler(
        db,
        z=config.z,
        max_samples=config.max_samples,
        bulk_chunks=config.bulk_chunks,
        config=config.to_fleet_config(),
        use_kernel=config.use_kernel,
        knowledge=config.knowledge,
    ).run(requests)
