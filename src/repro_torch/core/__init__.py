"""The paper's contribution: offline knowledge discovery over historical
transfer logs + online adaptive sampling for protocol-parameter tuning,
with the additive refit that closes the loop, and the fleet of concurrent
tuned transfers over one shared link with its knowledge service."""
from repro_torch.core.spline import TricubicSurface, PolySurface
from repro_torch.core.clustering import (
    fit_clusters, fit_clusters_batched, kmeans, hac_upgma, ch_index,
    label_agreement,
)
from repro_torch.core.contention import load_intensity, intensity_bins
from repro_torch.core.surfaces import (
    ThroughputSurface, fit_surface, surface_accuracy,
)
from repro_torch.core.maxima import find_local_maxima, integer_argmax
from repro_torch.core.regions import identify_sampling_regions, SamplingRegion
from repro_torch.core.offline import MultiNetworkDB, OfflineDB, offline_analysis
from repro_torch.core.online import (
    AdaptiveSampler, RecoveryConfig, SessionCheckpoint, TransferReport,
)
from repro_torch.core.tuner import TransferTuner, TunerConfig
from repro_torch.core.batched import SurfaceStack
from repro_torch.core.refresh import (
    ClusterStaleness, KnowledgeRefresher, MultiNetworkRefresher,
    RefreshConfig, session_log_entries,
)
from repro_torch.core.state import offline_db_from_state, offline_db_to_state
from repro_torch.core.fleet import (
    FleetConfig, FleetReport, FleetRequest, FleetScheduler, ReprobeLimiter,
    SessionOutcome,
)
from repro_torch.core.engine import (
    EngineConfig, ShardedFleetEngine, VectorEventHeap, VectorizedFleetEngine,
    run_fleet,
)
from repro_torch.core.service import (
    AdmissionDecision, KnowledgeService, ProbeBackoffConfig, ProbePolicy,
    ServiceConfig, ServiceStats, SurfaceCache,
)

__all__ = [
    "TricubicSurface", "PolySurface",
    "fit_clusters", "fit_clusters_batched", "kmeans", "hac_upgma", "ch_index",
    "label_agreement", "load_intensity", "intensity_bins",
    "ThroughputSurface", "fit_surface", "surface_accuracy",
    "find_local_maxima", "integer_argmax", "identify_sampling_regions",
    "SamplingRegion", "MultiNetworkDB", "OfflineDB", "offline_analysis",
    "AdaptiveSampler", "RecoveryConfig", "SessionCheckpoint",
    "TransferReport", "TransferTuner", "TunerConfig",
    "SurfaceStack", "ClusterStaleness", "KnowledgeRefresher",
    "MultiNetworkRefresher", "RefreshConfig", "session_log_entries",
    "offline_db_from_state", "offline_db_to_state",
    "FleetConfig", "FleetReport", "FleetRequest", "FleetScheduler",
    "ReprobeLimiter", "SessionOutcome",
    "EngineConfig", "ShardedFleetEngine", "VectorEventHeap",
    "VectorizedFleetEngine", "run_fleet",
    "AdmissionDecision", "KnowledgeService", "ProbeBackoffConfig",
    "ProbePolicy", "ServiceConfig", "ServiceStats", "SurfaceCache",
]
