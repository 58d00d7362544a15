"""Streaming knowledge service: the serving-path face of offline knowledge.

``KnowledgeService`` unifies ``OfflineDB``/``MultiNetworkDB`` and the
refresher classes behind one facade (mirroring ``run_fleet``/``EngineConfig``)
with three serving-path capabilities the batch-cadence stack lacks:
incremental mini-batch centroid ingest with bounded-staleness forced refits,
a pre-warmed LRU admission cache answering ``query(pair, features)`` in
sub-millisecond time, and opt-in probe-rate backoff for quiescent links.
"""

from repro_torch.core.service.api import (
    DEFAULT_PAIR,
    KnowledgeService,
    ServiceConfig,
    ServiceStats,
)
from repro_torch.core.service.backoff import ProbeBackoffConfig, ProbePolicy
from repro_torch.core.service.cache import AdmissionDecision, SurfaceCache
from repro_torch.core.service.ingest import IncrementalIngestor

__all__ = [
    "DEFAULT_PAIR",
    "AdmissionDecision",
    "IncrementalIngestor",
    "KnowledgeService",
    "ProbeBackoffConfig",
    "ProbePolicy",
    "ServiceConfig",
    "ServiceStats",
    "SurfaceCache",
]
