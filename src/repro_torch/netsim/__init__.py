"""Simulated end-to-end transfer environments.

The paper evaluates on three real testbeds (XSEDE Stampede<->Gordon, the DIDCLAB
LAN testbed, and DIDCLAB<->XSEDE over the Internet).  This container has no WAN,
so `netsim` provides a physically-grounded throughput law
``th(cc, p, pp | bw, rtt, buffer, disk, file mix, external load)`` with diurnal
background traffic, measurement noise, and the Table-1 constants of the paper's
testbeds.  Every tuner (ours + the six baselines) runs against the same
environment through the same narrow ``Environment.transfer()`` API, so none of
them can cheat.
"""
from repro_torch.netsim.environment import (
    Environment, IndexedSharedLink, TransferParams, ParamBounds, SharedLink,
    TenantEnvironment,
)
from repro_torch.netsim.testbeds import (
    make_testbed, XSEDE, DIDCLAB, DIDCLAB_XSEDE, TESTBEDS,
)
from repro_torch.netsim.workload import Dataset, make_dataset, FILE_CLASSES
from repro_torch.netsim.traffic import DiurnalTraffic, RegimeShiftTraffic, StepTraffic
from repro_torch.netsim.faults import (
    CapacityDrop, FaultSchedule, LinkFlap, LossBurst, SessionKilled,
    TenantKill,
)
from repro_torch.netsim.loggen import (
    features_of, generate_history, generate_multi_network_history, LogEntry,
    sample_feature_logs,
)

__all__ = [
    "Environment", "IndexedSharedLink", "TransferParams", "ParamBounds",
    "SharedLink",
    "TenantEnvironment", "make_testbed", "XSEDE", "DIDCLAB", "DIDCLAB_XSEDE",
    "TESTBEDS", "Dataset", "make_dataset", "FILE_CLASSES", "DiurnalTraffic",
    "RegimeShiftTraffic", "StepTraffic", "generate_history", "LogEntry",
    "features_of", "generate_multi_network_history", "sample_feature_logs",
    "CapacityDrop", "FaultSchedule", "LinkFlap", "LossBurst", "SessionKilled",
    "TenantKill",
]
