"""GO: Globus Online's static per-file-class parameter policy [4, 5].

Globus picks fixed (cc, p, pp) by dataset file-size class, ignoring network
conditions entirely (Sec. 4: "Globus uses different static parameter settings
for different types of file sizes")."""
from __future__ import annotations

from repro_torch.core.baselines.common import BaseTuner
from repro_torch.netsim.environment import Environment, TransferParams
from repro_torch.netsim.workload import Dataset

# Globus production defaults, per the paper's description / globus-url-copy
_POLICY = {
    "small": TransferParams(cc=2, p=2, pp=8),
    "medium": TransferParams(cc=2, p=4, pp=4),
    "large": TransferParams(cc=2, p=8, pp=1),
}


class GlobusStatic(BaseTuner):
    name = "GO"

    def start(self, env: Environment, dataset: Dataset) -> TransferParams:
        return _POLICY[dataset.file_class]
