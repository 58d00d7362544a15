"""SC: Single-Chunk heuristic tuning (Arslan, Ross & Kosar, Euro-Par'13 [9]).

Derives (cc, p, pp) from dataset and network characteristics — BDP vs. TCP
buffer for parallelism, file count vs. a user-provided concurrency cap, and
RTT-based pipelining for small files.  Network-aware but traffic- and
disk-agnostic (Sec. 4.2: "as single chunk is unaware of disk bottleneck, its
parameters become suboptimal")."""
from __future__ import annotations

import math

from repro_torch.core.baselines.common import BaseTuner
from repro_torch.netsim.environment import Environment, ParamBounds, TransferParams
from repro_torch.netsim.workload import Dataset


class SingleChunk(BaseTuner):
    name = "SC"

    def __init__(self, bounds: ParamBounds = ParamBounds(),
                 user_cc_limit: int = 10):
        super().__init__(bounds)
        self.user_cc_limit = user_cc_limit

    def start(self, env: Environment, dataset: Dataset) -> TransferParams:
        link = env.link
        bdp_mb = link.bandwidth_mbps * link.rtt_s / 8.0       # MB in flight
        # parallelism: enough streams for BDP given the TCP buffer, but no
        # more streams than the file has buffer-sized pieces
        p = max(1, math.ceil(bdp_mb / max(link.tcp_buffer_mb, 1e-6)))
        p = min(p, max(1, math.ceil(dataset.avg_file_mb / link.tcp_buffer_mb)),
                self.bounds.max_p)
        # concurrency: fill the pipe with files, capped by the user limit
        cc = min(self.user_cc_limit, dataset.n_files, self.bounds.max_cc)
        # pipelining: hide one control RTT per file; small files need depth
        if dataset.avg_file_mb < bdp_mb:
            pp = min(self.bounds.max_pp,
                     max(1, math.ceil(bdp_mb / max(dataset.avg_file_mb, 1e-3))))
        else:
            pp = 1
        return TransferParams(cc, p, pp)
