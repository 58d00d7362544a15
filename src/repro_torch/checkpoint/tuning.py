"""Checkpoint-transfer tuning: the paper's pipeline pointed at real disk I/O.

Offline phase: mine the accumulated ``transfers.jsonl`` save logs (real
measurements from this machine) into throughput surfaces.  Online phase:
adaptive sampling over candidate (cc, p, pp) for the next save — probe saves
are real (small probe trees), so this is a live end-to-end instantiation of
the paper on genuine hardware (the disk/page-cache path stands in for the
WAN).  A probe tree's leaves are torch tensors, on the card or the CPU."""
from __future__ import annotations

import json

import numpy as np

from repro_torch.checkpoint.ckpt import CkptParams, save_checkpoint
from repro_torch.core.offline import OfflineDB, offline_analysis
from repro_torch.netsim.environment import ParamBounds, TransferParams
from repro_torch.netsim.loggen import LogEntry


def ckpt_bounds() -> ParamBounds:
    return ParamBounds(max_cc=16, max_p=8, max_pp=8)


def _entry_from_stats(s: dict) -> LogEntry:
    """Adapt a save-log record into the offline phase's schema."""
    avg_mb = s["bytes"] / max(s["n_arrays"], 1) / 1e6
    return LogEntry(
        src="host", dst="disk",
        bandwidth_mbps=20_000.0,            # nominal NVMe ceiling
        rtt_s=1e-4,
        avg_file_mb=max(avg_mb, 1e-3), n_files=s["n_arrays"],
        cc=s["cc"], p=s["p"], pp=s["pp"],
        throughput_mbps=s["throughput_mbps"],
        timestamp_s=float(s.get("step", 0)), ext_load=0.0)


class CheckpointTuner:
    """Tunes (cc, p, pp) for checkpoint saves from accumulated real logs."""

    def __init__(self, log_path: str, *, device=None,
                 use_kernel: bool | None = None):
        """``device``/``use_kernel``: where ``fit``'s offline phase runs
        and whether through the kernels, as ``offline_analysis`` takes
        them (None: the CUDA card; the kernels there)."""
        self.log_path = log_path
        self.device = device
        self.use_kernel = use_kernel
        self.db: OfflineDB | None = None

    def seed_history(self, tree, directory: str, *, seed: int = 0,
                     n_probes: int = 24) -> list[dict]:
        """Bootstrap: measure a spread of parameter combos with real saves."""
        rng = np.random.default_rng(seed)
        combos = {(1, 1, 1), (2, 2, 2), (4, 2, 4), (8, 2, 4), (4, 4, 4),
                  (16, 4, 4), (2, 8, 8), (8, 8, 2)}
        while len(combos) < n_probes:
            combos.add((int(rng.integers(1, 17)), int(rng.integers(1, 9)),
                        int(rng.integers(1, 9))))
        stats = []
        for i, (cc, p, pp) in enumerate(sorted(combos)):
            s = save_checkpoint(directory, 10_000 + i, tree,
                                params=CkptParams(cc, p, pp),
                                log_path=self.log_path)
            stats.append(s)
        return stats

    def fit(self) -> "CheckpointTuner":
        entries = []
        with open(self.log_path) as fh:
            for line in fh:
                entries.append(_entry_from_stats(json.loads(line)))
        # duplicate entries a little so clustering has mass
        self.db = offline_analysis(entries * max(1, 60 // max(len(entries), 1)),
                                   bounds=ckpt_bounds(), n_load_bins=2,
                                   use_kernel=self.use_kernel,
                                   device=self.device)
        return self

    def recommend(self) -> CkptParams:
        assert self.db is not None
        best, best_th = None, -1.0
        for ck in self.db.clusters:
            for s in ck.surfaces:
                if s.max_throughput > best_th:
                    best, best_th = s.argmax_params, s.max_throughput
        b = ckpt_bounds()
        prm = TransferParams(best.cc, best.p, best.pp).clip(b)
        return CkptParams(prm.cc, prm.p, prm.pp)
