"""Shared baseline scaffolding: a tuner proposes parameters per chunk; the
runner executes the chunked transfer and reports whole-transfer throughput."""
from __future__ import annotations

from repro_torch.core.online import (
    SampleRecord, TransferReport, _count_param_switches,
)
from repro_torch.netsim.environment import Environment, ParamBounds, TransferParams
from repro_torch.netsim.workload import Dataset


class BaseTuner:
    """Interface: propose initial params, then react to achieved throughput."""

    name = "base"

    def __init__(self, bounds: ParamBounds = ParamBounds()):
        self.bounds = bounds

    def start(self, env: Environment, dataset: Dataset) -> TransferParams:
        raise NotImplementedError

    def observe(self, params: TransferParams, achieved: float,
                chunk_idx: int) -> TransferParams:
        """Return params for the next chunk (possibly unchanged)."""
        return params

    @property
    def n_probe_chunks(self) -> int:
        """Chunks the tuner spends probing before committing (0 = static)."""
        return 0


def run_transfer(tuner: BaseTuner, env: Environment, dataset: Dataset,
                 *, n_chunks: int = 8) -> TransferReport:
    """Chunked transfer driven by a baseline tuner."""
    t0 = env.clock_s
    records: list[SampleRecord] = []
    params = tuner.start(env, dataset).clip(tuner.bounds)
    probe = tuner.n_probe_chunks
    chunks = dataset.sample_chunks(n_chunks + probe)
    probe_mb, bulk_mb = chunks[0], sum(chunks[probe:])
    # probe phase
    for i in range(probe):
        res = env.transfer(params, probe_mb, dataset.avg_file_mb,
                           dataset.n_files, is_sample=True)
        records.append(SampleRecord(params, 0.0, res.steady_mbps, -1.0,
                                    res.elapsed_s, True))
        params = tuner.observe(params, res.steady_mbps, i).clip(tuner.bounds)
    # bulk phase
    chunk_mb = bulk_mb / n_chunks
    for i in range(n_chunks):
        res = env.transfer(params, chunk_mb, dataset.avg_file_mb,
                           dataset.n_files)
        records.append(SampleRecord(params, 0.0, res.steady_mbps, -1.0,
                                    res.elapsed_s, False))
        params = tuner.observe(params, res.steady_mbps,
                               probe + i).clip(tuner.bounds)
    total_s = env.clock_s - t0
    # Exactly the ASM report's semantics: switches the session actually paid
    # setup for (initial spawn + transitions between executed chunks); a
    # parameter change proposed by the final observe() is never spawned and
    # must not count.
    return TransferReport(params, dataset.total_mb * 8.0 / max(total_s, 1e-9),
                          records, n_samples=probe, total_s=total_s,
                          param_changes=_count_param_switches(records))
