"""Host input pipeline with the paper's three knobs.

  * ``cc`` — reader worker threads,
  * ``p``  — shards read per file (striped reads of one logical file),
  * ``pp`` — prefetch depth (batches queued ahead of the training step).

The source is a synthetic deterministic token generator (stands in for a
tokenized dataset on shared storage; generation cost models decode/parse
work).  Throughput logs accumulate in the same LogEntry-compatible schema
for offline tuning.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
import time

import numpy as np


@dataclasses.dataclass(frozen=True)
class PipelineParams:
    cc: int = 2
    p: int = 1
    pp: int = 2


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    global_batch: int
    seq_len: int
    n_codebooks: int = 0
    seed: int = 0


class TokenPipeline:
    """Threaded synthetic-token pipeline with prefetch."""

    def __init__(self, cfg: DataConfig, params: PipelineParams = PipelineParams()):
        self.cfg = cfg
        self.params = params
        self._q: queue.Queue = queue.Queue(maxsize=max(params.pp, 1))
        self._stop = threading.Event()
        self._seq = 0
        self._lock = threading.Lock()
        self._workers = [threading.Thread(target=self._worker, daemon=True)
                         for _ in range(max(params.cc, 1))]
        self.produced = 0
        for w in self._workers:
            w.start()

    def _gen_shard(self, idx: int, shard: int, n_rows: int) -> np.ndarray:
        rng = np.random.default_rng(
            (self.cfg.seed * 1_000_003 + idx) * 31 + shard)
        shape = (n_rows, self.cfg.seq_len)
        if self.cfg.n_codebooks:
            shape = shape + (self.cfg.n_codebooks,)
        return rng.integers(0, self.cfg.vocab_size, size=shape,
                            dtype=np.int32)

    def _worker(self):
        p = max(self.params.p, 1)
        while not self._stop.is_set():
            with self._lock:
                idx = self._seq
                self._seq += 1
            rows = self.cfg.global_batch
            per = -(-rows // p)
            shards = [self._gen_shard(idx, s, min(per, rows - s * per))
                      for s in range(p) if s * per < rows]
            tokens = np.concatenate(shards, axis=0)
            batch = {"tokens": tokens, "labels": tokens}
            while not self._stop.is_set():
                try:
                    self._q.put((idx, batch), timeout=0.1)
                    break
                except queue.Full:
                    continue

    def next_batch(self, timeout: float = 30.0) -> dict:
        _, batch = self._q.get(timeout=timeout)
        self.produced += 1
        return batch

    def measure_throughput(self, n_batches: int = 8) -> float:
        """Tokens/second over ``n_batches`` (for tuner probes)."""
        t0 = time.perf_counter()
        for _ in range(n_batches):
            self.next_batch()
        dt = time.perf_counter() - t0
        toks = n_batches * self.cfg.global_batch * self.cfg.seq_len
        return toks / max(dt, 1e-9)

    def close(self):
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
