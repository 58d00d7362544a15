"""Dataset workloads: the paper partitions transfers into small / medium /
large average-file-size classes (Sec. 4.1)."""
from __future__ import annotations

import dataclasses

import numpy as np

# (avg_file_mb_low, avg_file_mb_high, n_files_low, n_files_high)
FILE_CLASSES: dict[str, tuple[float, float, int, int]] = {
    "small": (1.0, 8.0, 400, 4000),
    "medium": (50.0, 200.0, 40, 400),
    "large": (1000.0, 10_000.0, 2, 40),
}


@dataclasses.dataclass(frozen=True)
class Dataset:
    name: str
    file_class: str
    avg_file_mb: float
    n_files: int
    # Residual MB of a recovered (killed / interrupted) session.  File-mix
    # characteristics stay those of the original dataset — the files are the
    # same, only fewer remain — while total_mb reflects exactly the MB
    # still owed, so recovery bookkeeping is MB-exact rather than rounded
    # to whole files.
    resume_mb: float | None = None

    @property
    def total_mb(self) -> float:
        if self.resume_mb is not None:
            return self.resume_mb
        return self.avg_file_mb * self.n_files

    def residual(self, moved_mb: float) -> "Dataset":
        """The dataset that remains after ``moved_mb`` MB were delivered."""
        left = max(self.total_mb - moved_mb, 0.0)
        return dataclasses.replace(self, name=self.name + "+resume",
                                   resume_mb=left)

    def sample_chunks(self, n_chunks: int) -> list[float]:
        """Split the dataset into chunk sizes (MB) for chunk-by-chunk transfer.

        The first chunks are small probes (a handful of files); the
        remainder is bulk.  Mirrors Algorithm 1's GetSamples().
        """
        probe_mb = min(max(self.avg_file_mb * 2.0, 8.0), 0.05 * self.total_mb)
        chunks = [probe_mb] * (n_chunks - 1)
        chunks.append(max(self.total_mb - sum(chunks), probe_mb))
        return chunks


def make_dataset(file_class: str, rng: np.random.Generator | int = 0,
                 name: str | None = None) -> Dataset:
    if isinstance(rng, int):
        rng = np.random.default_rng(rng)
    lo, hi, n_lo, n_hi = FILE_CLASSES[file_class]
    avg = float(np.exp(rng.uniform(np.log(lo), np.log(hi))))
    n = int(rng.integers(n_lo, n_hi + 1))
    return Dataset(name or f"{file_class}-{n}x{avg:.1f}MB", file_class, avg, n)
