"""Static analysis for the PyTorch port's determinism, lock-discipline,
kernel-contract, and capture-tracing invariants (``repro.analysis``,
pointed at ``src/repro_torch/``).

The scenario matrix (``repro_torch.testing``) asserts bit-identical
canonical traces; every guarantee behind that assertion used to be a
convention.  This package proves the conventions hold on every commit:

* **determinism** (DET*): no wall-clock, no unseeded RNG, no set-order
  iteration, no ``id()`` ordering in sim-path modules;
* **locks** (LOCK*): ``# guarded-by:`` field tags checked against actual
  ``with lock:`` enclosure;
* **kernel-contract** (KER*): every CUDA kernel module has its dispatch in
  ``kernels/ops.py``, a plain twin in ``kernels/ref.py`` and a parity test;
* **tracing** (TRACE*): no host read of a tensor's value and no Python
  state mutation inside a function a CUDA graph or ``torch.compile``
  captures;
* **meta** (SUP*): suppressions carry reasons.

Run ``python -m repro_torch.analysis src/repro_torch`` from the repo root,
or call :func:`run_analysis`.  Suppress a finding with
``# repro-lint: disable=RULE -- reason`` on the flagged line.
"""

from repro_torch.analysis.base import REGISTRY, Rule, Violation, all_rules
from repro_torch.analysis.config import (
    AnalysisConfig,
    KernelContractConfig,
    Scope,
    default_config,
    permissive_config,
)
from repro_torch.analysis.engine import AnalysisResult, run_analysis

__all__ = [
    "AnalysisConfig",
    "AnalysisResult",
    "KernelContractConfig",
    "REGISTRY",
    "Rule",
    "Scope",
    "Violation",
    "all_rules",
    "default_config",
    "permissive_config",
    "run_analysis",
]
