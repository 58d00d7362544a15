"""Per-family path scoping and the corpus layout of the kernel contract,
pointed at the PyTorch port (``src/repro_torch/``).

Scoping is prefix-based over posix paths relative to the analysis root
(the repo root in CI and the tier-1 self-scan).  The defaults encode the
port's layout and the reference's failure history:

* **determinism** rules cover the simulation path — every module whose
  output feeds a canonical trace or a ``FleetReport`` — and deliberately
  exclude the wall-clock-legitimate packages (``benchmarks/``,
  ``train/``, ``launch/``: real timing is their job).
* **locks** rules are annotation-driven (they fire only where a
  ``# guarded-by:`` tag exists), so they scope to all of ``src``.
* **kernel-contract** rules read a fixed corpus: the CUDA kernel
  modules and their sources, the plain twins' module, the dispatch module,
  and the test files that hold the kernels to their twins.
* **tracing** rules cover the whole port: a function captured by a CUDA
  graph or ``torch.compile`` may sit anywhere in it.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Scope:
    """Path prefixes a rule family applies to (exclude wins over include)."""

    include: tuple[str, ...]
    exclude: tuple[str, ...] = ()

    def matches(self, rel: str) -> bool:
        if any(rel == e or rel.startswith(e) for e in self.exclude):
            return False
        return any(rel == i or rel.startswith(i) for i in self.include)


@dataclasses.dataclass(frozen=True)
class KernelContractConfig:
    """File layout of the kernel/twin/dispatch/parity-test contract."""

    kernels_dir: str = "src/repro_torch/kernels"
    # the CUDA sources a kernel module builds (``_build.load("<name>")``)
    csrc_dir: str = "src/repro_torch/kernels/csrc"
    ops_module: str = "src/repro_torch/kernels/ops.py"
    ref_module: str = "src/repro_torch/kernels/ref.py"
    # Parity tests must live in the files that hold the kernels to their
    # twins on the card — a passing test elsewhere does not keep
    # kernel/twin drift attributable.
    test_files: tuple[str, ...] = ("tests/test_torch_kernels.py",
                                   "tests/test_torch_lm_kernels.py",
                                   "tests/test_torch_rwkv.py")
    # Infrastructure modules in kernels_dir that are not kernels themselves.
    non_kernel_modules: tuple[str, ...] = ("__init__.py", "ops.py", "ref.py",
                                           "_build.py")


@dataclasses.dataclass(frozen=True)
class ParityConfig:
    """Layout of the dual-engine parity contract (PAR* rules): the
    canonical module holding the shared aggregation functions, the engine
    modules required to route through them, and the prefix under which
    drift copies are hunted."""

    canonical_module: str = "src/repro_torch/core/fleet.py"
    engine_modules: tuple[str, ...] = (
        "src/repro_torch/core/fleet.py",
        "src/repro_torch/core/engine/vectorized.py",
        "src/repro_torch/core/engine/sharded.py",
    )
    shared_functions: tuple[str, ...] = (
        "predict_demands",
        "auto_concurrency",
        "single_tenant_optimum",
        "assemble_fleet_report",
    )
    #: The funnel every engine's run path must actually call.
    required_calls: tuple[str, ...] = ("assemble_fleet_report",)
    watch_prefix: str = "src/"


@dataclasses.dataclass(frozen=True)
class AnalysisConfig:
    scopes: dict = dataclasses.field(default_factory=dict)
    kernel_contract: KernelContractConfig = dataclasses.field(
        default_factory=KernelContractConfig
    )
    parity: ParityConfig = dataclasses.field(default_factory=ParityConfig)

    def scope_for(self, family: str) -> Scope:
        return self.scopes.get(family, Scope(include=("",)))  # default: all


#: The sim path: modules whose behaviour must be a pure function of seeds
#: and simulated time.  Wall-clock admission races, unseeded refit regions
#: and stale shared-link intervals were all runtime manifestations of
#: conventions these prefixes now have checked statically.
SIM_PATH = (
    "src/repro_torch/core/",
    "src/repro_torch/netsim/",
    "src/repro_torch/testing/",
)

#: Where a function may be captured (CUDA graphs, ``torch.compile``): a host
#: read of a tensor's value, or a Python-state write, inside one runs once
#: at capture, not per replay.  Nothing in the port captures yet; the decode
#: step's CUDA graph will.
TRACED_PATH = ("src/repro_torch/",)


def default_config() -> AnalysisConfig:
    return AnalysisConfig(
        scopes={
            "determinism": Scope(include=SIM_PATH),
            "locks": Scope(include=("src/",)),
            "tracing": Scope(include=TRACED_PATH),
            # the suffix convention is load-bearing where the transfer math
            # lives; CLI/launch glue may name things loosely
            "units": Scope(include=("src/repro_torch/core/",
                                    "src/repro_torch/netsim/")),
            # meta rules (suppression hygiene) apply wherever suppressions do
            "meta": Scope(include=("src/", "tests/", "benchmarks/")),
        },
        kernel_contract=KernelContractConfig(),
        parity=ParityConfig(),
    )


def permissive_config() -> AnalysisConfig:
    """Everything in scope — used by fixture tests and ad-hoc CLI runs on
    out-of-tree files."""
    return AnalysisConfig(scopes={}, kernel_contract=KernelContractConfig())
