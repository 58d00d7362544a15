"""Rule families — importing this package registers every rule."""

from repro_torch.analysis.rules import (  # noqa: F401
    determinism,
    interprocedural,
    kernel_contract,
    locks,
    meta,
    parity,
    tracing,
    units,
)
