"""Rule protocol, violation record, and the rule registry.

A rule is a named check over one parsed module (``scope="module"``) or over
the whole scanned corpus at once (``scope="corpus"``, for cross-file
contracts like the kernel/oracle/parity-test triangle).  Rules register
themselves at import time via :func:`register`; the engine instantiates the
registry once per run and applies each rule to the files its path scope
selects (see ``config.py``).

Suppressions: a violation whose source line carries
``# repro-lint: disable=RULE -- reason`` is reported as *suppressed* and
does not fail the run.  The reason string is mandatory — a bare
``disable=`` with no ``-- reason`` is itself a violation (``SUP001``), so
every escape hatch in the tree documents why it is safe.
"""

from __future__ import annotations

import dataclasses
import typing

if typing.TYPE_CHECKING:  # pragma: no cover - import cycle guard
    from repro_torch.analysis.astutil import ModuleInfo
    from repro_torch.analysis.engine import Corpus


@dataclasses.dataclass(frozen=True)
class Violation:
    """One finding, anchored to a file position."""

    rule: str
    path: str  # posix path relative to the analysis root
    line: int  # 1-indexed; 0 = whole-file finding
    col: int
    message: str
    suppressed: bool = False
    suppress_reason: str | None = None

    def format(self) -> str:
        tag = " (suppressed: %s)" % self.suppress_reason if self.suppressed else ""
        return f"{self.path}:{self.line}:{self.col}: {self.rule} {self.message}{tag}"

    def to_json(self) -> dict:
        return dataclasses.asdict(self)


class Rule:
    """Base class for all checks.

    Subclasses set ``rule_id`` (stable, used in suppressions and scoping),
    ``family`` (scoping key: determinism / locks / kernel-contract /
    tracing / meta), ``summary`` (one line for ``--list-rules`` and docs)
    and implement :meth:`check` (module rules) or :meth:`check_corpus`
    (corpus rules).
    """

    rule_id: str = ""
    family: str = ""
    summary: str = ""
    scope: str = "module"  # "module" | "corpus"

    def check(self, module: "ModuleInfo") -> list[Violation]:
        raise NotImplementedError

    def check_corpus(self, corpus: "Corpus") -> list[Violation]:
        raise NotImplementedError


REGISTRY: dict[str, type[Rule]] = {}


def register(cls: type[Rule]) -> type[Rule]:
    """Class decorator adding a rule to the global registry."""
    if not cls.rule_id:
        raise ValueError(f"rule {cls.__name__} has no rule_id")
    if cls.rule_id in REGISTRY:
        raise ValueError(f"duplicate rule id {cls.rule_id}")
    REGISTRY[cls.rule_id] = cls
    return cls


def all_rules() -> list[Rule]:
    """Fresh instances of every registered rule, sorted by id."""
    # Import for side effect: rule modules self-register on first use.
    from repro_torch.analysis import rules as _rules  # noqa: F401

    return [REGISTRY[k]() for k in sorted(REGISTRY)]
