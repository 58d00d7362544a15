"""Discovery and orchestration: parse once, run every scoped rule, apply
suppressions, and fold the findings into one :class:`AnalysisResult`."""

from __future__ import annotations

import ast
import dataclasses
from pathlib import Path

from repro_torch.analysis.astutil import ModuleInfo, parse_module
from repro_torch.analysis.base import Rule, Violation, all_rules
from repro_torch.analysis.config import AnalysisConfig, default_config

_SKIP_DIRS = {"__pycache__", ".git", ".venv", "node_modules"}


@dataclasses.dataclass
class Corpus:
    """Everything a corpus-scoped rule may need: the scanned modules plus
    the fixed contract files (ops / ref / parity tests), parsed on demand
    even when they fall outside the scanned paths."""

    root: Path
    modules: dict[str, ModuleInfo]  # rel posix path -> parsed module
    config: AnalysisConfig
    cache_data: dict | None = None  # prior dataflow facts (content-addressed)
    _dataflow: object = dataclasses.field(default=None, repr=False)

    def dataflow(self):
        """The corpus call graph + effect summaries, built lazily and
        memoized so every interprocedural rule shares one fixpoint."""
        if self._dataflow is None:
            from repro_torch.analysis.dataflow import build_dataflow

            self._dataflow = build_dataflow(self, cache=self.cache_data)
        return self._dataflow

    def module(self, rel: str) -> ModuleInfo | None:
        """The parsed module at ``rel``, loading it from the root if the
        scan did not already cover it.  None when absent or unparseable."""
        if rel in self.modules:
            return self.modules[rel]
        path = self.root / rel
        if not path.is_file():
            return None
        try:
            mod = parse_module(path, self.root)
        except SyntaxError:
            return None
        self.modules[rel] = mod
        return mod


@dataclasses.dataclass
class AnalysisResult:
    violations: list[Violation]  # unsuppressed findings (fail the run)
    suppressed: list[Violation]
    files_scanned: int

    @property
    def ok(self) -> bool:
        return not self.violations

    def to_json(self) -> dict:
        return {
            "ok": self.ok,
            "files_scanned": self.files_scanned,
            "violations": [v.to_json() for v in self.violations],
            "suppressed": [v.to_json() for v in self.suppressed],
        }


def discover(paths: list[Path]) -> list[Path]:
    out: list[Path] = []
    for p in paths:
        if p.is_file() and p.suffix == ".py":
            out.append(p)
        elif p.is_dir():
            for f in sorted(p.rglob("*.py")):
                if not any(part in _SKIP_DIRS for part in f.parts):
                    out.append(f)
    return out


def _apply_suppressions(
    module: ModuleInfo, found: list[Violation]
) -> tuple[list[Violation], list[Violation]]:
    live: list[Violation] = []
    quiet: list[Violation] = []
    for v in found:
        sup = module.suppressions.get(v.line)
        # SUP001 (bare suppression) cannot be suppressed by the very
        # comment it flags — reasons are the one non-negotiable.
        if sup is not None and v.rule != "SUP001" and sup.covers(v.rule):
            sup.used = True
            quiet.append(
                dataclasses.replace(v, suppressed=True, suppress_reason=sup.reason)
            )
        else:
            live.append(v)
    return live, quiet


def run_analysis(
    paths: list[Path | str],
    *,
    root: Path | str | None = None,
    config: AnalysisConfig | None = None,
    rule_ids: set[str] | None = None,
    report_rels: set[str] | None = None,
    cache_path: Path | str | None = None,
) -> AnalysisResult:
    """Run every registered rule over ``paths``.

    ``root`` anchors the relative paths that scoping and the kernel-contract
    corpus use; it defaults to the current directory, which is the repo root
    for CI and tier-1 invocations.  ``rule_ids`` restricts the run to a
    subset of rules (CLI ``--rules``).

    ``report_rels`` filters the *report*, not the analysis: the whole
    corpus is still parsed and propagated (interprocedural findings need
    cross-file context), but only violations anchored in the given rel
    paths are returned — the ``--changed`` fast path.

    ``cache_path`` round-trips the per-file dataflow facts (JSON,
    content-addressed by source sha256) so repeat runs and sibling CI jobs
    skip local fact extraction for unchanged files.
    """
    root = Path(root) if root is not None else Path.cwd()
    config = config or default_config()
    rules = [r for r in all_rules() if rule_ids is None or r.rule_id in rule_ids]

    violations: list[Violation] = []
    suppressed: list[Violation] = []
    modules: dict[str, ModuleInfo] = {}
    for path in discover([Path(p) for p in paths]):
        try:
            mod = parse_module(path, root)
        except SyntaxError as e:
            violations.append(
                Violation("PARSE", str(path), e.lineno or 0, 0,
                          f"syntax error: {e.msg}")
            )
            continue
        modules[mod.rel] = mod

    cache_data = None
    if cache_path is not None:
        from repro_torch.analysis.dataflow import load_cache

        cache_data = load_cache(Path(cache_path))
    corpus = Corpus(root=root, modules=dict(modules), config=config,
                    cache_data=cache_data)
    for rule in rules:
        scope = config.scope_for(rule.family)
        if rule.scope == "corpus":
            found = rule.check_corpus(corpus)
            by_rel: dict[str, list[Violation]] = {}
            for v in found:
                by_rel.setdefault(v.path, []).append(v)
            for rel, vs in by_rel.items():
                mod = corpus.modules.get(rel)
                if mod is None:
                    violations.extend(vs)
                    continue
                live, quiet = _apply_suppressions(mod, vs)
                violations.extend(live)
                suppressed.extend(quiet)
            continue
        for rel in sorted(modules):
            if not scope.matches(rel):
                continue
            live, quiet = _apply_suppressions(modules[rel], rule.check(modules[rel]))
            violations.extend(live)
            suppressed.extend(quiet)

    if cache_path is not None:
        from repro_torch.analysis.dataflow import save_cache

        save_cache(Path(cache_path), corpus.dataflow())

    if report_rels is not None:
        violations = [v for v in violations if v.path in report_rels]
        suppressed = [v for v in suppressed if v.path in report_rels]

    key = lambda v: (v.path, v.line, v.col, v.rule)  # noqa: E731
    violations.sort(key=key)
    suppressed.sort(key=key)
    return AnalysisResult(violations, suppressed, files_scanned=len(modules))


def iter_functions(tree: ast.AST):
    """Every (async) function definition in a tree, in source order."""
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            yield node
