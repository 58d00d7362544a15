"""``python -m repro_torch.analysis`` — the static-analysis CLI over the
PyTorch port.

Exit status: 0 when every finding is suppressed or absent, 1 on any
unsuppressed violation, 2 on usage errors.  Run from the repo root so the
default path scopes (``src/repro_torch/core/`` etc.) resolve; ``--root``
anchors them elsewhere.

``--changed`` keeps the pre-commit hook sub-second on small diffs: the
whole corpus is still parsed (interprocedural findings need cross-file
context) but the *report* is filtered to files the working tree changed —
and when no Python file changed at all, the run short-circuits before any
parsing.  The CI full scan stays the backstop for findings a changed file
induces elsewhere.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
from pathlib import Path

from repro_torch.analysis.base import all_rules
from repro_torch.analysis.config import default_config, permissive_config
from repro_torch.analysis.engine import run_analysis
from repro_torch.analysis.report import human_report, json_report

#: CI jobs share the dataflow facts through this env var (actions/cache).
CACHE_ENV = "REPRO_ANALYSIS_CACHE"


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="Determinism (local + interprocedural), units-of-"
                    "measure, dual-engine parity, lock-discipline, "
                    "kernel-contract, and capture-tracing static "
                    "analysis for the PyTorch port.",
    )
    p.add_argument("paths", nargs="*", default=["src/repro_torch"],
                   help="files or directories to scan (default: "
                        "src/repro_torch)")
    p.add_argument("--root", default=None,
                   help="repo root that path scopes are relative to "
                        "(default: current directory)")
    p.add_argument("--format", choices=("human", "json"),
                   default="human")
    p.add_argument("--out", default=None,
                   help="also write the report to this file")
    p.add_argument("--rules", default=None,
                   help="comma-separated rule ids to run (default: all)")
    p.add_argument("--no-scope", action="store_true",
                   help="ignore path scoping and apply every rule to every "
                        "scanned file (fixture / ad-hoc runs)")
    p.add_argument("--changed", action="store_true",
                   help="report only findings in files git sees as changed "
                        "(uncommitted + untracked); exits immediately when "
                        "no python file changed")
    p.add_argument("--changed-base", default=None, metavar="REF",
                   help="diff against REF instead of HEAD (implies "
                        "--changed)")
    p.add_argument("--cache", default=None, metavar="PATH",
                   help="read/write the per-file dataflow facts cache "
                        f"(default: ${CACHE_ENV} when set)")
    p.add_argument("--verbose", action="store_true",
                   help="also print suppressed findings")
    p.add_argument("--list-rules", action="store_true")
    return p


def _changed_rels(root: Path, base: str | None) -> set[str] | None:
    """Posix rel paths of changed .py files, or None when git is unusable
    (caller falls back to a full report)."""
    cmds = [
        ["git", "diff", "--name-only", base or "HEAD"],
        ["git", "ls-files", "--others", "--exclude-standard"],
    ]
    rels: set[str] = set()
    for cmd in cmds:
        try:
            proc = subprocess.run(cmd, cwd=root, capture_output=True,
                                  text=True, timeout=30)
        except (OSError, subprocess.TimeoutExpired):
            return None
        if proc.returncode != 0:
            return None
        rels.update(line.strip() for line in proc.stdout.splitlines()
                    if line.strip().endswith(".py"))
    return rels


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    if args.list_rules:
        for rule in all_rules():
            print(f"{rule.rule_id}  [{rule.family}]  {rule.summary}")
        return 0
    paths = [Path(p) for p in (args.paths or ["src/repro_torch"])]
    missing = [p for p in paths if not p.exists()]
    if missing:
        print(f"error: no such path: {', '.join(map(str, missing))}",
              file=sys.stderr)
        return 2
    rule_ids = None
    if args.rules:
        rule_ids = {r.strip() for r in args.rules.split(",") if r.strip()}
        known = {r.rule_id for r in all_rules()}
        bad = rule_ids - known
        if bad:
            print(f"error: unknown rule id(s): {', '.join(sorted(bad))}",
                  file=sys.stderr)
            return 2

    root = Path(args.root) if args.root else Path.cwd()
    report_rels = None
    if args.changed or args.changed_base:
        report_rels = _changed_rels(root, args.changed_base)
        if report_rels is not None and not report_rels:
            print("repro_torch.analysis: no changed python files")
            return 0
        if report_rels is None:
            print("repro_torch.analysis: warning: git diff unavailable, "
                  "falling back to a full report", file=sys.stderr)

    cache = args.cache or os.environ.get(CACHE_ENV) or None
    config = permissive_config() if args.no_scope else default_config()
    result = run_analysis(paths, root=args.root, config=config,
                          rule_ids=rule_ids, report_rels=report_rels,
                          cache_path=cache)
    if args.format == "json":
        report = json_report(result)
    else:
        report = human_report(result, verbose=args.verbose)
    print(report)
    if args.out:
        Path(args.out).write_text(report + "\n")
    return 0 if result.ok else 1
