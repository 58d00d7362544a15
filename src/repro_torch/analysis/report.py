"""Human-readable and JSON reporters over an :class:`AnalysisResult`
(the reference's SARIF reporter has no consumer in the port)."""

from __future__ import annotations

import json

from repro_torch.analysis.engine import AnalysisResult


def human_report(result: AnalysisResult, *, verbose: bool = False) -> str:
    lines = []
    for v in result.violations:
        lines.append(v.format())
    if verbose:
        for v in result.suppressed:
            lines.append(v.format())
    n = len(result.violations)
    lines.append(
        f"repro_torch.analysis: {result.files_scanned} files scanned, "
        f"{n} violation{'s' if n != 1 else ''}, "
        f"{len(result.suppressed)} suppressed"
    )
    return "\n".join(lines)


def json_report(result: AnalysisResult) -> str:
    return json.dumps(result.to_json(), indent=2, sort_keys=True)
