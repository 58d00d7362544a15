"""Suppression hygiene: every escape hatch documents why it is safe."""

from __future__ import annotations

from repro_torch.analysis.astutil import ModuleInfo
from repro_torch.analysis.base import Rule, Violation, register


@register
class BareSuppressionRule(Rule):
    rule_id = "SUP001"
    family = "meta"
    summary = ("every `# repro-lint: disable=` needs a `-- reason` string "
               "(suppressions are reviewed, not waved through)")

    def check(self, module: ModuleInfo) -> list[Violation]:
        out = []
        for line, sup in sorted(module.suppressions.items()):
            if not sup.reason:
                out.append(Violation(
                    self.rule_id, module.rel, line, 0,
                    "suppression without a reason: write "
                    "`# repro-lint: disable=RULE -- why this is safe`",
                ))
        return out
