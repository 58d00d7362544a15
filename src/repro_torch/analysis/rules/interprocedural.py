"""Interprocedural determinism rules (DET101-DET104).

The local DET rules flag effects written *directly* in sim-path modules; a
wall-clock read wrapped one helper deep escapes them.  These rules run the
corpus dataflow (``repro_torch.analysis.dataflow``) and flag the **boundary call
site**: a call in a determinism-scoped module whose callee lives *outside*
the determinism scope and whose effect summary is tainted.  Flagging only
at the boundary means exactly one finding per taint entering the sim path
— effects originating unsuppressed inside the sim path are already the
local rules' findings, and deeper frames of the chain are reported in the
witness, not as extra violations.

Suppression note: suppressing the effect at its *origin* line (e.g. the
documented ``fit_seconds`` wall-clock in ``core/offline.py``) removes it
from every summary, so reasoned escape hatches do not taint their callers.
A boundary call site itself can also be suppressed with the DET10x id.
"""

from __future__ import annotations

from repro_torch.analysis.base import Rule, Violation, register
from repro_torch.analysis.dataflow import (
    GLOBAL_MUT,
    SET_ORDER,
    UNSEEDED_RNG,
    WALL_CLOCK,
)


class _TaintBoundaryRule(Rule):
    family = "determinism"
    scope = "corpus"
    effect = ""
    noun = ""  # human name of the effect for messages
    advice = ""

    def check_corpus(self, corpus) -> list[Violation]:
        df = corpus.dataflow()
        det = corpus.config.scope_for("determinism")
        out: list[Violation] = []
        for qual in sorted(df.functions):
            fn = df.functions[qual]
            if not det.matches(fn.rel):
                continue
            for cs in fn.calls:
                callee = df.functions.get(cs.callee)
                if callee is None or det.matches(callee.rel):
                    continue  # in-scope callees are the local rules' beat
                taint = df.taint(cs.callee, self.effect)
                if taint is None:
                    continue
                chain = " -> ".join(q.rsplit(".", 1)[-1] for q in taint.chain)
                out.append(Violation(
                    self.rule_id, fn.rel, cs.line, cs.col,
                    f"call into `{cs.callee}` reaches {self.noun} "
                    f"`{taint.detail}` ({taint.rel}:{taint.line}, "
                    f"via {chain}): {self.advice}",
                ))
        return out


@register
class WallClockTaintRule(_TaintBoundaryRule):
    rule_id = "DET101"
    summary = ("no call chain out of the sim path may reach a wall-clock "
               "read (interprocedural DET001)")
    effect = WALL_CLOCK
    noun = "wall-clock read"
    advice = ("sim-path behaviour must be a pure function of seeds and "
              "simulated time, even through helpers — plumb now_s/clock_s "
              "instead")


@register
class RngTaintRule(_TaintBoundaryRule):
    rule_id = "DET102"
    summary = ("no call chain out of the sim path may reach unseeded RNG "
               "(interprocedural DET002)")
    effect = UNSEEDED_RNG
    noun = "unseeded RNG"
    advice = ("every RNG stream a sim-path run consumes must be seeded — "
              "pass a seed or Generator down the chain")


@register
class GlobalMutationTaintRule(_TaintBoundaryRule):
    rule_id = "DET103"
    summary = ("no call chain out of the sim path may mutate module-level "
               "state (cross-run leakage)")
    effect = GLOBAL_MUT
    noun = "module-level state mutation"
    advice = ("module-level state written by helpers leaks between runs "
              "and across threads — thread explicit state through instead")


@register
class SetOrderTaintRule(_TaintBoundaryRule):
    rule_id = "DET104"
    summary = ("no call chain out of the sim path may depend on set "
               "iteration order (interprocedural DET003)")
    effect = SET_ORDER
    noun = "set-order iteration"
    advice = ("hash-order iteration in a helper breaks trace determinism "
              "just as surely as in sim code — sort before iterating")
