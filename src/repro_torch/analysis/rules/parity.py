"""Dual-engine parity contract (PAR001-PAR003).

The bit-exactness between the threaded ``FleetScheduler`` and the
``VectorizedFleetEngine`` rests on one discipline: every float aggregation
both engines perform routes through the *same* module-level functions in
``core/fleet.py`` (``predict_demands``, ``auto_concurrency``,
``single_tenant_optimum``, ``assemble_fleet_report``), so the float-op
order cannot drift between the two implementations.  These corpus rules
make the discipline structural:

* **PAR001** — every configured engine module must actually call
  ``assemble_fleet_report`` (the aggregation funnel); an engine that stops
  calling it has, by construction, grown its own report math;
* **PAR002** — no inline float aggregation (``np.mean`` / ``median`` /
  ``percentile`` / friends, or a builtin ``sum`` over non-count elements)
  anywhere in an engine module outside the shared functions themselves;
* **PAR003** — no module outside the canonical one may re-define a
  function bearing one of the shared names at module level (a drift copy
  waiting to diverge); delegating *methods* of the same name are fine.
"""

from __future__ import annotations

import ast

from repro_torch.analysis.base import Rule, Violation, register

#: Attribute calls that aggregate floats (np.*, statistics.*).
_AGG_ATTRS = {
    "mean", "median", "percentile", "average", "std", "var",
    "nanmean", "nanmedian", "nanpercentile", "quantile", "nanquantile",
    "fmean", "pstdev", "stdev",
}


def _shared_spans(corpus, cfg):
    """(start, end) line spans of the shared functions in the canonical
    module — code inside them IS the shared path and is exempt."""
    mod = corpus.module(cfg.canonical_module)
    spans = []
    if mod is None:
        return spans
    for node in mod.tree.body:
        if (isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef))
                and node.name in cfg.shared_functions):
            spans.append((node.lineno,
                          getattr(node, "end_lineno", None) or node.lineno))
    return spans


def _called_names(tree: ast.AST) -> set:
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Call):
            if isinstance(node.func, ast.Name):
                names.add(node.func.id)
            elif isinstance(node.func, ast.Attribute):
                names.add(node.func.attr)
    return names


def _is_count_sum(call: ast.Call) -> bool:
    """``sum(1 for ...)`` and friends count, they don't aggregate floats."""
    if not call.args:
        return True
    arg = call.args[0]
    if isinstance(arg, (ast.GeneratorExp, ast.ListComp)):
        elt = arg.elt
        return isinstance(elt, ast.Constant) and isinstance(elt.value, int)
    # sum(xs) over an opaque name: unknowable — stay conservative.
    return not isinstance(arg, (ast.GeneratorExp, ast.ListComp))


@register
class EngineFunnelRule(Rule):
    rule_id = "PAR001"
    family = "parity"
    summary = ("every engine module must route its report through "
               "assemble_fleet_report (the shared aggregation funnel)")
    scope = "corpus"

    def check_corpus(self, corpus) -> list[Violation]:
        cfg = corpus.config.parity
        out = []
        for rel in cfg.engine_modules:
            mod = corpus.module(rel)
            if mod is None:
                continue  # fixture trees without the engine layout
            missing = set(cfg.required_calls) - _called_names(mod.tree)
            for name in sorted(missing):
                out.append(Violation(
                    self.rule_id, rel, 1, 0,
                    f"engine module never calls `{name}`: both engines "
                    "must funnel their float aggregation through the "
                    "shared module-level functions in "
                    f"{cfg.canonical_module}, or their float-op order "
                    "will drift and break bit-parity",
                ))
        return out


@register
class InlineAggregationRule(Rule):
    rule_id = "PAR002"
    family = "parity"
    summary = ("no inline float aggregation in engine modules outside the "
               "shared parity functions")
    scope = "corpus"

    def check_corpus(self, corpus) -> list[Violation]:
        cfg = corpus.config.parity
        spans = _shared_spans(corpus, cfg)
        out = []
        for rel in cfg.engine_modules:
            mod = corpus.module(rel)
            if mod is None:
                continue
            exempt = spans if rel == cfg.canonical_module else []
            for node in ast.walk(mod.tree):
                if not isinstance(node, ast.Call):
                    continue
                if any(s <= node.lineno <= e for s, e in exempt):
                    continue
                agg = None
                if (isinstance(node.func, ast.Attribute)
                        and node.func.attr in _AGG_ATTRS):
                    agg = mod.dotted_name(node.func) or node.func.attr
                elif (isinstance(node.func, ast.Name)
                        and node.func.id == "sum"
                        and not _is_count_sum(node)):
                    agg = "sum"
                if agg is None:
                    continue
                out.append(Violation(
                    self.rule_id, rel, node.lineno, node.col_offset,
                    f"inline float aggregation `{agg}(...)` in an engine "
                    "module: move it into (or call) one of the shared "
                    f"parity functions ({', '.join(cfg.shared_functions)}) "
                    "so both engines share one float-op order",
                ))
        return out


@register
class DriftCopyRule(Rule):
    rule_id = "PAR003"
    family = "parity"
    summary = ("no module-level redefinition of a shared parity function "
               "outside its canonical module")
    scope = "corpus"

    def check_corpus(self, corpus) -> list[Violation]:
        cfg = corpus.config.parity
        out = []
        for rel in sorted(corpus.modules):
            if rel == cfg.canonical_module:
                continue
            if not rel.startswith(cfg.watch_prefix):
                continue
            mod = corpus.modules[rel]
            for node in mod.tree.body:
                if (isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef))
                        and node.name in cfg.shared_functions):
                    out.append(Violation(
                        self.rule_id, rel, node.lineno, node.col_offset,
                        f"module-level `{node.name}` shadows the shared "
                        f"parity function in {cfg.canonical_module}: a "
                        "drift copy will silently diverge from the "
                        "canonical float-op order — import and call the "
                        "canonical one",
                    ))
        return out
