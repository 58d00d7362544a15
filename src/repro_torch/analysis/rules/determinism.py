"""Determinism rules over the simulation path.

The scenario matrix asserts bit-identical canonical traces, so every module
feeding a trace must be a pure function of seeds and simulated time.  These
rules encode the conventions whose runtime violations cost days of debugging:
wall-clock reads racing the sim clock, RNG streams nobody seeded, and
iteration orders the hash seed controls.
"""

from __future__ import annotations

import ast

from repro_torch.analysis.astutil import ModuleInfo
from repro_torch.analysis.base import Rule, Violation, register

#: Dotted call targets that read the wall clock.
WALL_CLOCK_CALLS = {
    "time.time",
    "time.time_ns",
    "time.perf_counter",
    "time.perf_counter_ns",
    "time.monotonic",
    "time.monotonic_ns",
    "time.process_time",
    "time.process_time_ns",
}

#: ``datetime``-style suffixes (the leading path varies with import form).
WALL_CLOCK_SUFFIXES = ("datetime.now", "datetime.utcnow", "datetime.today",
                      "date.today")

#: numpy module-level RNG calls — all share the global, unseedable-per-call
#: ``np.random`` state.
NP_GLOBAL_RNG = {
    "rand", "randn", "randint", "random", "random_sample", "ranf", "sample",
    "normal", "uniform", "choice", "shuffle", "permutation",
    "standard_normal", "exponential", "poisson", "beta", "gamma", "binomial",
    "seed",
}

#: stdlib ``random`` module-level sampling calls (same global-state hazard).
STDLIB_RANDOM = {
    "random", "randint", "randrange", "uniform", "gauss", "normalvariate",
    "choice", "choices", "shuffle", "sample", "betavariate", "expovariate",
    "seed",
}

#: Wrapping one of these around an unordered iterable makes the result
#: order-insensitive, so iteration inside them is fine.
ORDER_INSENSITIVE = {"sorted", "min", "max", "sum", "any", "all", "len",
                     "set", "frozenset"}


def _in_order_insensitive_call(module: ModuleInfo, node: ast.AST) -> bool:
    """True when ``node`` (an iterable or comprehension) is consumed by an
    order-insensitive reducer — e.g. ``sorted(touched)``,
    ``max(s.x for s in stales)``."""
    for anc in module.ancestors(node):
        if isinstance(anc, ast.Call) and isinstance(anc.func, ast.Name):
            if anc.func.id in ORDER_INSENSITIVE:
                return True
        if isinstance(anc, (ast.FunctionDef, ast.AsyncFunctionDef, ast.stmt)):
            # statements other than expression-statements end the search;
            # the reducer call, if any, is below them
            if not isinstance(anc, ast.Expr):
                return False
    return False


@register
class WallClockRule(Rule):
    rule_id = "DET001"
    family = "determinism"
    summary = ("no wall-clock reads (time.time / perf_counter / datetime.now)"
               " in sim-path modules")

    def check(self, module: ModuleInfo) -> list[Violation]:
        out = []
        for node in ast.walk(module.tree):
            if not isinstance(node, ast.Call):
                continue
            name = module.dotted_name(node.func)
            if name is None:
                continue
            hit = name in WALL_CLOCK_CALLS or any(
                name == s or name.endswith("." + s) for s in WALL_CLOCK_SUFFIXES
            )
            if hit:
                out.append(Violation(
                    self.rule_id, module.rel, node.lineno, node.col_offset,
                    f"wall-clock read `{name}()` in sim-path code: traces "
                    "must be pure functions of seeds and simulated time "
                    "(use env.clock_s / now_s plumbing instead)",
                ))
        return out


@register
class UnseededRngRule(Rule):
    rule_id = "DET002"
    family = "determinism"
    summary = ("no unseeded RNG: default_rng() without a seed, or global "
               "np.random.* / random.* sampling calls")

    def check(self, module: ModuleInfo) -> list[Violation]:
        out = []
        for node in ast.walk(module.tree):
            if not isinstance(node, ast.Call):
                continue
            name = module.dotted_name(node.func)
            if name is None:
                continue
            if name.endswith("random.default_rng") or name == "default_rng":
                if self._unseeded(node):
                    out.append(Violation(
                        self.rule_id, module.rel, node.lineno, node.col_offset,
                        "default_rng() without a seed draws OS entropy: "
                        "every sim-path RNG stream must be seeded "
                        "(plumb a seed parameter through)",
                    ))
                continue
            parts = name.split(".")
            if (len(parts) == 3 and parts[0] == "numpy"
                    and parts[1] == "random" and parts[2] in NP_GLOBAL_RNG):
                out.append(Violation(
                    self.rule_id, module.rel, node.lineno, node.col_offset,
                    f"global-state RNG call `{name}()`: use a seeded "
                    "np.random.default_rng(seed) Generator instead",
                ))
            elif (len(parts) == 2 and parts[0] == "random"
                    and parts[1] in STDLIB_RANDOM):
                out.append(Violation(
                    self.rule_id, module.rel, node.lineno, node.col_offset,
                    f"stdlib global RNG call `{name}()`: use a seeded "
                    "np.random.default_rng(seed) Generator instead",
                ))
        return out

    @staticmethod
    def _unseeded(call: ast.Call) -> bool:
        if call.args:
            return isinstance(call.args[0], ast.Constant) and \
                call.args[0].value is None
        for kw in call.keywords:
            if kw.arg == "seed":
                return isinstance(kw.value, ast.Constant) and \
                    kw.value.value is None
        return True


def _set_typed_names(func: ast.AST) -> dict[str, int]:
    """Local names bound to set-typed expressions within one scope
    (set literals, comprehensions, ``set()``/``frozenset()`` calls, or
    ``: set[...]`` annotations)."""
    names: dict[str, int] = {}

    def is_set_expr(expr: ast.AST | None) -> bool:
        if isinstance(expr, (ast.Set, ast.SetComp)):
            return True
        if isinstance(expr, ast.Call) and isinstance(expr.func, ast.Name):
            return expr.func.id in ("set", "frozenset")
        return False

    def is_set_annotation(ann: ast.AST | None) -> bool:
        if isinstance(ann, ast.Name):
            return ann.id in ("set", "frozenset")
        if isinstance(ann, ast.Subscript):
            return is_set_annotation(ann.value)
        if isinstance(ann, ast.Attribute):  # typing.Set
            return ann.attr in ("Set", "FrozenSet")
        return False

    for node in ast.walk(func):
        if isinstance(node, ast.Assign) and is_set_expr(node.value):
            for tgt in node.targets:
                if isinstance(tgt, ast.Name):
                    names[tgt.id] = node.lineno
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name):
            if is_set_expr(node.value) or is_set_annotation(node.annotation):
                names[node.target.id] = node.lineno
    return names


@register
class UnorderedIterationRule(Rule):
    rule_id = "DET003"
    family = "determinism"
    summary = ("no iteration over sets feeding ordered state (wrap in "
               "sorted(), or use an order-insensitive reducer)")

    def check(self, module: ModuleInfo) -> list[Violation]:
        out = []
        seen: set[tuple[int, int]] = set()
        # scopes: the module itself plus every function (a loop inside a
        # function is visited under both walks — dedupe by position)
        scopes = [module.tree] + [
            n for n in ast.walk(module.tree)
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
        ]
        for scope in scopes:
            set_names = _set_typed_names(scope)
            for node in ast.walk(scope):
                iters: list[ast.AST] = []
                if isinstance(node, ast.For):
                    iters = [node.iter]
                elif isinstance(node, (ast.ListComp, ast.SetComp, ast.DictComp,
                                       ast.GeneratorExp)):
                    iters = [g.iter for g in node.generators]
                for it in iters:
                    if not self._is_set_iter(it, set_names):
                        continue
                    if _in_order_insensitive_call(module, node):
                        continue
                    if (it.lineno, it.col_offset) in seen:
                        continue
                    seen.add((it.lineno, it.col_offset))
                    out.append(Violation(
                        self.rule_id, module.rel, it.lineno, it.col_offset,
                        "iteration over a set: order depends on hashing, "
                        "which breaks trace determinism when it feeds "
                        "ordered state — iterate `sorted(...)` instead",
                    ))
        return out

    @staticmethod
    def _is_set_iter(it: ast.AST, set_names: dict[str, int]) -> bool:
        if isinstance(it, (ast.Set, ast.SetComp)):
            return True
        if isinstance(it, ast.Call) and isinstance(it.func, ast.Name):
            return it.func.id in ("set", "frozenset")
        if isinstance(it, ast.Name):
            return it.id in set_names
        return False


@register
class IdOrderingRule(Rule):
    rule_id = "DET004"
    family = "determinism"
    summary = "no id()-based ordering or keying (addresses vary run to run)"

    def check(self, module: ModuleInfo) -> list[Violation]:
        out = []
        for node in ast.walk(module.tree):
            if (isinstance(node, ast.Call) and isinstance(node.func, ast.Name)
                    and node.func.id == "id" and len(node.args) == 1):
                out.append(Violation(
                    self.rule_id, module.rel, node.lineno, node.col_offset,
                    "id() in sim-path code: object addresses differ across "
                    "runs, so any ordering or keying built on them is "
                    "nondeterministic — use an explicit stable id",
                ))
        return out
