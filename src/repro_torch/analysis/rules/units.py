"""Units-of-measure flow checks (UNIT001-UNIT003) over the suffix
convention the transfer math lives by: ``_s`` seconds, ``_mb`` megabytes,
``_gb`` gigabytes, ``_mbit``/``_gbit`` megabits/gigabits, ``_mbps``/
``_gbps`` megabits-per-second.

The checker is deliberately conservative: it only assigns a unit to an
expression it can fully justify (suffixed names and attributes, the
``* 8.0`` bytes->bits idiom, products/quotients of known units) and only
flags when *both* sides of an operation carry known, incompatible units.
Unknown stays unknown — a plain ``rate`` never fires anything.

The three rules:

* **UNIT001** — adding/subtracting/comparing incompatible units
  (``dur_s + rate_mbps``, ``moved_mb - moved_mbit``);
* **UNIT002** — binding an expression of unit X to a suffix-Y name:
  assignments, dataclass field defaults, ``return`` against the function
  name's suffix, and keyword arguments (``LinkSpec(bandwidth_mbps=rtt_s)``);
* **UNIT003** — dividing megabytes (or gigabytes) by Mbps without the
  ``* 8`` bits factor, the classic goodput bug: ``size_mb / rate_mbps``
  is off by 8x, and the result silently lands in a ``_s`` name.

The algebra knows the repo's conversion idioms: ``mb * 8 -> mbit``,
``mbit / 8 -> mb``, ``mbps * s -> mbit``, ``mbit / s -> mbps``,
``mbit / mbps -> s``; ``mb / s`` yields the distinct pseudo-unit
``mb/s`` so binding it to a ``_mbps`` name is flagged as a missing
bits factor rather than silently accepted.
"""

from __future__ import annotations

import ast

from repro_torch.analysis.astutil import ModuleInfo
from repro_torch.analysis.base import Rule, Violation, register

#: suffix -> unit, longest-first so ``_mbps`` wins over ``_s``-style ties.
SUFFIX_UNITS = (
    ("_mbps", "mbps"),
    ("_gbps", "gbps"),
    ("_mbit", "mbit"),
    ("_gbit", "gbit"),
    ("_mb", "mb"),
    ("_gb", "gb"),
    ("_s", "s"),
)

#: ``x * 8`` / ``x / 8`` is the bytes<->bits conversion idiom.
_BITS_FACTOR = (8, 8.0)

#: unit pairs with defined products / quotients
_MULT = {
    frozenset(("mbps", "s")): "mbit",
    frozenset(("gbps", "s")): "gbit",
}
_DIV = {
    ("mbit", "mbps"): "s",
    ("gbit", "gbps"): "s",
    ("mbit", "s"): "mbps",
    ("gbit", "s"): "gbps",
    ("mb", "s"): "mb/s",
    ("gb", "s"): "gb/s",
}
_TIMES_EIGHT = {"mb": "mbit", "gb": "gbit"}
_OVER_EIGHT = {"mbit": "mb", "gbit": "gb"}

#: Order-preserving wrappers: the unit flows through the arguments.
_JOIN_CALLS = {"max", "min", "abs", "float", "round", "sorted"}
_JOIN_ATTRS = {"maximum", "minimum", "clip", "asarray", "abs"}


def suffix_unit(name: str) -> str | None:
    for suffix, unit in SUFFIX_UNITS:
        if name.endswith(suffix):
            return unit
    return None


def _is_bits_factor(node: ast.AST) -> bool:
    return isinstance(node, ast.Constant) and type(node.value) in (int, float) \
        and node.value in _BITS_FACTOR


def _is_plain_const(node: ast.AST) -> bool:
    return isinstance(node, ast.Constant) and type(node.value) in (int, float)


class _UnitWalker:
    """Infers units bottom-up, reporting UNIT001/UNIT003 conflicts it
    proves along the way through ``emit`` (deduped by node position)."""

    def __init__(self, emit):
        self.emit = emit

    # ------------------------------------------------------------------ #
    def unit_of(self, node: ast.AST) -> str | None:
        if isinstance(node, ast.Name):
            return suffix_unit(node.id)
        if isinstance(node, ast.Attribute):
            return suffix_unit(node.attr)
        if isinstance(node, ast.BinOp):
            return self._binop(node)
        if isinstance(node, ast.UnaryOp):
            return self.unit_of(node.operand)
        if isinstance(node, ast.IfExp):
            a, b = self.unit_of(node.body), self.unit_of(node.orelse)
            return a if a == b else None
        if isinstance(node, ast.Call):
            return self._call(node)
        if isinstance(node, ast.Starred):
            return self.unit_of(node.value)
        return None

    # ------------------------------------------------------------------ #
    def _join_args(self, node: ast.Call) -> str | None:
        units = [u for u in (self.unit_of(a) for a in node.args)
                 if u is not None]
        distinct = sorted(set(units))
        if len(distinct) > 1:
            self.emit("UNIT001", node,
                      f"mixing units {', '.join(distinct)} in one "
                      f"comparison/reduction — pick one unit first")
            return None
        return distinct[0] if distinct else None

    def _call(self, node: ast.Call) -> str | None:
        func = node.func
        if isinstance(func, ast.Name):
            if func.id in _JOIN_CALLS:
                return self._join_args(node)
            return suffix_unit(func.id)  # xfer_time_s(...) returns seconds
        if isinstance(func, ast.Attribute):
            if func.attr in _JOIN_ATTRS:
                return self._join_args(node)
            return suffix_unit(func.attr)
        return None

    # ------------------------------------------------------------------ #
    def _binop(self, node: ast.BinOp) -> str | None:
        lu, ru = self.unit_of(node.left), self.unit_of(node.right)
        if isinstance(node.op, (ast.Add, ast.Sub)):
            if lu is not None and ru is not None and lu != ru:
                self.emit("UNIT001", node,
                          f"adding/subtracting `{lu}` and `{ru}` — "
                          "incompatible units")
                return None
            return lu if lu is not None else ru
        if isinstance(node.op, ast.Mult):
            return self._mult(node, lu, ru)
        if isinstance(node.op, ast.Div):
            return self._div(node, lu, ru)
        return None

    def _mult(self, node: ast.BinOp, lu, ru) -> str | None:
        for a, b, au, bu in ((node.left, node.right, lu, ru),
                             (node.right, node.left, ru, lu)):
            if _is_bits_factor(a) and bu in _TIMES_EIGHT:
                return _TIMES_EIGHT[bu]
            if _is_plain_const(a) and bu is not None:
                return bu  # scaling by a constant keeps the unit
        if lu is not None and ru is not None:
            return _MULT.get(frozenset((lu, ru)))
        return None

    def _div(self, node: ast.BinOp, lu, ru) -> str | None:
        if _is_bits_factor(node.right) and lu in _OVER_EIGHT:
            return _OVER_EIGHT[lu]
        if _is_plain_const(node.right) and lu is not None:
            return lu
        if lu is None or ru is None:
            return None
        if lu == ru:
            return None  # dimensionless ratio
        if lu in ("mb", "gb") and ru in ("mbps", "gbps"):
            self.emit("UNIT003", node,
                      f"dividing `{lu}` by `{ru}` without the bits factor: "
                      f"the result is 8x off — convert with `* 8.0` "
                      "(bytes to bits) before dividing by a bit rate")
            return "s"  # what the author meant; avoids a cascade
        return _DIV.get((lu, ru))


@register
class UnitFlowRule(Rule):
    """UNIT001 umbrella: incompatible add/sub/compare, discovered while
    inferring units across every expression in the module."""

    rule_id = "UNIT001"
    family = "units"
    summary = ("no arithmetic or comparison mixing incompatible suffix "
               "units (_s / _mb / _mbit / _mbps ...)")

    def check(self, module: ModuleInfo) -> list[Violation]:
        return _check_module(module, emit_rules=("UNIT001",))


@register
class UnitBindingRule(Rule):
    rule_id = "UNIT002"
    family = "units"
    summary = ("no binding an expression of one unit to a name suffixed "
               "with another (assignments, returns, field defaults, "
               "keyword arguments)")

    def check(self, module: ModuleInfo) -> list[Violation]:
        return _check_module(module, emit_rules=("UNIT002",))


@register
class BitsFactorRule(Rule):
    rule_id = "UNIT003"
    family = "units"
    summary = ("no dividing megabytes/gigabytes by a bit rate without the "
               "* 8 bytes-to-bits factor")

    def check(self, module: ModuleInfo) -> list[Violation]:
        return _check_module(module, emit_rules=("UNIT003",))


#: ``mb/s`` bound to a ``_mbps`` name is the missing-factor bug wearing an
#: assignment: call it out specifically.
_RATE_MISMATCH = {("mb/s", "mbps"), ("gb/s", "gbps"),
                  ("mb/s", "gbps"), ("gb/s", "mbps")}


def _check_module(module: ModuleInfo, emit_rules) -> list[Violation]:
    found: list[Violation] = []
    seen: set = set()

    def emit(rule: str, node: ast.AST, msg: str) -> None:
        key = (rule, node.lineno, node.col_offset)
        if rule not in emit_rules or key in seen:
            return
        seen.add(key)
        found.append(Violation(rule, module.rel, node.lineno,
                               node.col_offset, msg))

    walker = _UnitWalker(emit)

    def check_binding(name: str, value: ast.AST, node: ast.AST) -> None:
        want = suffix_unit(name)
        if want is None or value is None:
            return
        got = walker.unit_of(value)
        if got is None or got == want:
            return
        if (got, want) in _RATE_MISMATCH:
            emit("UNIT002", node,
                 f"binding `{got}` to `{name}` (a `{want}` name): missing "
                 "the * 8.0 bytes-to-bits factor")
        else:
            emit("UNIT002", node,
                 f"binding a `{got}` expression to `{name}`, which the "
                 f"`_{want}`-style suffix declares as `{want}`")

    for node in ast.walk(module.tree):
        if isinstance(node, ast.Assign):
            for tgt in node.targets:
                if isinstance(tgt, ast.Name):
                    check_binding(tgt.id, node.value, node)
                elif isinstance(tgt, ast.Attribute):
                    check_binding(tgt.attr, node.value, node)
            walker.unit_of(node.value)
        elif isinstance(node, ast.AnnAssign):
            if node.value is not None:
                if isinstance(node.target, ast.Name):
                    check_binding(node.target.id, node.value, node)
                elif isinstance(node.target, ast.Attribute):
                    check_binding(node.target.attr, node.value, node)
                walker.unit_of(node.value)
        elif isinstance(node, ast.AugAssign):
            # x_s += v  behaves like  x_s = x_s + v
            if isinstance(node.op, (ast.Add, ast.Sub)):
                tname = (node.target.id if isinstance(node.target, ast.Name)
                         else node.target.attr
                         if isinstance(node.target, ast.Attribute) else None)
                want = suffix_unit(tname) if tname else None
                got = walker.unit_of(node.value)
                if want is not None and got is not None and got != want:
                    emit("UNIT001", node,
                         f"in-place adding `{got}` to `{tname}` "
                         f"(a `{want}` name) — incompatible units")
            else:
                walker.unit_of(node.value)
        elif isinstance(node, ast.Return) and node.value is not None:
            fn = module.enclosing_function(node)
            if fn is not None:
                check_binding(fn.name, node.value, node)
            walker.unit_of(node.value)
        elif isinstance(node, ast.Call):
            for kw in node.keywords:
                if kw.arg is not None:
                    check_binding(kw.arg, kw.value, kw.value)
        elif isinstance(node, ast.Compare):
            operands = [node.left] + list(node.comparators)
            units = []
            for op in operands:
                units.append(walker.unit_of(op))
            known = sorted({u for u in units if u is not None})
            if len(known) > 1:
                emit("UNIT001", node,
                     f"comparing values of units {', '.join(known)} — "
                     "incompatible units never order meaningfully")
        elif isinstance(node, ast.BinOp):
            walker.unit_of(node)

    return sorted(found, key=lambda v: (v.line, v.col, v.rule))
