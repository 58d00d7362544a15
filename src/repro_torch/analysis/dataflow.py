"""Interprocedural dataflow: call graph + effect summaries by fixpoint.

The local determinism rules are AST pattern matches, so a wall-clock
read or unseeded RNG wrapped one helper deep escapes them entirely.  This
module closes that hole:

* a **call graph** over every scanned module, resolved through the same
  import-alias machinery the local rules use (``ModuleInfo.dotted_name``),
  including ``self.meth()`` dispatch through class bodies and
  corpus-resolvable base classes;
* **direct effect extraction** per function — wall-clock, unseeded-RNG and
  set-order effects come from the *existing* local rules (so the two layers
  can never disagree on what counts as an effect), global-mutation effects
  from a dedicated walk over module-level state;
* **fixpoint propagation** of effects along call edges, keeping the
  shortest witness chain per (function, effect) so findings can name the
  exact path from a sim-path call site down to ``time.time()``.

A direct effect on a line carrying a covering suppression does **not**
enter the summary: ``core/offline.py``'s documented ``fit_seconds``
wall-clock reads stay local to their reasoned escape hatch instead of
tainting every caller.

Effects at module top level (import-time code) are not propagated; the
local rules still cover them inside the sim path.

Per-file facts (direct effects + unresolved call descriptors + class
tables) are content-addressed by source sha256 and serialize to JSON, so
CI can carry the artifact between jobs (``--cache``); the cross-file link
and fixpoint steps are cheap and always recomputed.
"""

from __future__ import annotations

import ast
import dataclasses
import hashlib
import json
import typing
from pathlib import Path

from repro_torch.analysis.astutil import ModuleInfo

if typing.TYPE_CHECKING:  # pragma: no cover - import cycle guard
    from repro_torch.analysis.engine import Corpus

#: Effect kinds, in severity/report order.
WALL_CLOCK = "wall-clock"
UNSEEDED_RNG = "unseeded-rng"
SET_ORDER = "set-order"
GLOBAL_MUT = "global-mutation"
EFFECTS = (WALL_CLOCK, UNSEEDED_RNG, SET_ORDER, GLOBAL_MUT)

#: Suppressing any of these rule ids on the originating line silences the
#: effect itself: the local id (what fires inside the sim path) and the
#: interprocedural id (what fires at a boundary call site) are one escape
#: hatch, not two.
EFFECT_SUPPRESS_IDS = {
    WALL_CLOCK: ("DET001", "DET101"),
    UNSEEDED_RNG: ("DET002", "DET102"),
    GLOBAL_MUT: ("DET103",),
    SET_ORDER: ("DET003", "DET104"),
}

#: Methods that mutate their receiver in place.
_MUTATORS = {
    "append", "extend", "insert", "remove", "pop", "popitem", "clear",
    "add", "discard", "update", "setdefault", "appendleft", "popleft",
}

_FACTS_VERSION = 2


# --------------------------------------------------------------------- #
# records
# --------------------------------------------------------------------- #
@dataclasses.dataclass(frozen=True)
class CallSite:
    callee: str  # resolved qualname (post-link)
    line: int
    col: int


@dataclasses.dataclass
class FunctionInfo:
    """One module-level function or class method.  Nested ``def``s fold
    into their enclosing function (their bodies almost always run when the
    enclosing function does, and splitting them would only lose witnesses).
    """

    qual: str  # e.g. repro_torch.core.fleet.FleetScheduler.run
    rel: str  # posix path of the defining module
    lineno: int
    end_lineno: int
    direct: dict  # effect -> (line, col, detail)
    calls: tuple  # tuple[CallSite, ...]


@dataclasses.dataclass(frozen=True)
class Taint:
    """One effect reaching a function: the witness chain (this function
    first, origin function last) and the originating site."""

    chain: tuple  # tuple[str, ...] of qualnames
    rel: str
    line: int
    detail: str


@dataclasses.dataclass
class Dataflow:
    functions: dict  # qual -> FunctionInfo
    summaries: dict  # qual -> {effect -> Taint}
    facts: dict  # JSON-serializable per-file facts (the cacheable artifact)

    def taint(self, qual: str, effect: str) -> Taint | None:
        return self.summaries.get(qual, {}).get(effect)


# --------------------------------------------------------------------- #
# module naming
# --------------------------------------------------------------------- #
def module_name(rel: str) -> str:
    """Dotted module name for a repo-relative posix path.

    ``src/repro_torch/core/fleet.py`` -> ``repro_torch.core.fleet`` (the
    leading ``src/`` is the import root, not a package); fixture trees
    without a ``src/`` prefix map positionally.
    """
    p = rel[:-3] if rel.endswith(".py") else rel
    parts = p.split("/")
    if parts and parts[0] == "src":
        parts = parts[1:]
    if parts and parts[-1] == "__init__":
        parts = parts[:-1]
    return ".".join(parts)


def _effect_suppressed(mod: ModuleInfo, effect: str, line: int) -> bool:
    sup = mod.suppressions.get(line)
    if sup is None:
        return False
    return any(sup.covers(rid) for rid in EFFECT_SUPPRESS_IDS[effect])


# --------------------------------------------------------------------- #
# per-module fact extraction (the cacheable step)
# --------------------------------------------------------------------- #
def _collect_defs(mod: ModuleInfo, mname: str):
    """(qual, cls_qual|None, node) for module-level functions and methods."""
    out = []
    for node in mod.tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            out.append((f"{mname}.{node.name}", None, node))
        elif isinstance(node, ast.ClassDef):
            cq = f"{mname}.{node.name}"
            for item in node.body:
                if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    out.append((f"{cq}.{item.name}", cq, item))
    return out


def _class_table(mod: ModuleInfo, mname: str) -> dict:
    """class qualname -> {"bases": [dotted...], "methods": [names...]}."""
    local_classes = {n.name for n in mod.tree.body if isinstance(n, ast.ClassDef)}
    table = {}
    for node in mod.tree.body:
        if not isinstance(node, ast.ClassDef):
            continue
        bases = []
        for b in node.bases:
            if isinstance(b, ast.Name) and b.id in local_classes:
                bases.append(f"{mname}.{b.id}")
            else:
                dotted = mod.dotted_name(b)
                if dotted:
                    bases.append(dotted)
        methods = [i.name for i in node.body
                   if isinstance(i, (ast.FunctionDef, ast.AsyncFunctionDef))]
        table[f"{mname}.{node.name}"] = {"bases": bases, "methods": methods}
    return table


def _call_descriptors(mod: ModuleInfo, mname: str, cls_qual: str | None,
                      fn: ast.AST, local_fns: set, local_classes: set):
    """Unresolved call descriptors inside one function body.

    Forms: ``("abs", dotted)`` — absolute dotted target (function, or a
    class whose ``__init__``/``__post_init__`` the link step targets);
    ``("self", cls_qual, meth)`` — method dispatch resolved through the
    class table (own class first, then corpus-resolvable bases).
    """
    out = []
    for node in ast.walk(fn):
        if not isinstance(node, ast.Call):
            continue
        func = node.func
        pos = (node.lineno, node.col_offset)
        if isinstance(func, ast.Name):
            nm = func.id
            if nm in local_fns:
                out.append(("abs", f"{mname}.{nm}") + pos)
            elif nm in local_classes:
                out.append(("abs", f"{mname}.{nm}") + pos)
            elif nm in mod.aliases:
                out.append(("abs", mod.aliases[nm]) + pos)
        elif isinstance(func, ast.Attribute):
            if (isinstance(func.value, ast.Name)
                    and func.value.id in ("self", "cls")
                    and cls_qual is not None):
                out.append(("self", cls_qual, func.attr) + (pos[0],) + (pos[1],))
            else:
                dotted = mod.dotted_name(func)
                if dotted:
                    out.append(("abs", dotted) + pos)
    return out


def _module_globals(mod: ModuleInfo) -> set:
    """Names bound to module-level state in this module."""
    names = set()
    for node in mod.tree.body:
        if isinstance(node, ast.Assign):
            for t in node.targets:
                if isinstance(t, ast.Name):
                    names.add(t.id)
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name):
            names.add(node.target.id)
    return names


def _root_name(node: ast.AST) -> str | None:
    while isinstance(node, (ast.Subscript, ast.Attribute)):
        node = node.value
    return node.id if isinstance(node, ast.Name) else None


def _global_mutations(mod: ModuleInfo):
    """(line, col, detail) sites mutating module-level state from inside a
    function: ``global X`` declarations, subscript/attribute stores on
    module-level names, and in-place mutator calls on them."""
    mod_globals = _module_globals(mod)
    out = []
    for node in ast.walk(mod.tree):
        if mod.enclosing_function(node) is None:
            continue
        if isinstance(node, ast.Global):
            for nm in node.names:
                out.append((node.lineno, node.col_offset, f"global {nm}"))
        elif isinstance(node, (ast.Assign, ast.AugAssign)):
            targets = node.targets if isinstance(node, ast.Assign) else [node.target]
            for t in targets:
                if not isinstance(t, (ast.Subscript, ast.Attribute)):
                    continue
                root = _root_name(t)
                if root in mod_globals:
                    out.append((node.lineno, node.col_offset,
                                f"store into module-level `{root}`"))
        elif (isinstance(node, ast.Call)
              and isinstance(node.func, ast.Attribute)
              and node.func.attr in _MUTATORS):
            root = _root_name(node.func.value)
            if root in mod_globals:
                out.append((node.lineno, node.col_offset,
                            f"`{root}.{node.func.attr}()` on module-level state"))
    return out


def _direct_effects(mod: ModuleInfo):
    """effect -> [(line, col, detail)], reusing the local determinism rules
    as the single source of truth for what counts as an effect."""
    from repro_torch.analysis.rules.determinism import (
        UnorderedIterationRule,
        UnseededRngRule,
        WallClockRule,
    )

    def _detail(msg: str) -> str:
        # local-rule messages embed the call as `name()` — lift it out
        start = msg.find("`")
        end = msg.find("`", start + 1)
        return msg[start + 1:end] if 0 <= start < end else msg.split(":")[0]

    sites = {eff: [] for eff in EFFECTS}
    for v in WallClockRule().check(mod):
        sites[WALL_CLOCK].append((v.line, v.col, _detail(v.message)))
    for v in UnseededRngRule().check(mod):
        sites[UNSEEDED_RNG].append((v.line, v.col, _detail(v.message)))
    for v in UnorderedIterationRule().check(mod):
        sites[SET_ORDER].append((v.line, v.col, "set-order iteration"))
    sites[GLOBAL_MUT] = _global_mutations(mod)
    return {
        eff: [s for s in found if not _effect_suppressed(mod, eff, s[0])]
        for eff, found in sites.items()
    }


def module_facts(mod: ModuleInfo) -> dict:
    """The JSON-serializable local facts for one module (cache payload)."""
    mname = module_name(mod.rel)
    defs = _collect_defs(mod, mname)
    local_fns = {n.name for n in mod.tree.body
                 if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))}
    local_classes = {n.name for n in mod.tree.body if isinstance(n, ast.ClassDef)}
    effects = _direct_effects(mod)

    spans = []  # (start, end, index into funcs) for effect attribution
    funcs = []
    for qual, cls_qual, node in defs:
        end = getattr(node, "end_lineno", None) or node.lineno
        funcs.append({
            "qual": qual,
            "lineno": node.lineno,
            "end_lineno": end,
            "direct": {},
            "calls": _call_descriptors(mod, mname, cls_qual, node,
                                       local_fns, local_classes),
        })
        spans.append((node.lineno, end, len(funcs) - 1))

    def owner(line: int):
        best = None
        for start, end, idx in spans:
            if start <= line <= end:
                if best is None or (end - start) < (best[1] - best[0]):
                    best = (start, end, idx)
        return None if best is None else best[2]

    for eff, found in effects.items():
        for line, col, detail in found:
            idx = owner(line)
            if idx is None:  # module top level: not propagated
                continue
            # keep the first (lowest-line) site per effect per function
            funcs[idx]["direct"].setdefault(eff, (line, col, detail))

    return {
        "module": mname,
        "functions": funcs,
        "classes": _class_table(mod, mname),
    }


# --------------------------------------------------------------------- #
# link + fixpoint (always recomputed — cheap, cross-file)
# --------------------------------------------------------------------- #
def _resolve_method(cls_qual: str, meth: str, classes: dict,
                    seen: set | None = None) -> str | None:
    seen = seen or set()
    if cls_qual in seen:
        return None
    seen.add(cls_qual)
    entry = classes.get(cls_qual)
    if entry is None:
        return None
    if meth in entry["methods"]:
        return f"{cls_qual}.{meth}"
    for base in entry["bases"]:
        got = _resolve_method(base, meth, classes, seen)
        if got is not None:
            return got
    return None


def _link(facts: dict) -> dict:
    """Resolve call descriptors against the global function/class index."""
    classes: dict = {}
    functions: dict = {}
    for per_file in facts["files"].values():
        classes.update(per_file["facts"].get("classes", {}))
    for rel, per_file in facts["files"].items():
        for fn in per_file["facts"]["functions"]:
            functions[fn["qual"]] = (rel, fn)

    linked: dict = {}
    for qual, (rel, fn) in functions.items():
        calls = []
        for desc in fn["calls"]:
            kind = desc[0]
            if kind == "abs":
                dotted, line, col = desc[1], desc[2], desc[3]
                if dotted in functions:
                    calls.append(CallSite(dotted, line, col))
                elif dotted in classes:
                    for ctor in ("__init__", "__post_init__"):
                        target = _resolve_method(dotted, ctor, classes)
                        if target in functions:
                            calls.append(CallSite(target, line, col))
            else:  # ("self", cls_qual, meth, line, col)
                cls_qual, meth, line, col = desc[1], desc[2], desc[3], desc[4]
                target = _resolve_method(cls_qual, meth, classes)
                if target in functions:
                    calls.append(CallSite(target, line, col))
        linked[qual] = FunctionInfo(
            qual=qual,
            rel=rel,
            lineno=fn["lineno"],
            end_lineno=fn["end_lineno"],
            direct={eff: tuple(site) for eff, site in fn["direct"].items()},
            calls=tuple(calls),
        )
    return linked


def _fixpoint(functions: dict) -> dict:
    """Propagate effects callee -> caller until stable, keeping the
    shortest witness chain (ties broken by iteration order over sorted
    qualnames, so the result is deterministic)."""
    summaries = {}
    for qual, fn in functions.items():
        per = {}
        for eff, (line, col, detail) in fn.direct.items():
            per[eff] = Taint(chain=(qual,), rel=fn.rel, line=line, detail=detail)
        summaries[qual] = per

    order = sorted(functions)
    changed = True
    while changed:
        changed = False
        for qual in order:
            fn = functions[qual]
            mine = summaries[qual]
            for cs in fn.calls:
                for eff, taint in summaries.get(cs.callee, {}).items():
                    if qual in taint.chain:
                        continue  # cycle: effect already witnessed upstream
                    cand = Taint(chain=(qual,) + taint.chain,
                                 rel=taint.rel, line=taint.line,
                                 detail=taint.detail)
                    cur = mine.get(eff)
                    if cur is None or len(cand.chain) < len(cur.chain):
                        mine[eff] = cand
                        changed = True
    return summaries


# --------------------------------------------------------------------- #
# entry points
# --------------------------------------------------------------------- #
def build_dataflow(corpus: "Corpus", cache: dict | None = None) -> Dataflow:
    """Facts for every module in ``corpus`` (cache-aware), linked and
    propagated to a fixpoint."""
    files = {}
    cached_files = {}
    if cache and cache.get("version") == _FACTS_VERSION:
        cached_files = cache.get("files", {})
    for rel in sorted(corpus.modules):
        mod = corpus.modules[rel]
        sha = hashlib.sha256(mod.source.encode()).hexdigest()
        prior = cached_files.get(rel)
        if prior is not None and prior.get("sha256") == sha:
            files[rel] = prior
        else:
            files[rel] = {"sha256": sha, "facts": module_facts(mod)}
    facts = {"version": _FACTS_VERSION, "files": files}
    functions = _link(facts)
    return Dataflow(functions=functions, summaries=_fixpoint(functions),
                    facts=facts)


def load_cache(path: Path) -> dict | None:
    try:
        data = json.loads(path.read_text())
    except (OSError, ValueError):
        return None
    return data if isinstance(data, dict) else None


def save_cache(path: Path, dataflow: Dataflow) -> None:
    # tuples serialize as lists; the cache round-trip re-tuples via
    # FunctionInfo construction in _link, so plain json is enough.
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(dataflow.facts, sort_keys=True))
