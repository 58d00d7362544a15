"""Shared AST plumbing: parsed-module record, comment/annotation extraction,
parent links, dotted-name resolution through import aliases, and
``with``-block enclosure tests (the lock rules' core primitive)."""

from __future__ import annotations

import ast
import dataclasses
import io
import re
import tokenize
from pathlib import Path

_SUPPRESS_RE = re.compile(
    r"#\s*repro-lint:\s*disable=([A-Za-z0-9_*,\-]+)(?:\s*--\s*(?P<reason>\S.*))?"
)
_GUARDED_RE = re.compile(r"#\s*guarded-by:\s*([A-Za-z_]\w*)")
_HOLDS_RE = re.compile(r"#\s*holds:\s*([A-Za-z_]\w*)")


@dataclasses.dataclass
class Suppression:
    rules: frozenset[str]  # rule ids; "*" wildcards every rule
    reason: str | None
    used: bool = False

    def covers(self, rule_id: str) -> bool:
        return "*" in self.rules or rule_id in self.rules


@dataclasses.dataclass
class ModuleInfo:
    """One parsed source file plus everything the rules need around the AST."""

    path: Path  # absolute
    rel: str  # posix path relative to the analysis root
    source: str
    tree: ast.Module
    parents: dict[ast.AST, ast.AST]
    suppressions: dict[int, Suppression]  # line -> suppression comment
    guarded_by: dict[int, str]  # line -> lock name annotation
    holds: dict[int, str]  # line -> caller-held-lock annotation
    aliases: dict[str, str]  # local name -> dotted module/object path

    # ------------------------------------------------------------------ #
    def parent(self, node: ast.AST) -> ast.AST | None:
        return self.parents.get(node)

    def ancestors(self, node: ast.AST):
        cur = self.parents.get(node)
        while cur is not None:
            yield cur
            cur = self.parents.get(cur)

    def enclosing_function(self, node: ast.AST):
        for anc in self.ancestors(node):
            if isinstance(anc, (ast.FunctionDef, ast.AsyncFunctionDef)):
                return anc
        return None

    def dotted_name(self, node: ast.AST) -> str | None:
        """``np.random.default_rng`` -> ``numpy.random.default_rng``.

        Resolves the leading name through the module's import aliases; a
        non-name leaf (call result, subscript) returns None.
        """
        parts: list[str] = []
        cur = node
        while isinstance(cur, ast.Attribute):
            parts.append(cur.attr)
            cur = cur.value
        if not isinstance(cur, ast.Name):
            return None
        head = self.aliases.get(cur.id, cur.id)
        parts.append(head)
        return ".".join(reversed(parts))

    def guard_annotation(self, node: ast.AST) -> str | None:
        """The ``# guarded-by:`` lock name on any physical line this
        statement spans (trailing comments of multi-line statements land on
        the last line)."""
        end = getattr(node, "end_lineno", None) or node.lineno
        for ln in range(node.lineno, end + 1):
            if ln in self.guarded_by:
                return self.guarded_by[ln]
        return None


def _next_code_line(lines: list[str], after: int) -> int | None:
    """First 1-indexed line after ``after`` that is neither blank nor a
    comment — what an own-line suppression comment applies to."""
    for i in range(after, len(lines)):
        stripped = lines[i].strip()
        if stripped and not stripped.startswith("#"):
            return i + 1
    return None


def _extract_comments(source: str):
    """Suppressions and lock annotations, keyed by the line they govern.

    A *trailing* comment governs its own line; a comment on a line of its
    own governs the next code line (so multi-line reason strings can sit
    above the flagged statement).  Continuation comment lines between the
    directive and the code are skipped over.
    """
    suppressions: dict[int, Suppression] = {}
    guarded: dict[int, str] = {}
    holds: dict[int, str] = {}
    lines = source.splitlines()
    try:
        tokens = tokenize.generate_tokens(io.StringIO(source).readline)
        for tok in tokens:
            if tok.type != tokenize.COMMENT:
                continue
            line = tok.start[0]
            own_line = tok.line.strip().startswith("#")
            target = line
            if own_line:
                nxt = _next_code_line(lines, line)
                if nxt is None:
                    continue
                target = nxt
            m = _SUPPRESS_RE.search(tok.string)
            if m:
                rules = frozenset(
                    r.strip() for r in m.group(1).split(",") if r.strip()
                )
                suppressions[target] = Suppression(rules, m.group("reason"))
            m = _GUARDED_RE.search(tok.string)
            if m:
                guarded[target] = m.group(1)
            m = _HOLDS_RE.search(tok.string)
            if m:
                holds[target] = m.group(1)
    except tokenize.TokenError:  # unterminated string etc: parse will fail too
        pass
    return suppressions, guarded, holds


def _import_aliases(tree: ast.Module) -> dict[str, str]:
    """Best-effort local-name -> dotted-path map from import statements.

    Function-level imports are included too (the kernels dispatch imports
    lazily inside each wrapper).
    """
    aliases: dict[str, str] = {"np": "numpy"}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                aliases[a.asname or a.name.split(".")[0]] = (
                    a.name if a.asname else a.name.split(".")[0]
                )
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            for a in node.names:
                if a.name == "*":
                    continue
                aliases[a.asname or a.name] = f"{node.module}.{a.name}"
    return aliases


def parse_module(path: Path, root: Path) -> ModuleInfo:
    source = path.read_text()
    tree = ast.parse(source, filename=str(path))
    parents: dict[ast.AST, ast.AST] = {}
    for node in ast.walk(tree):
        for child in ast.iter_child_nodes(node):
            parents[child] = node
    suppressions, guarded, holds = _extract_comments(source)
    try:
        rel = path.resolve().relative_to(root.resolve()).as_posix()
    except ValueError:
        rel = path.as_posix()
    return ModuleInfo(
        path=path,
        rel=rel,
        source=source,
        tree=tree,
        parents=parents,
        suppressions=suppressions,
        guarded_by=guarded,
        holds=holds,
        aliases=_import_aliases(tree),
    )


# --------------------------------------------------------------------- #
# lock-enclosure helpers
# --------------------------------------------------------------------- #
def with_context_names(node: ast.With) -> list[str]:
    """Lock names this ``with`` acquires: ``with self._lock:`` and
    ``with admit_lock:`` both yield ``_lock`` / ``admit_lock``."""
    names = []
    for item in node.items:
        expr = item.context_expr
        if isinstance(expr, ast.Attribute) and isinstance(expr.value, ast.Name):
            if expr.value.id in ("self", "cls"):
                names.append(expr.attr)
        elif isinstance(expr, ast.Name):
            names.append(expr.id)
    return names


def holds_lock(module: ModuleInfo, node: ast.AST, lock: str,
               stop: ast.AST | None = None) -> bool:
    """True when ``node`` sits inside a ``with <lock>:`` block, searching
    ancestors up to (not beyond) ``stop``."""
    for anc in module.ancestors(node):
        if isinstance(anc, ast.With) and lock in with_context_names(anc):
            return True
        if anc is stop:
            return False
    return False
