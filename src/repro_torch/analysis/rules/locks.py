"""Lock-discipline rules: ``# guarded-by:`` annotations checked against
actual ``with lock:`` enclosure.

Two annotation forms, mirroring how shared state actually lives in this
codebase:

* **Class fields** — a ``self.X = ...`` assignment in ``__init__`` (or
  ``__post_init__``) tagged ``# guarded-by: _lock`` declares that every
  ``self.X`` access in the class's *other* methods must sit inside
  ``with self._lock:``.  A method whose ``def`` line carries
  ``# holds: _lock`` declares a caller-held contract (private helpers like
  ``_refresh_locked`` / ``_wake_next``) and is exempt for that lock.
* **Function locals** — a local assignment tagged
  ``# guarded-by: admit_lock`` declares that every access of that name
  from a *nested* function (the thread targets and callbacks a
  ``FleetScheduler.run`` spawns) must sit inside ``with admit_lock:``.
  Accesses in the owning function's own body are the single-threaded
  setup/epilogue and stay unchecked — the stale-interval hazard was exactly the
  worker-closure path.

The annotation is the contract; these rules make it checkable, which is
what turned "grow the attempt-state lists only under admit_lock" from a
code-review comment into a failing build.
"""

from __future__ import annotations

import ast

from repro_torch.analysis.astutil import ModuleInfo, holds_lock, with_context_names
from repro_torch.analysis.base import Rule, Violation, register

_INIT_METHODS = {"__init__", "__post_init__", "__del__"}


def _method_holds(module: ModuleInfo, func: ast.FunctionDef, lock: str) -> bool:
    return module.holds.get(func.lineno) == lock


def _guarded_class_fields(
    module: ModuleInfo, cls: ast.ClassDef
) -> dict[str, tuple[str, int]]:
    """field name -> (lock name, annotation line) from __init__ tags."""
    fields: dict[str, tuple[str, int]] = {}
    for func in cls.body:
        if not isinstance(func, ast.FunctionDef) or func.name not in _INIT_METHODS:
            continue
        for node in ast.walk(func):
            if not isinstance(node, (ast.Assign, ast.AnnAssign)):
                continue
            lock = module.guard_annotation(node)
            if lock is None:
                continue
            targets = node.targets if isinstance(node, ast.Assign) else [node.target]
            for tgt in targets:
                if (isinstance(tgt, ast.Attribute)
                        and isinstance(tgt.value, ast.Name)
                        and tgt.value.id == "self"):
                    fields[tgt.attr] = (lock, node.lineno)
    return fields


@register
class GuardedFieldRule(Rule):
    rule_id = "LOCK001"
    family = "locks"
    summary = ("a `# guarded-by:`-tagged field must only be accessed inside "
               "`with <lock>:` (or from a `# holds:` method)")

    def check(self, module: ModuleInfo) -> list[Violation]:
        out: list[Violation] = []
        for node in ast.walk(module.tree):
            if isinstance(node, ast.ClassDef):
                out.extend(self._check_class(module, node))
            elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                out.extend(self._check_function_locals(module, node))
        return out

    # ------------------------------------------------------------------ #
    def _check_class(self, module: ModuleInfo, cls: ast.ClassDef):
        fields = _guarded_class_fields(module, cls)
        if not fields:
            return []
        out = []
        for func in cls.body:
            if not isinstance(func, ast.FunctionDef):
                continue
            if func.name in _INIT_METHODS:
                continue
            for node in ast.walk(func):
                if not (isinstance(node, ast.Attribute)
                        and isinstance(node.value, ast.Name)
                        and node.value.id == "self"
                        and node.attr in fields):
                    continue
                lock, _ = fields[node.attr]
                if _method_holds(module, func, lock):
                    continue
                if holds_lock(module, node, lock, stop=func):
                    continue
                kind = "write" if isinstance(node.ctx, (ast.Store, ast.Del)) \
                    else "read"
                out.append(Violation(
                    self.rule_id, module.rel, node.lineno, node.col_offset,
                    f"{kind} of `self.{node.attr}` (guarded by `{lock}`) "
                    f"outside `with self.{lock}:` in "
                    f"`{cls.name}.{func.name}` — acquire the lock or tag "
                    f"the method `# holds: {lock}`",
                ))
        return out

    # ------------------------------------------------------------------ #
    def _check_function_locals(self, module: ModuleInfo, func: ast.AST):
        guarded: dict[str, str] = {}  # local name -> lock name
        for stmt in ast.walk(func):
            if not isinstance(stmt, (ast.Assign, ast.AnnAssign)):
                continue
            if module.enclosing_function(stmt) is not func:
                continue  # belongs to a nested function's own scope
            lock = module.guard_annotation(stmt)
            if lock is None:
                continue
            targets = stmt.targets if isinstance(stmt, ast.Assign) else [stmt.target]
            for tgt in targets:
                if isinstance(tgt, ast.Name):
                    guarded[tgt.id] = lock
        if not guarded:
            return []
        out = []
        nested = [
            n for n in ast.walk(func)
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
            and n is not func
            and module.enclosing_function(n) is func
        ]
        for inner in nested:
            for node in ast.walk(inner):
                if not (isinstance(node, ast.Name) and node.id in guarded):
                    continue
                lock = guarded[node.id]
                if _method_holds(module, inner, lock):
                    continue
                if holds_lock(module, node, lock, stop=inner):
                    continue
                kind = "write" if isinstance(node.ctx, (ast.Store, ast.Del)) \
                    else "read"
                out.append(Violation(
                    self.rule_id, module.rel, node.lineno, node.col_offset,
                    f"{kind} of `{node.id}` (guarded by `{lock}`) from "
                    f"nested function `{inner.name}` outside "
                    f"`with {lock}:` — thread targets must acquire the "
                    "lock the annotation names",
                ))
        return out


@register
class UnknownLockRule(Rule):
    rule_id = "LOCK002"
    family = "locks"
    summary = ("a `# guarded-by:` annotation must name a lock some "
               "`with <lock>:` in the same class/function actually acquires")

    def check(self, module: ModuleInfo) -> list[Violation]:
        out: list[Violation] = []
        for node in ast.walk(module.tree):
            if isinstance(node, ast.ClassDef):
                fields = _guarded_class_fields(module, node)
                locks = self._acquired_locks(node)
                for name, (lock, line) in sorted(fields.items()):
                    if lock not in locks:
                        out.append(self._bad(module, line, name, lock))
            elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                locks = self._acquired_locks(node)
                for stmt in ast.walk(node):
                    if not isinstance(stmt, (ast.Assign, ast.AnnAssign)):
                        continue
                    if module.enclosing_function(stmt) is not node:
                        continue
                    lock = module.guard_annotation(stmt)
                    targets = (stmt.targets if isinstance(stmt, ast.Assign)
                               else [stmt.target])
                    if lock is None or not any(
                        isinstance(t, ast.Name) for t in targets
                    ):
                        continue
                    if lock not in locks:
                        name = next(t.id for t in targets
                                    if isinstance(t, ast.Name))
                        out.append(self._bad(module, stmt.lineno, name, lock))
        return out

    @staticmethod
    def _acquired_locks(scope: ast.AST) -> set[str]:
        locks: set[str] = set()
        for node in ast.walk(scope):
            if isinstance(node, ast.With):
                locks.update(with_context_names(node))
        return locks

    def _bad(self, module: ModuleInfo, line: int, name: str, lock: str):
        return Violation(
            self.rule_id, module.rel, line, 0,
            f"`{name}` is tagged `# guarded-by: {lock}` but no "
            f"`with {lock}:` exists in the enclosing scope — fix the "
            "annotation or the locking",
        )
