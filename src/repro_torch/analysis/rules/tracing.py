"""Capture-safety rules for functions a CUDA graph or ``torch.compile``
captures.

Under capture, as under ``jax.jit``, the Python body runs once: a CUDA
graph replays the kernels the first run launched, and ``torch.compile``
replays the graph it traced.  A host read of a tensor's value inside a
captured function (``if``/``while`` on a tensor, ``bool``/``int``/``float``
of one, ``.item()``, ``.tolist()``, ``.cpu()``, ``.numpy()``) either breaks
the capture (stream capture refuses a device-to-host sync; ``torch.compile``
breaks its graph there) or bakes the first run's value into every replay.
Writing Python state inside one is the same bug in another coat: the write
happens at capture, not per replay.  Reads of ``shape``, ``ndim``,
``dtype``, ``device`` and ``numel()`` are fixed for a captured shape and
exempt; in-place tensor ops are device work, replayed with the rest, and
exempt too (the port's caches rely on them).

A function is captured when it is

* decorated with ``torch.compile`` (bare, called, or through
  ``functools.partial``);
* passed to ``torch.compile(f)`` or ``torch.cuda.make_graphed_callables``;
* called inside a ``with torch.cuda.graph(g):`` block.
"""

from __future__ import annotations

import ast

from repro_torch.analysis.astutil import ModuleInfo
from repro_torch.analysis.base import Rule, Violation, register

#: Attribute reads on a tensor that are fixed for a captured shape.
STATIC_ATTRS = {"shape", "ndim", "dtype", "device", "is_cuda", "layout",
                "numel", "dim", "size"}

#: Builtins whose result over a tensor is static (or that never read it).
STATIC_CALLS = {"len", "isinstance", "getattr", "hasattr", "type", "id"}

#: Builtins that read a tensor's value to the host.
HOST_CASTS = {"bool", "int", "float"}

#: Tensor methods that read its value to the host.
HOST_READS = {"item", "tolist", "cpu", "numpy"}

_COMPILE_NAMES = {"torch.compile"}
_GRAPHED_NAMES = {"torch.compile", "torch.cuda.make_graphed_callables"}
_GRAPH_CONTEXTS = {"torch.cuda.graph"}
_PARTIAL_NAMES = {"functools.partial", "partial"}


def _decorated_compile(module: ModuleInfo, fn: ast.FunctionDef) -> bool:
    for dec in fn.decorator_list:
        if module.dotted_name(dec) in _COMPILE_NAMES:
            return True
        if isinstance(dec, ast.Call):
            fname = module.dotted_name(dec.func)
            if fname in _COMPILE_NAMES:
                return True
            if fname in _PARTIAL_NAMES and dec.args \
                    and module.dotted_name(dec.args[0]) in _COMPILE_NAMES:
                return True
    return False


def _called_name(call: ast.Call) -> str | None:
    if isinstance(call.func, ast.Name):
        return call.func.id
    if isinstance(call.func, ast.Attribute):
        return call.func.attr
    return None


def _captured_targets(module: ModuleInfo) -> set:
    """Function names captured by the call form (``torch.compile(f)``,
    ``make_graphed_callables((f, g), ...)``: every plain name in the first
    argument) or called inside a ``with torch.cuda.graph(...)`` block."""
    targets: set = set()
    for node in ast.walk(module.tree):
        if isinstance(node, ast.Call) \
                and module.dotted_name(node.func) in _GRAPHED_NAMES:
            for arg in node.args[:1]:
                for n in ast.walk(arg):
                    if isinstance(n, ast.Name):
                        targets.add(n.id)
        elif isinstance(node, (ast.With, ast.AsyncWith)) and any(
                isinstance(item.context_expr, ast.Call)
                and module.dotted_name(item.context_expr.func)
                in _GRAPH_CONTEXTS for item in node.items):
            for stmt in node.body:
                for n in ast.walk(stmt):
                    if isinstance(n, ast.Call) and _called_name(n):
                        targets.add(_called_name(n))
    return targets


def _captured_functions(module: ModuleInfo):
    """Yield every captured function def."""
    targets = _captured_targets(module)
    for node in ast.walk(module.tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) and (
                _decorated_compile(module, node) or node.name in targets):
            yield node


def _param_names(fn: ast.AST) -> set:
    args = fn.args
    names = [a.arg for a in args.posonlyargs + args.args + args.kwonlyargs]
    if args.vararg:
        names.append(args.vararg.arg)
    return {n for n in names if n not in ("self", "cls")}


def _name_is_static_use(module: ModuleInfo, name: ast.Name,
                        stop: ast.AST) -> bool:
    """True when this tensor reference only feeds capture-time-static
    information: a shape/dtype/device attribute or ``numel()``, a static
    builtin, or an ``is (not) None`` identity test."""
    parent = module.parent(name)
    if isinstance(parent, ast.Attribute) and parent.attr in STATIC_ATTRS:
        return True
    for anc in module.ancestors(name):
        if (isinstance(anc, ast.Call) and isinstance(anc.func, ast.Name)
                and anc.func.id in STATIC_CALLS):
            return True
        if isinstance(anc, ast.Compare) and all(
            isinstance(op, (ast.Is, ast.IsNot)) for op in anc.ops
        ):
            return True
        if anc is stop:
            break
    return False


def _expr_offending_names(module: ModuleInfo, expr: ast.AST,
                          tensors: set) -> list[ast.Name]:
    out = []
    for node in ast.walk(expr):
        if (isinstance(node, ast.Name) and node.id in tensors
                and not _name_is_static_use(module, node, stop=expr)):
            out.append(node)
    return out


def _tensor_locals(module: ModuleInfo, fn: ast.AST) -> set:
    """The parameters, and the locals assigned from them in source order:
    ``n = x.shape[0]`` stays static, ``y = x * 2`` is a tensor."""
    tensors = _param_names(fn)
    assigns = [n for n in ast.walk(fn)
               if isinstance(n, (ast.Assign, ast.AnnAssign, ast.AugAssign))]
    for stmt in sorted(assigns, key=lambda n: n.lineno):
        if stmt.value is None or not _expr_offending_names(
                module, stmt.value, tensors):
            continue
        targets = (stmt.targets if isinstance(stmt, ast.Assign)
                   else [stmt.target])
        for tgt in targets:
            for n in ast.walk(tgt):
                if isinstance(n, ast.Name):
                    tensors.add(n.id)
    return tensors


@register
class HostReadRule(Rule):
    rule_id = "TRACE001"
    family = "tracing"
    summary = ("no branch on, or host read of, a tensor's value inside a "
               "function a CUDA graph or torch.compile captures")

    def _finding(self, module, node, fn, what: str) -> Violation:
        return Violation(
            self.rule_id, module.rel, node.lineno, node.col_offset,
            f"{what} inside captured `{fn.name}`: the capture runs the "
            "body once, so this reads the value to the host (a sync "
            "stream capture refuses, a graph break) or bakes the first "
            "run's value into every replay — keep it on the device "
            "(torch.where), or move it out of the captured function",
        )

    def check(self, module: ModuleInfo) -> list[Violation]:
        out = []
        for fn in _captured_functions(module):
            tensors = _tensor_locals(module, fn)
            for node in ast.walk(fn):
                if isinstance(node, (ast.If, ast.While, ast.IfExp,
                                     ast.Assert)):
                    bad = _expr_offending_names(module, node.test, tensors)
                    if bad:
                        names = ", ".join(sorted({n.id for n in bad}))
                        kind = type(node).__name__.lower()
                        out.append(self._finding(
                            module, node, fn,
                            f"Python `{kind}` on tensor value(s) `{names}`"))
                elif isinstance(node, ast.Call):
                    func = node.func
                    if (isinstance(func, ast.Name) and func.id in HOST_CASTS
                            and node.args and _expr_offending_names(
                                module, node.args[0], tensors)):
                        out.append(self._finding(
                            module, node, fn, f"`{func.id}()` of a tensor"))
                    elif (isinstance(func, ast.Attribute)
                          and func.attr in HOST_READS):
                        out.append(self._finding(
                            module, node, fn, f"`.{func.attr}()`"))
        return out


@register
class CaptureStateMutationRule(Rule):
    rule_id = "TRACE002"
    family = "tracing"
    summary = ("no module/instance state mutation inside captured "
               "functions (runs once at capture, not per replay)")

    def check(self, module: ModuleInfo) -> list[Violation]:
        out = []
        for fn in _captured_functions(module):
            for node in ast.walk(fn):
                if isinstance(node, (ast.Global, ast.Nonlocal)):
                    out.append(Violation(
                        self.rule_id, module.rel, node.lineno,
                        node.col_offset,
                        f"`{type(node).__name__.lower()}` declaration "
                        f"inside captured `{fn.name}`: outer-scope writes "
                        "happen at capture only — return the value "
                        "instead",
                    ))
                elif isinstance(node, (ast.Assign, ast.AugAssign)):
                    targets = (node.targets if isinstance(node, ast.Assign)
                               else [node.target])
                    for tgt in targets:
                        if (isinstance(tgt, ast.Attribute)
                                and isinstance(tgt.value, ast.Name)
                                and tgt.value.id in ("self", "cls")):
                            out.append(Violation(
                                self.rule_id, module.rel, tgt.lineno,
                                tgt.col_offset,
                                f"write to `{tgt.value.id}.{tgt.attr}` "
                                f"inside captured `{fn.name}`: instance "
                                "state changes at capture only — keep the "
                                "state in a tensor updated in place, or "
                                "outside the captured function",
                            ))
        return out
