"""Kernel-contract rules: the CUDA kernel / plain twin / dispatch /
parity-test triangle of the port's six kernels.

A kernel module is a file under ``kernels/`` whose ``_build.load("<name>")``
names an existing ``csrc/<name>.cu`` and which defines a public ``*_cuda``
entry point.  Each such entry must have:

* **KER001** — a dispatch in ``kernels/ops.py``: the function that imports
  the ``*_cuda`` entry and routes a CUDA tensor to it (a tensor elsewhere
  takes the plain twin);
* **KER002** — a plain twin: the dispatch must reach at least one
  ``ref.*`` function that actually exists in ``kernels/ref.py``, directly
  or through the ``ops.py`` helpers it calls (``_flash_attention`` reaches
  ``ref.attention_ref`` through ``plain_attention``);
* **KER003** — a parity test in the files that hold the kernels to their
  twins: a test that names the ``*_cuda`` entry and a twin, or one marked
  ``cuda`` (it runs on the card, where the dispatch routes to the kernel)
  that calls the dispatch, or an ``ops.py`` function that reaches it, and
  names a twin.  A test's names include those of the helpers of its file
  that it calls.

These are corpus rules: they cross-reference five places (the kernel
module, its CUDA source, ``ops.py``, ``ref.py`` and the test files), so a
kernel added without its twin — or a twin renamed out from under its test
— fails the build instead of silently un-validating the kernel.
"""

from __future__ import annotations

import ast
import dataclasses
from pathlib import PurePosixPath

from repro_torch.analysis.base import Rule, Violation, register
from repro_torch.analysis.engine import Corpus


@dataclasses.dataclass
class KernelEntry:
    module_rel: str
    source: str  # e.g. "ssd_scan" (csrc/ssd_scan.cu)
    cuda_fn: str  # e.g. "ssd_scan_cuda"
    line: int


@dataclasses.dataclass
class DispatchEntry:
    dispatch_fn: str
    oracles: set  # ref.* names the dispatch reaches
    twins: set  # the oracles and the ops.py helpers it reaches them through
    callers: set  # ops.py functions that reach the dispatch (itself too)


def _build_loads(mod) -> list[str]:
    """The ``"<name>"`` of every ``_build.load("<name>")`` call."""
    out = []
    for node in ast.walk(mod.tree):
        if (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr == "load"
                and isinstance(node.func.value, ast.Name)
                and node.func.value.id == "_build"
                and node.args and isinstance(node.args[0], ast.Constant)
                and isinstance(node.args[0].value, str)):
            out.append(node.args[0].value)
    return out


def _kernel_entries(corpus: Corpus) -> list[KernelEntry]:
    cfg = corpus.config.kernel_contract
    kdir = corpus.root / cfg.kernels_dir
    entries: list[KernelEntry] = []
    if not kdir.is_dir():
        return entries
    for path in sorted(kdir.glob("*.py")):
        if path.name in cfg.non_kernel_modules:
            continue
        rel = (PurePosixPath(cfg.kernels_dir) / path.name).as_posix()
        mod = corpus.module(rel)
        if mod is None:
            continue
        sources = [s for s in _build_loads(mod)
                   if (corpus.root / cfg.csrc_dir / f"{s}.cu").is_file()]
        if not sources:
            continue
        for fn in mod.tree.body:
            if (isinstance(fn, ast.FunctionDef)
                    and fn.name.endswith("_cuda")
                    and not fn.name.startswith("_")):
                entries.append(KernelEntry(rel, sources[0], fn.name,
                                           fn.lineno))
    return entries


def _ops_functions(ops) -> dict[str, ast.FunctionDef]:
    return {fn.name: fn for fn in ops.tree.body
            if isinstance(fn, ast.FunctionDef)}


def _calls(fn: ast.AST) -> set:
    """Plain names called in ``fn`` (``f(...)``)."""
    return {n.func.id for n in ast.walk(fn)
            if isinstance(n, ast.Call) and isinstance(n.func, ast.Name)}


def _ref_names(ops, fn: ast.AST) -> set:
    names = set()
    for node in ast.walk(fn):
        if isinstance(node, ast.Attribute):
            name = ops.dotted_name(node)
            if name and name.startswith("repro_torch.kernels.ref."):
                names.add(name.rsplit(".", 1)[1])
    return names


def _dispatch_map(corpus: Corpus) -> dict[str, DispatchEntry]:
    """*_cuda entry name -> its ops.py dispatch, the twins it reaches and
    the ops.py functions that reach it."""
    cfg = corpus.config.kernel_contract
    ops = corpus.module(cfg.ops_module)
    out: dict[str, DispatchEntry] = {}
    if ops is None:
        return out
    fns = _ops_functions(ops)

    def reached(name: str, seen: set) -> set:
        """The ops.py functions ``name`` calls, transitively (itself too)."""
        if name in seen or name not in fns:
            return seen
        seen.add(name)
        for callee in _calls(fns[name]):
            reached(callee, seen)
        return seen

    for fn in fns.values():
        imported: list[str] = []
        for node in ast.walk(fn):
            if (isinstance(node, ast.ImportFrom) and node.module
                    and node.module.startswith("repro_torch.kernels.")):
                imported.extend(a.asname or a.name for a in node.names)
        for name in imported:
            if not name.endswith("_cuda"):
                continue
            oracles, twins = set(), set()
            for helper in reached(fn.name, set()):
                found = _ref_names(ops, fns[helper])
                oracles |= found
                if found and helper != fn.name:
                    twins.add(helper)
            callers = {f for f in fns if fn.name in reached(f, set())}
            out[name] = DispatchEntry(fn.name, oracles, oracles | twins,
                                      callers)
    return out


def _ref_functions(corpus: Corpus) -> set:
    cfg = corpus.config.kernel_contract
    ref = corpus.module(cfg.ref_module)
    if ref is None:
        return set()
    return {fn.name for fn in ref.tree.body if isinstance(fn, ast.FunctionDef)}


def _names(fn: ast.AST) -> set:
    names: set = set()
    for node in ast.walk(fn):
        if isinstance(node, ast.Name):
            names.add(node.id)
        elif isinstance(node, ast.Attribute):
            names.add(node.attr)
    return names


def _on_card(fn: ast.FunctionDef) -> bool:
    """Marked ``@pytest.mark.cuda`` (or ``@mark.cuda``)."""
    return any(isinstance(d, ast.Attribute) and d.attr == "cuda"
               and isinstance(d.value, ast.Attribute)
               and d.value.attr == "mark" for d in fn.decorator_list)


def _test_functions(corpus: Corpus):
    """(test name, referenced names with its file's helpers', called names,
    whether it runs on the card) per test."""
    cfg = corpus.config.kernel_contract
    tests = []
    for trel in cfg.test_files:
        mod = corpus.module(trel)
        if mod is None:
            continue
        helpers = {fn.name: fn for fn in mod.tree.body
                   if isinstance(fn, ast.FunctionDef)
                   and not fn.name.startswith("test")}
        for fn in mod.tree.body:
            if not (isinstance(fn, ast.FunctionDef)
                    and fn.name.startswith("test")):
                continue
            names, seen, todo = set(), set(), [fn]
            while todo:
                cur = todo.pop()
                names |= _names(cur)
                for callee in _calls(cur) & set(helpers):
                    if callee not in seen:
                        seen.add(callee)
                        todo.append(helpers[callee])
            called = {n.func.attr if isinstance(n.func, ast.Attribute)
                      else n.func.id for n in ast.walk(fn)
                      if isinstance(n, ast.Call)
                      and isinstance(n.func, (ast.Attribute, ast.Name))}
            tests.append((fn.name, names, called, _on_card(fn)))
    return tests


def _violation(rule_id: str, entry: KernelEntry, msg: str) -> Violation:
    return Violation(rule_id, entry.module_rel, entry.line, 0, msg)


@register
class MissingDispatchRule(Rule):
    rule_id = "KER001"
    family = "kernel-contract"
    summary = "every *_cuda kernel entry needs an ops.py dispatch"
    scope = "corpus"

    def check_corpus(self, corpus: Corpus) -> list[Violation]:
        cfg = corpus.config.kernel_contract
        dispatch = _dispatch_map(corpus)
        out = []
        for entry in _kernel_entries(corpus):
            if entry.cuda_fn not in dispatch:
                out.append(_violation(
                    self.rule_id, entry,
                    f"kernel `{entry.cuda_fn}` has no dispatch in "
                    f"{cfg.ops_module}: import it there and route CUDA "
                    "tensors to it, so callers never import the kernel "
                    "entry directly",
                ))
        return out


@register
class MissingOracleRule(Rule):
    rule_id = "KER002"
    family = "kernel-contract"
    summary = ("every kernel's dispatch must reach a ref.py plain twin "
               "that exists")

    scope = "corpus"

    def check_corpus(self, corpus: Corpus) -> list[Violation]:
        cfg = corpus.config.kernel_contract
        dispatch = _dispatch_map(corpus)
        ref_fns = _ref_functions(corpus)
        out = []
        for entry in _kernel_entries(corpus):
            d = dispatch.get(entry.cuda_fn)
            if d is None:
                continue  # KER001 already fired
            live = d.oracles & ref_fns
            if not live:
                missing = ", ".join(sorted(d.oracles)) or "none referenced"
                out.append(_violation(
                    self.rule_id, entry,
                    f"dispatch `{d.dispatch_fn}` for `{entry.cuda_fn}` "
                    f"reaches no twin defined in {cfg.ref_module} "
                    f"(referenced: {missing}) — every kernel needs a plain "
                    "reference implementation for tensors off the card",
                ))
        return out


@register
class MissingParityTestRule(Rule):
    rule_id = "KER003"
    family = "kernel-contract"
    summary = ("every kernel needs a parity test (kernel vs plain twin) in "
               "the kernel test files")

    scope = "corpus"

    def check_corpus(self, corpus: Corpus) -> list[Violation]:
        cfg = corpus.config.kernel_contract
        dispatch = _dispatch_map(corpus)
        ref_fns = _ref_functions(corpus)
        tests = _test_functions(corpus)
        out = []
        for entry in _kernel_entries(corpus):
            d = dispatch.get(entry.cuda_fn)
            live = (d.oracles & ref_fns) if d is not None else set()
            twins = (d.twins - (d.oracles - live)) if d is not None else set()
            ok = False
            for _, names, called, on_card in tests:
                if not twins & names:
                    continue
                direct = entry.cuda_fn in names
                via_dispatch = on_card and d is not None \
                    and bool(d.callers & called)
                if direct or via_dispatch:
                    ok = True
                    break
            if not ok:
                files = ", ".join(cfg.test_files)
                out.append(_violation(
                    self.rule_id, entry,
                    f"no parity test for `{entry.cuda_fn}` in {files}: "
                    "add a test calling the kernel entry against its ref.py "
                    "twin (or a `cuda`-marked test calling its ops.py "
                    "dispatch) so the kernel is actually validated",
                ))
        return out
