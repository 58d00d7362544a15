"""The port's static analysis (``repro_torch.analysis``) against the JAX
package's (``repro.analysis``), on the CPU; it mirrors
``tests/test_analysis.py`` and ``tests/test_dataflow.py``.

- Every copied family (DET001-004, DET101-104, LOCK001-002, UNIT001-003,
  PAR001-003, SUP001, suppressions, parse errors) on shared fixture trees:
  each tree is written once for each analyzer, with ``PKG`` standing for
  ``repro`` or ``repro_torch`` in its paths and imports, and both must
  report the same rule ids on the same lines (and the same suppressed
  ones), which must be the ones the fixture expects.
- The kernel contract re-pointed at the port's layout (KER001-003): a CUDA
  source under ``csrc/``, a ``*_cuda`` entry, its ``ops.py`` dispatch, a
  ``ref.py`` twin, a parity test; each rule fires on its fixture.
- The capture rules (TRACE001-002) on ``torch.compile``,
  ``make_graphed_callables`` and ``torch.cuda.graph`` fixtures.
- A self-scan of ``src/repro_torch`` that is clean, finds all six kernels,
  and whose every suppression carries a reason; the CLI entry point.
"""
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

import repro.analysis as ref_analysis
import repro.analysis.config as ref_config
import repro_torch.analysis as port_analysis
import repro_torch.analysis.config as port_config
from repro_torch.analysis.cli import main as cli_main
from repro_torch.analysis.dataflow import module_name
from repro_torch.analysis.engine import Corpus
from repro_torch.analysis.rules.kernel_contract import (_dispatch_map,
                                                        _kernel_entries)

REPO = Path(__file__).resolve().parents[1]
LOCAL_DET = {"DET001", "DET002", "DET003", "DET004"}

TWO_DEEP = {
    "src/PKG/core/sched.py": """
        from PKG.util.clockwrap import stamp

        def admit(now_s):
            return now_s + stamp()
    """,
    "src/PKG/util/clockwrap.py": """
        import time

        def stamp():
            return _now()

        def _now():
            return time.time()
    """,
}

PARITY_FLEET = """
    def assemble_fleet_report(reports):
        return len(reports)

    def run(reports):
        return assemble_fleet_report(reports)
"""

# name -> (files, config kind, rule ids or None, fired, suppressed)
FIXTURES = {
    "det001_sim_path": ({"src/PKG/core/admit.py": """
        import time

        def admit(env):
            env.admitted_at = time.time()
            return env
    """}, "scoped", None, ["DET001"], []),
    "det001_aliases": ({"mod.py": """
        from time import perf_counter
        from datetime import datetime

        def f():
            return perf_counter(), datetime.now()
    """}, "all", {"DET001"}, ["DET001", "DET001"], []),
    "det001_outside_sim_path": ({"benchmarks/bench.py": """
        import time

        def bench():
            return time.perf_counter()
    """}, "scoped", None, [], []),
    "det002_unseeded": ({"src/PKG/core/regions.py": """
        import numpy as np

        def identify_regions(surfaces):
            rng = np.random.default_rng()
            return rng.permutation(len(surfaces))
    """}, "scoped", None, ["DET002"], []),
    "det002_global_state": ({"mod.py": """
        import numpy as np
        import random

        def good(seed):
            return np.random.default_rng(seed).normal()

        def bad():
            return np.random.normal() + random.random()
    """}, "all", {"DET002"}, ["DET002", "DET002"], []),
    "det003_set_iteration": ({"mod.py": """
        def refit(touched):
            touched = set(touched)
            out = []
            for k in touched:
                out.append(k)
            return out
    """}, "all", {"DET003"}, ["DET003"], []),
    "det003_sorted_is_clean": ({"mod.py": """
        def refit(touched):
            touched = set(touched)
            total = sum(k for k in touched)
            return [k for k in sorted(touched)], total, max(touched)
    """}, "all", {"DET003"}, [], []),
    "det004_id_ordering": ({"mod.py": """
        def order(items):
            return sorted(items, key=lambda t: id(t))
    """}, "all", {"DET004"}, ["DET004"], []),
    "lock001_class_field": ({"mod.py": """
        import threading

        class Limiter:
            def __init__(self):
                self.grants = 0  # guarded-by: _lock
                self._lock = threading.Lock()

            def ok(self):
                with self._lock:
                    self.grants += 1

            def bad(self):
                self.grants += 1

            def _bump(self):  # holds: _lock
                self.grants += 1
    """}, "all", {"LOCK001"}, ["LOCK001"], []),
    "lock001_worker_closure": ({"src/PKG/core/sched.py": """
        import threading

        def run(n):
            pending = list(range(n))  # guarded-by: admit_lock
            admit_lock = threading.Lock()

            def worker():
                return pending.pop()

            def good_worker():
                with admit_lock:
                    return pending.pop()

            pending.append(n)
            return worker, good_worker
    """}, "scoped", {"LOCK001"}, ["LOCK001"], []),
    "lock002_unknown_lock": ({"mod.py": """
        import threading

        class C:
            def __init__(self):
                self.x = 0  # guarded-by: _nope
                self._lock = threading.Lock()

            def m(self):
                with self._lock:
                    return self.x
    """}, "all", {"LOCK002"}, ["LOCK002"], []),
    "det101_two_deep": (TWO_DEEP, "scoped", None, ["DET101"], []),
    "det101_local_rules_miss_it": (TWO_DEEP, "scoped", LOCAL_DET, [], []),
    "det101_flags_once": ({"src/PKG/core/direct.py": """
        import time

        def t():
            return time.time()

        def u():
            return t()
    """}, "scoped", None, ["DET001"], []),
    "det102_rng_taint": ({
        "src/PKG/core/refit.py": """
            from PKG.util.rngutil import jitter

            def refit(surface):
                return surface + jitter()
        """,
        "src/PKG/util/rngutil.py": """
            import numpy as np

            def jitter():
                return np.random.normal()
        """}, "scoped", None, ["DET102"], []),
    "det103_global_mutation": ({
        "src/PKG/core/lookup.py": """
            from PKG.util.memo import put

            def lookup(k, v):
                put(k, v)
                return v
        """,
        "src/PKG/util/memo.py": """
            _TABLE: dict = {}

            def put(k, v):
                _TABLE[k] = v
        """}, "scoped", None, ["DET103"], []),
    "det104_set_order": ({
        "src/PKG/core/pick.py": """
            from PKG.util.setutil import first

            def pick(items):
                return first(items)
        """,
        "src/PKG/util/setutil.py": """
            def first(items):
                s = set(items)
                out = []
                for x in s:
                    out.append(x)
                return out
        """}, "scoped", None, ["DET104"], []),
    "suppressed_origin_does_not_taint": ({
        "src/PKG/core/sched.py": TWO_DEEP["src/PKG/core/sched.py"],
        "src/PKG/util/clockwrap.py": """
            import time

            def stamp():
                return _now()

            def _now():
                return time.time()  # repro-lint: disable=DET101 -- metadata
        """}, "scoped", None, [], []),
    "boundary_call_site_suppressed": ({
        "src/PKG/util/clockwrap.py": TWO_DEEP["src/PKG/util/clockwrap.py"],
        "src/PKG/core/sched.py": """
            from PKG.util.clockwrap import stamp

            def admit(now_s):
                return now_s + stamp()  # repro-lint: disable=DET101 -- logged
        """}, "scoped", None, [], ["DET101"]),
    "unit001_addition": ({"src/PKG/core/u.py": """
        def slack(dur_s, rate_mbps):
            return dur_s + rate_mbps
    """}, "scoped", None, ["UNIT001"], []),
    "unit003_mb_over_mbps": ({"src/PKG/netsim/g.py": """
        def xfer(size_mb, rate_mbps):
            wait_s = size_mb / rate_mbps
            return wait_s
    """}, "scoped", None, ["UNIT003"], []),
    "unit002_rate_binding": ({"src/PKG/core/u.py": """
        def goodput(moved_mb, makespan_s):
            rate_mbps = moved_mb / makespan_s
            return rate_mbps
    """}, "scoped", None, ["UNIT002"], []),
    "unit002_return_suffix": ({"src/PKG/core/u.py": """
        def window_s(cap_mb):
            return cap_mb
    """}, "scoped", None, ["UNIT002"], []),
    "unit002_keyword": ({"src/PKG/netsim/u.py": """
        def build(configure, delay_s):
            return configure(bandwidth_mbps=delay_s)
    """}, "scoped", None, ["UNIT002"], []),
    "unit_repo_idioms_clean": ({"src/PKG/netsim/ok.py": """
        def conversions(moved_mb, elapsed_s, bandwidth_mbps, rtt_s):
            goodput_mbps = moved_mb * 8.0 / elapsed_s
            bdp_mb = bandwidth_mbps * rtt_s / 8.0
            halved_s = rtt_s / 2.0
            return goodput_mbps, bdp_mb, halved_s
    """}, "scoped", None, [], []),
    "unit_suppressed": ({"src/PKG/core/u.py": """
        def odd(dur_s, rate_mbps):
            return dur_s + rate_mbps  # repro-lint: disable=UNIT001 -- a score
    """}, "scoped", None, [], ["UNIT001"]),
    "unit_scope_excludes_launch": ({"src/PKG/launch/glue.py": """
        def report(dur_s, rate_mbps):
            return dur_s + rate_mbps
    """}, "scoped", None, [], []),
    "par_inline_reaggregation": ({
        "pkg/fleet.py": """
            import numpy as np

            def assemble_fleet_report(reports):
                return float(np.mean(reports))

            def run(reports):
                return assemble_fleet_report(reports)
        """,
        "pkg/vec.py": """
            import numpy as np

            class Vec:
                def run(self, reports):
                    return float(np.mean(reports))
        """}, "parity", None, ["PAR001", "PAR002"], []),
    "par002_float_sum": ({
        "pkg/fleet.py": PARITY_FLEET,
        "pkg/vec.py": """
            from pkg.fleet import assemble_fleet_report

            def run(reports):
                moved = sum(r.moved_mb for r in reports)
                return assemble_fleet_report(reports), moved
        """}, "parity", None, ["PAR002"], []),
    "par003_drift_copy": ({
        "pkg/fleet.py": PARITY_FLEET,
        "pkg/vec.py": """
            from pkg.fleet import assemble_fleet_report

            def go(reports):
                return assemble_fleet_report(reports)
        """,
        "pkg/other.py": """
            def assemble_fleet_report(reports):
                return len(reports) + 1
        """}, "parity", None, ["PAR003"], []),
    "suppression_with_reason": ({"mod.py": """
        import time

        def f():
            return time.time()  # repro-lint: disable=DET001 -- wall time
    """}, "all", {"DET001"}, [], ["DET001"]),
    "own_line_suppression": ({"mod.py": """
        import time

        def f():
            # repro-lint: disable=DET001 -- the reason sits above
            return time.time()
    """}, "all", {"DET001"}, [], ["DET001"]),
    "sup001_bare_suppression": ({"mod.py": """
        import time

        def f():
            return time.time()  # repro-lint: disable=DET001
    """}, "all", {"DET001", "SUP001"}, ["SUP001"], ["DET001"]),
    "wildcard_suppression": ({"mod.py": """
        import time

        def f():
            return time.time()  # repro-lint: disable=* -- everything
    """}, "all", None, [], ["DET001"]),
    "unrelated_suppression": ({"mod.py": """
        import time

        def f():
            return time.time()  # repro-lint: disable=DET002 -- other rule
    """}, "all", {"DET001"}, ["DET001"], []),
    "syntax_error": ({"broken.py": "def f(:\n    pass\n"}, "all", None,
                     ["PARSE"], []),
}


def _config(pkg_config, kind: str):
    if kind == "scoped":
        return pkg_config.default_config()
    if kind == "all":
        return pkg_config.permissive_config()
    return pkg_config.AnalysisConfig(scopes={}, parity=pkg_config.ParityConfig(
        canonical_module="pkg/fleet.py",
        engine_modules=("pkg/fleet.py", "pkg/vec.py"),
        shared_functions=("assemble_fleet_report", "auto_concurrency"),
        required_calls=("assemble_fleet_report",),
        watch_prefix="pkg/"))


def _write(root: Path, files: dict, pkg: str = "repro_torch") -> None:
    for rel, src in files.items():
        p = root / rel.replace("PKG", pkg)
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(textwrap.dedent(src).replace("PKG", pkg))


def _findings(vs, pkg: str) -> list[tuple]:
    return [(v.rule, v.path.replace(pkg, "PKG"), v.line, v.col) for v in vs]


@pytest.mark.parametrize("name", list(FIXTURES))
def test_both_analyzers_report_the_same_findings(tmp_path, name):
    files, kind, rules, want, want_quiet = FIXTURES[name]
    got = {}
    for pkg, analysis, config in (("repro", ref_analysis, ref_config),
                                  ("repro_torch", port_analysis,
                                   port_config)):
        root = tmp_path / pkg
        _write(root, files, pkg)
        res = analysis.run_analysis([root], root=root,
                                    config=_config(config, kind),
                                    rule_ids=rules)
        got[pkg] = (_findings(res.violations, pkg),
                    _findings(res.suppressed, pkg))
    assert got["repro"] == got["repro_torch"]
    violations, quiet = got["repro_torch"]
    assert [v[0] for v in violations] == want
    assert [v[0] for v in quiet] == want_quiet


def test_module_name_maps_the_port():
    assert module_name("src/repro_torch/core/fleet.py") == \
        "repro_torch.core.fleet"
    assert module_name("src/repro_torch/core/__init__.py") == \
        "repro_torch.core"
    assert module_name("pkg/a.py") == "pkg.a"


# ------------------------------------------------------------------ #
# the kernel contract on the port's layout
# ------------------------------------------------------------------ #
KER = {"KER001", "KER002", "KER003"}


def _kernel_corpus(**overrides):
    files = {
        "src/repro_torch/kernels/__init__.py": "",
        "src/repro_torch/kernels/_build.py": """
            def load(name):
                return name
        """,
        "src/repro_torch/kernels/csrc/foo.cu": "// a kernel\n",
        "src/repro_torch/kernels/foo.py": """
            from repro_torch.kernels import _build

            launches = 0

            def foo_cuda(x):
                _build.load("foo")
                return x
        """,
        "src/repro_torch/kernels/ref.py": """
            def foo_ref(x):
                return x
        """,
        "src/repro_torch/kernels/ops.py": """
            from repro_torch.kernels import ref

            def foo(x):
                if x.is_cuda:
                    from repro_torch.kernels.foo import foo_cuda
                    return foo_cuda(x)
                return ref.foo_ref(x)
        """,
        "tests/test_torch_kernels.py": """
            from repro_torch.kernels.foo import foo_cuda
            from repro_torch.kernels import ref

            def test_foo_parity():
                assert foo_cuda(1) == ref.foo_ref(1)
        """,
    }
    files.update(overrides)
    return files


def _ker_scan(tmp_path, files, rules=KER):
    _write(tmp_path, files)
    return port_analysis.run_analysis(
        [tmp_path], root=tmp_path, config=port_config.permissive_config(),
        rule_ids=rules)


def _fired(res):
    return [v.rule for v in res.violations]


def test_kernel_contract_complete_corpus_is_clean(tmp_path):
    assert _ker_scan(tmp_path, _kernel_corpus()).ok


def test_ker001_kernel_without_dispatch(tmp_path):
    res = _ker_scan(tmp_path, _kernel_corpus(**{
        "src/repro_torch/kernels/ops.py": """
            from repro_torch.kernels import ref

            def unrelated(x):
                return ref.foo_ref(x)
        """}), {"KER001"})
    assert _fired(res) == ["KER001"]
    v = res.violations[0]
    assert v.path == "src/repro_torch/kernels/foo.py" and v.line == 6
    assert "foo_cuda" in v.message


def test_ker002_dispatch_with_a_dead_twin(tmp_path):
    res = _ker_scan(tmp_path, _kernel_corpus(**{
        "src/repro_torch/kernels/ref.py": """
            def unrelated_ref(x):
                return x
        """}), {"KER002"})
    assert _fired(res) == ["KER002"]
    assert "reference implementation" in res.violations[0].message


def test_ker002_twin_reached_through_an_ops_helper(tmp_path):
    """``_flash_attention`` reaches its twins through ``plain_attention``;
    a card test naming the helper and calling the public function holds
    it (KER003)."""
    res = _ker_scan(tmp_path, _kernel_corpus(**{
        "src/repro_torch/kernels/ops.py": """
            from repro_torch.kernels import ref

            def plain_foo(x):
                return ref.foo_ref(x)

            def _foo(x):
                if x.is_cuda:
                    from repro_torch.kernels.foo import foo_cuda
                    return foo_cuda(x)
                return plain_foo(x)

            def foo(x):
                return _foo(x)
        """,
        "tests/test_torch_kernels.py": """
            import pytest
            from repro_torch.kernels import ops

            @pytest.mark.cuda
            def test_foo_on_card(cuda):
                assert ops.foo(cuda) == ops.plain_foo(cuda)
        """}))
    assert res.ok, [v.format() for v in res.violations]


def test_ker003_kernel_without_parity_test(tmp_path):
    res = _ker_scan(tmp_path, _kernel_corpus(**{
        "tests/test_torch_kernels.py": """
            def test_something_else():
                assert True
        """}), {"KER003"})
    assert _fired(res) == ["KER003"]
    assert "parity test" in res.violations[0].message


@pytest.mark.parametrize("marked,helper", [(True, False), (True, True),
                                           (False, False)])
def test_ker003_a_card_test_through_the_dispatch(tmp_path, marked, helper):
    """A ``cuda``-marked test that calls the dispatch and names a twin (in
    its body or through a helper of its file) holds the kernel; the same
    test unmarked runs on the CPU, where the dispatch takes the twin, and
    does not."""
    twin = "_twin(x)" if helper else "ref.foo_ref(x)"
    res = _ker_scan(tmp_path, _kernel_corpus(**{
        "tests/test_torch_lm_kernels.py": f"""
            import pytest
            from repro_torch.kernels import ops, ref

            def _twin(x):
                return ref.foo_ref(x)

            {"@pytest.mark.cuda" if marked else ""}
            def test_foo_dispatch(x):
                assert ops.foo(x) == {twin}
        """,
        "tests/test_torch_kernels.py": ""}), {"KER003"})
    assert _fired(res) == ([] if marked else ["KER003"])


def test_a_module_without_its_cuda_source_is_not_a_kernel(tmp_path):
    """No ``csrc/foo.cu``: ``foo.py`` is no kernel module, so nothing is
    owed for it, even with no dispatch at all."""
    _write(tmp_path, _kernel_corpus(**{
        "src/repro_torch/kernels/ops.py": ""}))
    (tmp_path / "src/repro_torch/kernels/csrc/foo.cu").unlink()
    res = port_analysis.run_analysis(
        [tmp_path], root=tmp_path, config=port_config.permissive_config(),
        rule_ids=KER)
    assert res.ok


# ------------------------------------------------------------------ #
# capture rules
# ------------------------------------------------------------------ #
def _trace_scan(tmp_path, src, rules):
    _write(tmp_path, {"mod.py": src})
    return port_analysis.run_analysis(
        [tmp_path], root=tmp_path, config=port_config.permissive_config(),
        rule_ids=rules)


def test_trace001_branch_on_a_tensor_in_a_compiled_function(tmp_path):
    res = _trace_scan(tmp_path, """
        import torch

        @torch.compile
        def step(x):
            if x.sum() > 0:
                return x
            return -x
    """, {"TRACE001"})
    assert _fired(res) == ["TRACE001"]
    v = res.violations[0]
    assert v.line == 6 and "`step`" in v.message and "`x`" in v.message


def test_trace001_static_reads_and_uncaptured_functions_are_clean(tmp_path):
    res = _trace_scan(tmp_path, """
        import functools
        import torch

        @functools.partial(torch.compile, mode="reduce-overhead")
        def step(x, mask=None):
            n = x.shape[0]
            if n > 4 and x.ndim == 2 and x.dtype == torch.bfloat16:
                x = x * 2
            if x.device.type == "cuda" and x.numel() > 8:
                x = x + 1
            if mask is None:
                return x
            return torch.where(mask, x, -x)

        def eager(x):
            if x.sum() > 0:
                return x.item()
            return float(x)
    """, {"TRACE001"})
    assert res.ok, [v.format() for v in res.violations]


def test_trace001_host_reads_in_each_capture_form(tmp_path):
    res = _trace_scan(tmp_path, """
        import torch

        def decode(x, cache):
            n = int(cache[0])
            return x + n

        def fwd(x):
            return x.tolist()

        def body(x):
            while x.max() > 1:
                x = x / 2
            return x

        compiled = torch.compile(body)
        graphed = torch.cuda.make_graphed_callables(fwd, (torch.ones(1),))
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            out = decode(torch.ones(1), torch.ones(1))
    """, {"TRACE001"})
    assert [(v.rule, v.line) for v in res.violations] == [
        ("TRACE001", 5), ("TRACE001", 9), ("TRACE001", 12)]


def test_trace002_python_state_written_in_a_captured_function(tmp_path):
    res = _trace_scan(tmp_path, """
        import torch

        STEPS = 0

        class Decoder:
            def __init__(self):
                self.cache = torch.zeros(4)
                self.calls = 0

            @torch.compile
            def step(self, x, i):
                global STEPS
                self.calls += 1
                self.cache.copy_(x)
                self.cache[i] = x.sum()
                x.add_(1)
                return x
    """, {"TRACE002"})
    assert [(v.rule, v.line) for v in res.violations] == [
        ("TRACE002", 13), ("TRACE002", 14)]


# ------------------------------------------------------------------ #
# the port itself
# ------------------------------------------------------------------ #
def test_self_scan_of_the_port_is_clean_and_finds_six_kernels():
    """``python -m repro_torch.analysis src/repro_torch`` holds on the tree
    it ships in, every family on, and the kernel contract sees all six
    kernels, each with its dispatch."""
    res = port_analysis.run_analysis([REPO / "src" / "repro_torch"],
                                     root=REPO,
                                     config=port_config.default_config())
    assert res.ok, "\n".join(v.format() for v in res.violations)
    assert res.files_scanned > 100
    for v in res.suppressed:
        assert v.suppress_reason, v.format()
    corpus = Corpus(root=REPO, modules={},
                    config=port_config.default_config())
    entries = {e.cuda_fn: e.source for e in _kernel_entries(corpus)}
    assert entries == {
        "cluster_assign_cuda": "cluster_assign",
        "nat_spline_fit_cuda": "spline_fit",
        "batched_predict_argmax_cuda": "transfer_select",
        "flash_attention_cuda": "flash_attention",
        "ssd_scan_cuda": "ssd_scan",
        "rwkv6_cuda": "rwkv6"}
    assert set(_dispatch_map(corpus)) == set(entries)


def test_cli_entry_point(tmp_path, capsys):
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis", "src/repro_torch"],
        capture_output=True, text=True, cwd=REPO, timeout=300,
        env=dict(os.environ, PYTHONPATH=str(REPO / "src")))
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-2000:]
    assert "0 violations" in proc.stdout
    assert cli_main(["--list-rules"]) == 0
    listed = capsys.readouterr().out
    assert "TRACE001  [tracing]" in listed and "KER003" in listed
    _write(tmp_path, {"mod.py": """
        import time

        def f():
            return time.time()
    """})
    out = tmp_path / "r.json"
    assert cli_main([str(tmp_path), "--root", str(tmp_path), "--no-scope",
                     "--format", "json", "--out", str(out)]) == 1
    capsys.readouterr()
    report = json.loads(out.read_text())
    assert [v["rule"] for v in report["violations"]] == ["DET001"]
    assert cli_main([str(tmp_path / "missing")]) == 2
