"""What a run may load: the references import nothing of the program or of
JAX; the import check compares whole top-level names; ``run.py`` refuses
to print a result without a card or without the program beside it."""
from __future__ import annotations

import ast
import shutil
import subprocess
import sys

from bench import harness

REFERENCE = harness.BENCH / "reference"
ALLOWED = {"__future__", "math", "torch", "torch.nn.functional",
           "bench.reference.layers", "bench.reference.quant"}


def _imports(path) -> set[str]:
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            names.add(node.module)
    return names


def test_reference_imports_only_torch_and_itself():
    files = sorted(REFERENCE.glob("*.py"))
    assert {f.stem for f in files} >= {"hybrid", "dense", "layers", "quant"}
    for f in files:
        assert _imports(f) <= ALLOWED, f.name


def test_reference_loads_no_program_in_a_fresh_process():
    code = ("import sys; import bench.reference.hybrid, bench.reference.dense;"
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT,
                         capture_output=True, text=True, check=True,
                         timeout=120).stdout
    loaded = set(eval(out))
    assert not loaded & {"repro_torch", "repro", "jax", "jaxlib", "flax"}


def test_forbidden_modules_compare_whole_names(monkeypatch):
    for name in ("repro_torch", "repro_torch.models", "jaxtyping", "reprox"):
        monkeypatch.setitem(sys.modules, name, sys)
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "repro.core", sys)
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert harness.forbidden_modules() == ["jax", "repro"]


def _run(cwd, *extra):
    return subprocess.run(
        [sys.executable, "bench/run.py", "--workload", "zamba2-7b.prefill",
         "--seed", "3", "--seconds", "1", *extra],
        cwd=cwd, capture_output=True, text=True, timeout=300)


def test_no_card_no_result():
    import torch
    if torch.cuda.is_available():
        return      # the card's own test below runs the cell
    res = _run(harness.ROOT)
    assert res.returncode != 0 and res.stdout.strip() == ""
    assert "CUDA" in res.stderr


def test_benchmark_files_alone_give_no_result(tmp_path):
    shutil.copy(harness.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(harness.BENCH, tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    res = _run(tmp_path)
    assert res.returncode != 0 and res.stdout.strip() == ""


def test_unknown_cell_no_result():
    res = subprocess.run([sys.executable, "bench/run.py", "--workload", "nope",
                          "--seed", "1", "--seconds", "1"], cwd=harness.ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode != 0 and res.stdout.strip() == ""
