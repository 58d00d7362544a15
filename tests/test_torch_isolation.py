"""The PyTorch port stands alone: it imports neither jax nor the JAX package,
and its entry points run on the CUDA card unless the caller asks for the CPU.
"""
import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core import (
    FleetRequest, SurfaceStack, TransferTuner, TunerConfig, fit_clusters,
    offline_analysis, offline_db_from_state, run_fleet,
)
from repro_torch.device import resolve_device, resolve_use_kernel
from repro_torch.kernels import ops, ref
from repro_torch.kernels.cluster_assign import cluster_assign_cuda
from repro_torch.kernels.spline_fit import nat_spline_fit_cuda
from repro_torch.kernels.transfer_select import batched_predict_argmax_cuda
from repro_torch.netsim import ParamBounds, make_dataset

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "src" / "repro_torch"
FORBIDDEN = {"jax", "jaxlib", "repro"}


def _port_files():
    return sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]


def _env():
    return dict(os.environ, PYTHONPATH=str(REPO / "src"))


def test_port_files_import_neither_jax_nor_the_jax_package():
    offenders = []
    for path in _port_files():
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                assert node.level == 0, f"relative import in {path}"
                names = [node.module or ""]
            else:
                continue
            offenders += [f"{path.relative_to(REPO)}:{node.lineno} {n}"
                          for n in names if n.split(".")[0] in FORBIDDEN]
    assert not offenders, offenders
    assert len(_port_files()) > 20


def test_every_port_module_imports_with_jax_and_repro_blocked():
    code = (
        "import sys, importlib, pkgutil\n"
        "sys.modules['jax'] = sys.modules['repro'] = None\n"
        "import repro_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(\n"
        "    repro_torch.__path__, 'repro_torch.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        f"sys.path.insert(0, {str(REPO)!r})\n"
        "import chip_smoke\n"
        "assert 'jax' not in [m.split('.')[0] for m in sys.modules\n"
        "                     if sys.modules[m] is not None]\n"
        "print(len(names))\n")
    out = subprocess.run([sys.executable, "-c", code], env=_env(),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip().splitlines()[-1]) >= 44


# ------------------------------------------------------------------ #
# the device rule
# ------------------------------------------------------------------ #
@pytest.fixture
def no_cuda(monkeypatch):
    """Make this process look like a machine without a card."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_resolve_device_raises_without_cuda(no_cuda):
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    with pytest.raises(RuntimeError):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")
    assert resolve_device(torch.device("cpu")) == torch.device("cpu")


def test_use_kernel_none_means_kernel_on_cuda_only():
    assert resolve_use_kernel(None, "cuda") is True
    assert resolve_use_kernel(None, "cpu") is False
    assert resolve_use_kernel(True, "cpu") is True
    assert resolve_use_kernel(False, "cuda") is False


def test_entry_points_default_to_the_card(no_cuda):
    X = np.random.default_rng(0).normal(size=(64, 4))
    with pytest.raises(RuntimeError):
        fit_clusters(X, m_range=range(2, 4))
    with pytest.raises(RuntimeError):
        offline_analysis([])
    with pytest.raises(RuntimeError):
        TransferTuner(TunerConfig()).fit([])
    with pytest.raises(RuntimeError):
        offline_db_from_state({})
    # asking for the CPU by name runs
    assert fit_clusters(X, m_range=range(2, 4), device="cpu").m in (2, 3)


def test_fleet_entry_points_default_to_the_card(no_cuda, tmp_path):
    """A DB made without a device lives on the card, so the fleet's batched
    admission view of it, and a fleet run that builds that view, raise here;
    a DB made on the CPU by name runs."""
    with pytest.raises(RuntimeError):
        SurfaceStack.from_surfaces([], ParamBounds())
    from repro_torch.netsim import generate_history, make_testbed
    hist = generate_history(make_testbed("xsede", seed=3), days=1,
                            transfers_per_day=60, seed=0)
    db = TransferTuner(TunerConfig(seed=0, device="cpu")).fit(hist).db
    reqs = [FleetRequest(make_dataset("small", 3), env_seed=1)]
    for ck in db.clusters:
        ck.device = None                # as if the DB had been made bare
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_fleet(db, reqs)
    for ck in db.clusters:
        ck.device = torch.device("cpu")
    assert len(run_fleet(db, reqs).reports) == 1


def test_ops_route_by_tensor_device_and_cuda_wrappers_refuse_cpu_tensors():
    rng = np.random.default_rng(1)
    X = torch.from_numpy(rng.normal(size=(100, 4)).astype(np.float32))
    C = torch.from_numpy(rng.normal(size=(5, 4)).astype(np.float32))
    for got, want in zip(ops.cluster_assign(X, C), ref.cluster_assign_ref(X, C)):
        assert torch.equal(got, want)
    x = torch.tensor([1.0, 2.0, 4.0, 8.0])
    Y = torch.from_numpy(rng.normal(size=(7, 4)).astype(np.float32))
    assert torch.equal(ops.nat_spline_fit(x, Y), ref.nat_spline_fit_ref(x, Y))
    with pytest.raises(ValueError, match="CUDA"):
        cluster_assign_cuda(X, C)
    with pytest.raises(ValueError, match="CUDA"):
        nat_spline_fit_cuda(x, Y)
    values = torch.from_numpy(rng.normal(size=(3, 64)).astype(np.float32))
    idx = torch.from_numpy(rng.integers(0, 64, (9, 4)).astype(np.int32))
    for got, want in zip(ops.transfer_predict_argmax(values, idx),
                         ref.batched_predict_argmax_ref(values, idx)):
        assert torch.equal(got, want)
    with pytest.raises(ValueError, match="CUDA"):
        batched_predict_argmax_cuda(values, idx)


def _smoke(cwd):
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          env=dict(os.environ, CUDA_VISIBLE_DEVICES=""),
                          capture_output=True, text=True, timeout=300)


def test_chip_smoke_fails_without_a_card_and_without_the_repo(tmp_path):
    out = _smoke(REPO)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    out = _smoke(tmp_path)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
