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

from repro_torch.checkpoint.ckpt import restore_checkpoint, save_checkpoint
from repro_torch.checkpoint.tuning import CheckpointTuner
from repro_torch.core import (
    FleetRequest, SurfaceStack, TransferTuner, TunerConfig, fit_clusters,
    offline_analysis, offline_db_from_state, run_fleet,
)
from repro_torch.core.baselines import ALL_BASELINES, ANNOT
from repro_torch.core.spline import BicubicSpline, CubicSpline1D
from repro_torch.data.pipeline import DataConfig, TokenPipeline
from repro_torch.device import resolve_device, resolve_use_kernel
from repro_torch.kernels import ops, ref
from repro_torch.configs import get_config
from repro_torch.kernels.cluster_assign import cluster_assign_cuda
from repro_torch.kernels.flash_attention import flash_attention_cuda
from repro_torch.kernels.rwkv6 import rwkv6_cuda
from repro_torch.kernels.spline_fit import nat_spline_fit_cuda
from repro_torch.kernels.ssm_scan import ssd_scan_cuda
from repro_torch.kernels.transfer_select import batched_predict_argmax_cuda
from repro_torch.launch import serve
from repro_torch.launch import train as train_cli
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models.model import Model, build_model
from repro_torch.netsim import ParamBounds, make_dataset
from repro_torch.optim import AdamWConfig, adamw_init, cosine_schedule
from repro_torch.train import elastic
from repro_torch.train.loop import TrainConfig, Trainer, make_train_step

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "src" / "repro_torch"
FORBIDDEN = {"jax", "jaxlib", "repro", "ml_dtypes"}


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
    # the training, distribution, launch-tooling and analysis slices are
    # among the files checked
    analysis = ["analysis/" + f for f in (
        "__init__.py", "__main__.py", "astutil.py", "base.py", "cli.py",
        "config.py", "dataflow.py", "engine.py", "report.py")]
    analysis += ["analysis/rules/" + f for f in (
        "__init__.py", "determinism.py", "interprocedural.py",
        "kernel_contract.py", "locks.py", "meta.py", "parity.py",
        "tracing.py", "units.py")]
    for rel in ["optim/adamw.py", "optim/grad_utils.py", "optim/schedule.py",
                "train/loop.py", "train/elastic.py", "train/straggler.py",
                "launch/train.py", "launch/mesh.py", "dist/sharding.py",
                "dist/collectives.py", "dist/pipeline_par.py",
                "launch/shapes.py", "launch/roofline.py",
                "launch/dryrun.py"] + analysis:
        assert PORT / rel in _port_files(), rel


def test_every_port_module_imports_with_jax_and_repro_blocked():
    code = (
        "import sys, importlib, pkgutil\n"
        "sys.modules['jax'] = sys.modules['repro'] = None\n"
        "sys.modules['ml_dtypes'] = None\n"
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
    assert int(out.stdout.strip().splitlines()[-1]) >= 80


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
    # a dense and a MoE model built with no device raise rather than fall
    # back to the CPU; asked for the CPU by name they build there
    for arch in ("minitron-4b", "mixtral-8x22b"):
        cfg = get_config(arch, "smoke")
        with pytest.raises(RuntimeError, match="device='cpu'"):
            Model(cfg)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            build_model(cfg)
        model = build_model(cfg, "cpu")
        assert model.cfg.use_kernel is False
        assert all(p.device.type == "cpu" for p in model.parameters())


def test_baseline_spline_and_checkpoint_entry_points_default_to_the_card(
        no_cuda, tmp_path):
    """ANN+OT trains, the spline classes fit and a checkpoint restores on
    the card unless the CPU is asked for by name; saving takes tensors
    wherever they are, and the other baselines and the pipeline are numpy."""
    from repro_torch.netsim import generate_history, make_testbed
    hist = generate_history(make_testbed("xsede", seed=3), days=1,
                            transfers_per_day=40, seed=0)
    assert list(ALL_BASELINES)[4] == "ANN+OT"
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ANNOT(hist, epochs=1)
    assert ANNOT(hist, epochs=1, device="cpu").device.type == "cpu"
    with pytest.raises(RuntimeError):
        CubicSpline1D.fit([1.0, 2.0, 3.0], [1.0, 0.0, 1.0])
    with pytest.raises(RuntimeError):
        BicubicSpline.fit([1.0, 2.0], [1.0, 2.0], np.eye(2))
    assert CubicSpline1D.fit([1.0, 2.0, 3.0], [1.0, 0.0, 1.0],
                             device="cpu").x.device.type == "cpu"
    d = str(tmp_path / "ckpt")
    save_checkpoint(d, 1, {"w": torch.ones(4)})
    with pytest.raises(RuntimeError, match="device='cpu'"):
        restore_checkpoint(d)
    assert restore_checkpoint(d, device="cpu")["w"].device.type == "cpu"
    log = str(tmp_path / "log.jsonl")
    CheckpointTuner(log).seed_history({"w": torch.ones(4)}, d, n_probes=8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        CheckpointTuner(log).fit()
    assert CheckpointTuner(log, device="cpu").fit().recommend().cc >= 1
    pipe = TokenPipeline(DataConfig(vocab_size=10, global_batch=2, seq_len=4))
    try:
        assert isinstance(pipe.next_batch()["tokens"], np.ndarray)
    finally:
        pipe.close()


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
    q = torch.from_numpy(rng.normal(size=(1, 8, 2, 16)).astype(np.float32))
    assert torch.equal(ops.flash_attention(q, q, q),
                       ref.attention_ref(q, q, q))
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_cuda(q, q, q)
    x = torch.from_numpy(rng.normal(size=(1, 8, 2, 4)).astype(np.float32))
    dt = torch.full((1, 8, 2), 0.1)
    A = -torch.ones(2)
    Bm = torch.from_numpy(rng.normal(size=(1, 8, 3)).astype(np.float32))
    assert torch.equal(ops.ssd_scan(x, dt, A, Bm, Bm, chunk=4),
                       ref.ssd_chunked_ref(x, dt, A, Bm, Bm, chunk=4))
    with pytest.raises(ValueError, match="CUDA"):
        ssd_scan_cuda(x, dt, A, Bm, Bm, chunk=4)
    r = torch.from_numpy(rng.normal(size=(1, 6, 2, 4)).astype(np.float32))
    w = -torch.full((1, 6, 2, 4), 0.5)
    u = torch.ones((2, 4))
    s0 = torch.from_numpy(rng.normal(size=(1, 2, 4, 4)).astype(np.float32))
    for got, want in zip(
            ops.rwkv6_scan(r, r, r, w, u, chunk=4, initial_state=s0,
                           return_state=True),
            ref.rwkv6_chunked_ref(r, r, r, w, u, chunk=4, initial_state=s0,
                                  return_state=True)):
        assert torch.equal(got, want)
    with pytest.raises(ValueError, match="CUDA"):
        rwkv6_cuda(r, r, r, w, u, chunk=4)


def test_serving_entry_points_default_to_the_card(no_cuda, capsys):
    """The model, its prompts and the serve launcher run on the card
    unless the CPU is asked for by name."""
    cfg = get_config("zamba2-7b", "smoke")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Model(cfg)
    with pytest.raises(RuntimeError):
        build_model(cfg)
    with pytest.raises(RuntimeError):
        serve.make_prompts(cfg, 2, 4)
    with pytest.raises(RuntimeError):
        serve.main(["--arch", "zamba2-7b", "--variant", "smoke"])
    model = build_model(cfg, "cpu")
    assert model.cfg.use_kernel is False and model.device.type == "cpu"
    res = serve.main(["--arch", "zamba2-7b", "--device", "cpu", "--batch",
                      "1", "--prompt-len", "4", "--tokens", "2"])
    assert res.tokens.shape == (1, 2)
    assert "device: cpu" in capsys.readouterr().out
    rw = get_config("rwkv6-1.6b", "smoke")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Model(rw)
    with pytest.raises(RuntimeError):
        serve.main(["--arch", "rwkv6-1.6b", "--variant", "smoke"])
    model = build_model(rw, "cpu")
    assert model.cfg.use_kernel is False and model.device.type == "cpu"
    ds = get_config("deepseek-v3-671b", "smoke")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Model(ds)
    with pytest.raises(RuntimeError):
        serve.main(["--arch", "deepseek-v3-671b", "--variant", "smoke"])
    model = build_model(ds, "cpu")
    assert model.cfg.use_kernel is False and model.device.type == "cpu"


def test_training_entry_points_default_to_the_card(no_cuda, tmp_path,
                                                   capsys):
    """The training launcher with no ``--device`` asks for the card and
    raises here, as ``resolve_device`` does, rather than train on the
    CPU; so does recovery from a checkpoint.  Asked for the CPU by name,
    the launcher trains there, and the trainer runs on the model's
    device."""
    args = ["--arch", "minitron-4b", "--variant", "smoke", "--steps", "1",
            "--global-batch", "2", "--seq", "8", "--ckpt-dir",
            str(tmp_path / "run")]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_cli.main(args)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        elastic.recover(str(tmp_path / "run"), {}, [0])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_host_mesh()
    log = train_cli.main(args + ["--device", "cpu"])
    assert len(log) == 1 and "device: cpu" in capsys.readouterr().out
    model = build_model(get_config("minitron-4b", "smoke"), "cpu")
    trainer = Trainer(model, TrainConfig(), seed=0)
    assert all(p.device.type == "cpu" and p.requires_grad
               for p in trainer.params.values())
    assert trainer.opt_state["step"].device.type == "cpu"
    assert float(cosine_schedule(trainer.opt_state["step"])) == 0.0
    assert adamw_init(model, AdamWConfig())["m"]["embedding"].device.type \
        == "cpu"
    assert callable(make_train_step(model, TrainConfig()))


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
