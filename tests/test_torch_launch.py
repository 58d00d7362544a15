"""The port's launch tooling (``repro_torch.launch.{shapes,mesh,roofline,
dryrun}``) against the JAX package's, on the CPU; it mirrors
``tests/test_dryrun_launch.py``.

- The dry-run CLI in a subprocess (a default process group starts once a
  process) for rwkv6-1.6b x decode_32k on both production meshes: 256 and
  512 ranks, no error row, FLOPs and peak above 0.
- Its memory rows against the reference's dry run (in a subprocess of its
  own, ``jax_subprocess_env``) on the 16x16 mesh for rwkv6-1.6b, mixtral-
  8x22b and musicgen-large x decode_32k: ``n_devices`` and
  ``degraded_shardings`` equal; ``bytes_per_device["argument"]`` equal,
  but for musicgen's 65,536 bytes: ``jax.jit`` prunes the arguments a
  program never reads (``keep_unused=False``), and musicgen's decode
  never reads its ``embed`` and ``head`` (its codebooks have their own),
  which the port's resting state counts.  FLOPs are not compared: the
  port's are its data-parallel compute on whole local tensors, the
  reference's an SPMD partition.
- ``CollectiveCounter`` on a 4-rank fake group against the reference HLO
  parser's three cases (bf16 [16, 1024] all-gather 32,768 B, f32 [256]
  all-reduce 1,024 B, bf16 [8, 8] permute 128 B), and a functional
  all-reduce counted once; ``make_production_mesh``'s shapes and its
  refusal of other world sizes.
- ``roofline_terms`` at the H100's constants, and equal to the
  reference's under the reference's constants for all 33 cells, with
  ``model_flops``; ``applicable_cells``, ``input_specs``, the configs'
  ``n_active_params_est`` and ``Model.cache_axes`` equal to the
  reference's.
- The cost mode's two-depth extrapolation equal to a full-depth count, on
  a 6-layer cut of minitron-4b's smoke config (decode, prefill, train).
"""
import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import pytest

from repro.configs import all_archs as jall_archs
from repro.configs import get_config as jget
from repro.launch import roofline as jroofline
from repro.launch import shapes as jshapes
from repro.models.model import build_model as jbuild
from repro_torch.configs import get_config
from repro_torch.launch import roofline, shapes
from repro_torch.models.model import build_model

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PARITY_ARCHS = ("rwkv6-1.6b", "mixtral-8x22b", "musicgen-large")
CELLS = jshapes.applicable_cells()


def _port_env() -> dict:
    return dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))


def _python(code: str, env: dict, timeout: int = 300) -> str:
    """stdout of ``code`` run in a fresh interpreter from the repo root."""
    proc = subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                          capture_output=True, text=True, env=env,
                          timeout=timeout, cwd=REPO)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return proc.stdout


def _rows(stdout: str) -> list[dict]:
    return json.loads(stdout.strip().splitlines()[-1])


# ------------------------------------------------------------------ #
# the dry run
# ------------------------------------------------------------------ #
@pytest.fixture(scope="module")
def port_cli_rows(tmp_path_factory):
    """The port's dry-run CLI, rwkv6-1.6b x decode_32k on both meshes."""
    out = tmp_path_factory.mktemp("dryrun") / "dr.json"
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun",
         "--arch", "rwkv6-1.6b", "--shape", "decode_32k", "--both-meshes",
         "--out", str(out)],
        capture_output=True, text=True, env=_port_env(), timeout=300,
        cwd=REPO)
    assert proc.returncode == 0, proc.stderr[-3000:]
    with open(out) as f:
        return {r["mesh"]: r for r in json.load(f)}


@pytest.mark.parametrize("mesh,n", [("16x16", 256), ("2x16x16", 512)])
def test_dryrun_cell_runs_on_the_production_mesh(port_cli_rows, mesh, n):
    r = port_cli_rows[mesh]
    assert "error" not in r, r
    assert r["arch"] == "rwkv6-1.6b" and r["shape"] == "decode_32k"
    assert r["n_devices"] == n
    assert r["flops_total"] > 0
    assert r["bytes_per_device"]["peak"] > 0
    assert r["bytes_per_device"]["temp"] > 0
    # the reference's keys, every one
    assert set(r) == {"arch", "shape", "mesh", "n_devices", "flops_total",
                      "bytes_accessed", "collective_bytes",
                      "collective_bytes_total", "bytes_per_device",
                      "degraded_shardings", "lower_s", "compile_s"}
    assert set(r["bytes_per_device"]) == {"argument", "output", "temp",
                                          "peak"}
    # serving replicas: a decode step issues no collective
    assert r["collective_bytes_total"] == 0.0


@pytest.fixture(scope="module")
def memory_rows():
    """(port rows, reference rows) for ``PARITY_ARCHS`` x decode_32k on
    the 16x16 mesh, each package in a process of its own."""
    run = """
        import json
        from {pkg}.launch import dryrun
        print(json.dumps([dryrun.run_cell(a, "decode_32k", multi_pod=False,
                                          verbose=False) for a in {archs}]))
    """
    port = _rows(_python(run.format(pkg="repro_torch",
                                    archs=PARITY_ARCHS), _port_env()))
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    env.pop("XLA_FLAGS", None)         # the reference's dryrun sets its own
    ref = _rows(_python(run.format(pkg="repro", archs=PARITY_ARCHS), env,
                        timeout=600))
    return ({r["arch"]: r for r in port}, {r["arch"]: r for r in ref})


@pytest.mark.parametrize("arch", PARITY_ARCHS)
def test_dryrun_memory_rows_match_the_reference(memory_rows, arch):
    port, ref = memory_rows[0][arch], memory_rows[1][arch]
    assert "error" not in port and "error" not in ref, (port, ref)
    assert port["n_devices"] == ref["n_devices"] == 256
    assert port["degraded_shardings"] == ref["degraded_shardings"]
    got = port["bytes_per_device"]["argument"]
    want = ref["bytes_per_device"]["argument"]
    if arch == "musicgen-large":
        # XLA pruned the unread ``embed`` (V, d) and ``head`` (d, V), bf16,
        # each split 256 ways (vocab over model, embed over data)
        cfg = get_config(arch)
        assert got - want == 2 * cfg.vocab_size * cfg.d_model * 2 // 256
    else:
        assert got == want


def test_collective_counter_and_production_mesh():
    """A 4-rank fake group: the reference parser's three cases through
    ``CollectiveCounter`` (and its parser on the same HLO), a functional
    all-reduce counted once; then ``make_production_mesh`` on 256 and 512
    ranks, and its refusal of 4."""
    out = _rows(_python("""
        import json
        import torch
        import torch.distributed as dist
        import torch.distributed._functional_collectives as funcol
        from repro_torch.launch.dryrun import (CollectiveCounter,
                                               fake_process_group)
        from repro_torch.launch.mesh import make_production_mesh
        res = {}
        with fake_process_group(4):
            bf = torch.bfloat16
            with CollectiveCounter() as c:
                dist.all_gather_into_tensor(torch.empty(16, 1024, dtype=bf),
                                            torch.ones(4, 1024, dtype=bf))
                dist.all_reduce(torch.ones(256))
                ops = [dist.P2POp(dist.isend, torch.ones(8, 8, dtype=bf), 1),
                       dist.P2POp(dist.irecv, torch.empty(8, 8, dtype=bf), 3)]
                for work in dist.batch_isend_irecv(ops):
                    work.wait()
            res["c10d"] = c.bytes
            with CollectiveCounter() as c:
                funcol.all_reduce(torch.ones(64), "sum", dist.group.WORLD
                                  ).wait()
            res["funcol"] = c.bytes
            try:
                make_production_mesh(device="cpu")
            except ValueError as e:
                res["refused"] = str(e)
        for mp, n in ((False, 256), (True, 512)):
            with fake_process_group(n):
                m = make_production_mesh(multi_pod=mp, device="cpu")
                res[str(n)] = [list(m.shape), list(m.mesh_dim_names)]
        print(json.dumps(res))
    """, _port_env()))
    from repro.launch.dryrun import collective_bytes
    hlo = """
  %ag = bf16[16,1024]{1,0} all-gather(%x), replica_groups={{0,1}}
  %ar = f32[256]{0} all-reduce(%y), to_apply=%add
  %cp.1 = bf16[8,8]{1,0} collective-permute(%z), source_target_pairs={{0,1}}
"""
    want = collective_bytes(hlo)
    assert want == {"all-gather": 32768.0, "all-reduce": 1024.0,
                    "collective-permute": 128.0}
    assert out["c10d"] == want
    assert out["funcol"] == {"all-reduce": 256.0}
    assert "needs 256 ranks, the process group has 4" in out["refused"]
    assert out["256"] == [[16, 16], ["data", "model"]]
    assert out["512"] == [[2, 16, 16], ["pod", "data", "model"]]


@pytest.mark.parametrize("shape", ["decode_32k", "prefill_32k", "train_4k"])
def test_cost_mode_extrapolation_equals_a_full_depth_count(shape):
    """Two depths extrapolated to 6 layers equal the 6-layer count, in
    FLOPs, bytes and collective bytes (the port's loop counts every layer;
    the reference needs the extrapolation for its scan)."""
    out = _rows(_python(f"""
        import dataclasses, json
        from repro_torch.configs import get_config
        from repro_torch.kernels import ops
        from repro_torch.launch import dryrun
        from repro_torch.launch.shapes import SHAPES
        cfg = dataclasses.replace(get_config("minitron-4b", "smoke"),
                                  n_layers=6)
        cost = dryrun.run_cost_cell("minitron-4b", "{shape}", cfg=cfg,
                                    verbose=False)
        ops.BLOCKED_ATTENTION_THRESHOLD = 1 << 62
        with dryrun.fake_process_group(256):
            full = dryrun._lower_and_analyze(
                cfg, "minitron-4b", SHAPES["{shape}"], multi_pod=False,
                micro_override=1, verbose=False)
        print(json.dumps([cost, full]))
    """, _port_env()))
    cost, full = out
    assert cost["mode"] == "cost" and cost["depths_measured"] == [1, 2]
    assert cost["per_layer_flops"] > 0
    for key in ("flops_total", "bytes_accessed", "collective_bytes_total"):
        assert cost[key] == full[key], key
    assert (full["collective_bytes_total"] > 0) == (shape == "train_4k")


# ------------------------------------------------------------------ #
# shapes, roofline, configs
# ------------------------------------------------------------------ #
def test_applicable_cells_equal_the_reference():
    """The same 33 cells in the reference's order rule (train_4k first,
    zamba2-7b last), over the port's registry order of the archs."""
    cells = shapes.applicable_cells()
    assert sorted(cells) == sorted(CELLS) and len(cells) == 33
    assert {a for a, _ in cells} == set(jall_archs())
    key = [(a == "zamba2-7b", s != "train_4k") for a, s in cells]
    assert key == sorted(key)
    assert shapes.SHAPES.keys() == jshapes.SHAPES.keys()
    for name, spec in shapes.SHAPES.items():
        assert dataclasses.astuple(spec) == dataclasses.astuple(
            jshapes.SHAPES[name])
    assert shapes.LONG_CONTEXT_OK == jshapes.LONG_CONTEXT_OK
    assert shapes.TRAIN_MICROBATCHES == jshapes.TRAIN_MICROBATCHES


@pytest.mark.parametrize("arch,shape", CELLS)
def test_input_specs_match_the_reference(arch, shape):
    """Shapes and dtypes equal; nothing allocated (``meta`` tensors)."""
    cfg, jcfg = get_config(arch), jget(arch)
    got = shapes.input_specs(cfg, shapes.SHAPES[shape])
    want = jshapes.input_specs(jcfg, jshapes.SHAPES[shape])
    assert sorted(got) == sorted(want)
    for k, t in got.items():
        assert t.device.type == "meta"
        assert tuple(t.shape) == tuple(want[k].shape), k
        assert str(t.dtype).split(".")[1] == str(want[k].dtype), k


def test_roofline_terms_at_the_h100s_constants():
    assert roofline.CHIP_FLOPS == 989e12 and roofline.HBM_BPS == 3.35e12
    assert roofline.LINK_BPS == 50e9 and roofline.CHIP_F32_FLOPS == 67e12
    assert roofline.N_CHIPS == 256
    t = roofline.roofline_terms({
        "arch": "rwkv6-1.6b", "shape": "train_4k",
        "flops_total": roofline.CHIP_FLOPS, "bytes_accessed": 2 * 3.35e12,
        "collective_bytes_total": 3 * 50e9})
    assert t["t_compute_s"] == pytest.approx(1.0)
    assert t["t_memory_s"] == pytest.approx(2.0)
    assert t["t_collective_s"] == pytest.approx(3.0)
    assert t["dominant"] == "collective"


@pytest.mark.parametrize("arch,shape", CELLS)
def test_roofline_terms_equal_the_reference(monkeypatch, arch, shape):
    """Under the reference's v5e constants the port's terms are the
    reference's, and its model FLOPs equal the reference's."""
    assert roofline.model_flops(arch, shape) == jroofline.model_flops(
        arch, shape)
    monkeypatch.setattr(roofline, "CHIP_FLOPS", jroofline.CHIP_FLOPS)
    monkeypatch.setattr(roofline, "HBM_BPS", jroofline.HBM_GBPS)
    monkeypatch.setattr(roofline, "LINK_BPS", jroofline.ICI_GBPS)
    row = {"arch": arch, "shape": shape, "flops_total": 3.1e15,
           "bytes_accessed": 2.7e11, "collective_bytes_total": 4.4e9}
    assert roofline.roofline_terms(row) == jroofline.roofline_terms(row)


def test_roofline_cli_over_dryrun_rows(tmp_path, port_cli_rows):
    """The CLI reads cost and memory rows (error rows skipped) and writes
    one row a cost row, with the 16x16 row's GiB a rank."""
    rows = list(port_cli_rows.values())
    (tmp_path / "mem.json").write_text(json.dumps(rows))
    (tmp_path / "cost.json").write_text(json.dumps(
        rows + [{"arch": "x", "shape": "y", "mesh": "16x16",
                 "error": "boom"}]))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.roofline",
         "--cost", str(tmp_path / "cost.json"),
         "--mem", str(tmp_path / "mem.json"),
         "--out", str(tmp_path / "roof.json"), "--markdown"],
        capture_output=True, text=True, env=_port_env(), timeout=120,
        cwd=REPO)
    assert proc.returncode == 0, proc.stderr[-2000:]
    out = json.loads((tmp_path / "roof.json").read_text())
    assert len(out) == 2 and all(r["arch"] == "rwkv6-1.6b" for r in out)
    mem = port_cli_rows["16x16"]["bytes_per_device"]
    assert out[0]["peak_gib_per_device"] == pytest.approx(
        (mem["argument"] + mem["temp"]) / 2**30)
    assert "| rwkv6-1.6b | decode_32k |" in proc.stdout


@pytest.mark.parametrize("arch", jall_archs())
def test_active_params_and_cache_axes_equal_the_reference(arch):
    assert get_config(arch).n_active_params_est == \
        jget(arch).n_active_params_est
    _, want = jbuild(jget(arch, "smoke")).init_cache(2, 16, abstract=True)
    model = build_model(get_config(arch, "smoke"), "meta", seed=None)
    axes = model.cache_axes()
    assert axes == {k: tuple(v) for k, v in want.items()}
    cache = model.init_cache(2, 16)
    flat = {}
    for name, leaves in cache.items():
        flat.update({f"{name}.{k}": v for k, v in leaves.items()})
    assert sorted(flat) == sorted(axes)
    for path, t in flat.items():
        assert t.dim() == len(axes[path]), path
    assert all(t.device.type == "meta" for t in flat.values())
