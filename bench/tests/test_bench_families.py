"""Model families as files: what depends on a family lives in
``bench/families/<family>.py``; a family that no file of the harness
names runs a prefill cell and a decode cell end to end from its own files
alone; kept state of two stacks that hold the same leaf keeps both; and
the counts and weights read as they did before the families moved out of
the harness (the numbers below are those of the harness before the move,
kept as constants)."""
from __future__ import annotations

import ast
import hashlib
import json
import sys
import time
import types

import pytest
import torch

from bench import harness, roofline, run, traffic, weights
from bench.families import dense
from bench.reference import dense as dense_reference
from bench.tests.smoke import SMOKE_MIX, SMOKE_SAMPLE, smoke_cfg

# (operations, bytes) of ``roofline.prefill`` at every (B, S) the two
# prefill cells hand over and of ``roofline.decode_step`` at the decode
# cell's first and about its last valid positions (the parameter counts
# are held by ``test_bench_roofline``)
GOLDEN_PREFILL = {
    ("zamba2-7b", 32, 512): (219387531886592, 21313580448),
    ("zamba2-7b", 16, 1024): (220165545918464, 18878676384),
    ("zamba2-7b", 8, 2048): (221727079006208, 17661224352),
    ("zamba2-7b", 4, 4096): (224852897693696, 17052498336),
    ("zamba2-7b", 2, 8192): (231105911324672, 16748135328),
    ("minitron-4b", 8, 2048): (122068037271552, 10867834880),
    ("minitron-4b", 4, 4096): (128658815582208, 10867834880),
    ("minitron-4b", 2, 8192): (141849809387520, 10867834880),
    ("minitron-4b", 1, 16384): (168236515590144, 10867834880),
}
GOLDEN_DECODE = {("minitron-4b", 64, 2049): (603224801280, 25808338944),
                 ("minitron-4b", 64, 2250): (608283131904, 27494449152)}
# sha256 over each leaf's name and bf16 bits, in order, of
# ``weights.make`` at the port's smoke sizes, seed 0, on the CPU
GOLDEN_WEIGHTS = {
    "zamba2-7b":
        "3acf50d6ccca4a7ff10abfe9181adb91f5990c62ea1a2b02eb0419f77a99e1b0",
    "minitron-4b":
        "7ecfc5e394f174d553f5c1975ad686d1cd380e04f51b7439a788a260557848d2",
}
# the harness's own modules, where no family is named
FAMILY_FREE = [p for p in harness.BENCH.rglob("*.py")
               if p.relative_to(harness.BENCH).parts[0]
               not in ("families", "reference", "metrics", "tests")]


def test_prefill_counts_read_as_before():
    cells = {"zamba2-7b": "zamba2-7b.prefill",
             "minitron-4b": "minitron-4b.prefill-long"}
    got = {}
    for name, cell in cells.items():
        c = harness.cell(cell)
        for B, S in traffic.shapes(c.mix):
            got[(name, B, S)] = roofline.prefill(c.cfg, B, S)
    assert got == GOLDEN_PREFILL


def test_decode_counts_read_as_before():
    cfg = harness.load("configs", "minitron-4b")
    assert {key: roofline.decode_step(cfg, *key[1:])
            for key in GOLDEN_DECODE} == GOLDEN_DECODE


def checksum(W: dict) -> str:
    h = hashlib.sha256()
    for name, t in W.items():
        h.update(name.encode())
        h.update(t.contiguous().view(torch.int16).cpu().numpy().tobytes())
    return h.hexdigest()


@pytest.mark.parametrize("name", sorted(GOLDEN_WEIGHTS))
def test_weights_draw_as_before(name):
    assert checksum(weights.make(smoke_cfg(name), 0, "cpu")) \
        == GOLDEN_WEIGHTS[name]


def _names_family(node) -> bool:
    if isinstance(node, ast.Name):
        return node.id == "family"
    if isinstance(node, ast.Attribute):
        return node.attr == "family"
    if isinstance(node, ast.Subscript):
        s = node.slice
        return isinstance(s, ast.Constant) and s.value == "family"
    return False


def _has_string(node) -> bool:
    return any(isinstance(n, ast.Constant) and isinstance(n.value, str)
               for n in ast.walk(node))


def test_harness_names_no_family():
    assert len(FAMILY_FREE) >= 8
    for path in FAMILY_FREE:
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Compare):
                sides = [node.left, *node.comparators]
                named = [s for s in sides if not _names_family(s)]
                assert len(named) == len(sides) \
                    or not any(map(_has_string, named)), \
                    f"{path.name}:{node.lineno} compares a family by name"
            if isinstance(node, (ast.Assign, ast.AnnAssign)):
                targets = (node.targets if isinstance(node, ast.Assign)
                           else [node.target])
                assert "PROGRAM_KEYS" not in {
                    t.id for t in targets if isinstance(t, ast.Name)}, \
                    f"{path.name}:{node.lineno}"


# --------------------------------------------------------------------- #
# a family from files alone
# --------------------------------------------------------------------- #
def _module(name: str, like) -> types.ModuleType:
    mod = types.ModuleType(name)
    mod.__dict__.update({k: v for k, v in vars(like).items()
                         if not k.startswith("__")})
    return mod


@pytest.fixture
def toy(tmp_path, monkeypatch):
    """A family ``toy`` (the dense family's functions under that name) and
    its reference, put where the harness looks them up by name, and a
    configuration, two traffic mixes and two cells of it written as files
    under a directory the harness reads instead of ``bench/``."""
    monkeypatch.setitem(sys.modules, "bench.families.toy",
                        _module("bench.families.toy", dense))
    monkeypatch.setitem(sys.modules, "bench.reference.toy",
                        _module("bench.reference.toy", dense_reference))
    cfg = dict(harness.load("configs", "minitron-4b"), name="toy-1",
               family="toy", reference="toy", port_config="minitron-4b",
               departs_from_published=[])
    limits = {"prefill": harness.cell("minitron-4b.prefill-long").limits,
              "decode": harness.cell("minitron-4b.decode").limits}
    (tmp_path / "configs").mkdir()
    (tmp_path / "configs" / "toy-1.json").write_text(json.dumps(cfg))
    monkeypatch.setattr(harness, "BENCH", tmp_path)
    # the port has no configuration named toy-1: its smoke sizes come from
    # the one that ``port_config`` names
    files = {("configs", "toy-1"): smoke_cfg("toy-1")}
    for kind in ("prefill", "decode"):
        files[("traffic", f"toy_{kind}")] = SMOKE_MIX[kind]
        files[("workloads", f"toy-1.{kind}")] = {
            "config": "toy-1", "traffic": f"toy_{kind}",
            "limits": limits[kind], "sample": SMOKE_SAMPLE[kind]}
    for (kind, name), body in files.items():
        (tmp_path / kind).mkdir(exist_ok=True)
        (tmp_path / kind / f"{name}.json").write_text(json.dumps(body))


@pytest.mark.parametrize("kind", ["prefill", "decode"])
def test_a_family_comes_in_as_files_alone(toy, kind):
    c = harness.cell(f"toy-1.{kind}")
    assert c.cfg["family"] == "toy"
    from repro_torch.configs import get_config
    assert c.cfg["d_model"] == get_config("minitron-4b", "smoke").d_model
    r = harness.run_cell(c, 2 ** 31 + 29, 3.0, False, "cpu",
                         time.perf_counter())
    assert r.checks["correct"], r.checks
    assert r.checks["requests"] >= 1
    mfu = run._reader(f"mfu.{kind}")(r)
    assert isinstance(mfu, float) and mfu > 0


# --------------------------------------------------------------------- #
# kept state
# --------------------------------------------------------------------- #
def test_kept_state_of_two_stacks_with_one_leaf_keeps_both():
    def stack(n, fill):
        return {"ckv": torch.full((n, 2, 5, 3), fill),
                "krope": torch.full((n, 2, 5, 1), fill + 0.5),
                "len": torch.zeros(n, 1, dtype=torch.int32)}
    cache = {"dense_layers": stack(1, 1.0), "layers": stack(3, 2.0)}
    pos = torch.tensor([0, 4])
    got = harness._keep(cache, 1, {"dense_layers.ckv": pos,
                                   "layers.ckv": pos})
    assert list(got) == ["dense_layers.ckv", "dense_layers.krope",
                         "layers.ckv", "layers.krope"]
    assert got["dense_layers.ckv"].shape == (1, 2, 3)
    assert got["layers.ckv"].shape == (3, 2, 3)
    assert got["layers.krope"].shape == (3, 5, 1)
    assert torch.equal(got["dense_layers.ckv"], torch.ones(1, 2, 3))
    assert torch.equal(got["layers.ckv"], torch.full((3, 2, 3), 2.0))


def test_kept_names_of_the_families_stay_the_leaves():
    from repro_torch.models.model import build_model
    want = {"zamba2-7b": ["ssm", "conv", "k", "v"],
            "minitron-4b": ["k", "v"]}
    for name, leaves in want.items():
        cfg = smoke_cfg(name)
        model = build_model(harness.program_config(cfg), "cpu", seed=None)
        names = harness.kept_names(model.init_cache(1, 8))
        assert list(names.values()) == leaves
