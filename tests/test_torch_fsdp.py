"""The port's weights cut over the mesh's ``data`` axis (``dist.fsdp``,
``Model.shard``): each rank keeps its block of every weight whose spec
shards ``embed`` over ``data``, gathers one layer's weights at a time for
compute and reduce-scatters their gradients; the sharded step updates
AdamW on the blocks.

- Gloo groups of 2 ranks on a (2, 1) ``("data", "model")`` mesh, for the
  smoke configs of the five families (qwen2-vl-2b, zamba2-7b, rwkv6-1.6b,
  mixtral-8x22b, deepseek-v3-671b; their widths divide 2): every cut
  parameter holds 1/2 of its whole elements, the rest stay whole, and the
  gathered values are the unsplit model's bit for bit; on the rank's rows
  the forward logits, the loss, a prefill with two decode steps and the
  cache equal an unsplit copy's bit for bit, and the gradients (a whole
  leaf's, and a block's as the sum of the ranks' unsplit gradients) lie
  within 1e-5 of their scale of it (``_dist_workers.fsdp_exact``).
- The sharded step keeps the AdamW state at rest in the parameters'
  blocks and updates it in place: no all-gather reads or writes ``m``,
  ``v`` or ``master`` (``_dist_workers.fsdp_step_state``).
- Against the JAX package's unsplit float32 results on the whole batch
  (``test_torch_tensor_parallel._reference``, computed in this process),
  at that file's tolerances: the forward logits, the loss and gradients,
  3 steps, prefill with decode of qwen2-vl-2b on a 4-rank (2, 2, 1)
  ``("pod", "data", "model")`` mesh (the ``data`` group is the data ranks
  of the rank's pod; the blocks' gradients are summed over ``pod`` after
  the backward).  The (2, 1) mesh of every family, and (2, 2) with the
  model split too, run in ``_dist_workers.TP_MESHES``, beside each
  family's ``model``-axis parity on the references its file computes
  (``test_torch_tensor_parallel``, ``_scan``, ``_moe``).
- The full configs on the meta device at (16, 16) and (2, 16, 16): the
  ``data`` cut is the spec's, ``pod`` cuts no weight.
- A model cut over ``data`` with no process group raises at its first
  gather.
- The dry run's train row (a fake 256-rank group): its all-gathers are
  the weights cut over ``data``, a layer at a time, and nothing else (no
  gather of the optimizer state).
"""
import json

import numpy as np
import pytest
import torch

import _dist_workers
from repro_torch.configs import all_archs, get_config
from repro_torch.dist import sharding
from repro_torch.models.model import build_model
from repro_torch.models.params import whole_shape
from test_torch_tensor_parallel import (GROUP_TIMEOUT_S, _dryrun_row,
                                        _reference, _write_case)

FAMILIES = ("qwen2-vl-2b", "zamba2-7b", "rwkv6-1.6b", "mixtral-8x22b",
            "deepseek-v3-671b")


def _spawn(tmp_path, arch: str, checks: list[str]) -> None:
    """``checks`` on 2 spawned gloo ranks for the smoke config of ``arch``."""
    (tmp_path / "fsdp.json").write_text(json.dumps({"arch": arch}))
    _dist_workers.spawn_group(tmp_path, 2, checks, GROUP_TIMEOUT_S)


@pytest.mark.parametrize("arch", FAMILIES)
def test_fsdp_cut_and_gather_are_exact(tmp_path, arch):
    """``_dist_workers.fsdp_exact`` on a (2, 1) mesh."""
    _spawn(tmp_path, arch, ["fsdp_exact"])


@pytest.mark.parametrize("arch", ["qwen2-vl-2b", "mixtral-8x22b"])
def test_fsdp_step_updates_the_state_at_rest(tmp_path, arch):
    """``_dist_workers.fsdp_step_state`` on a (2, 1) mesh, 2
    microbatches."""
    _spawn(tmp_path, arch, ["fsdp_step_state"])


def test_fsdp_over_pod_matches_reference(tmp_path):
    """qwen2-vl-2b's smoke config on a (2, 2, 1) ``("pod", "data",
    "model")`` mesh against the reference's unsplit results
    (``_dist_workers.tp_parity``)."""
    case = dict(_reference("qwen2-vl-2b"),
                meshes=[((2, 2, 1), ("pod", "data", "model"))])
    _write_case(tmp_path, case)
    _dist_workers.spawn_group(tmp_path, 4, ["tp_parity"], GROUP_TIMEOUT_S)


@pytest.mark.parametrize("pods", [1, 2])
@pytest.mark.parametrize("arch", all_archs())
def test_full_configs_cut_over_data_as_spec_for(arch, pods):
    """Each full config on the meta device, cut for rank 0 of a (16, 16)
    or (2, 16, 16) mesh: a parameter whose ``spec_for`` (its whole shape,
    ``default_rules``) names ``data`` on a dim keeps 1/16 of that dim and
    records the cut, beside its ``model`` cut; ``pod`` cuts no dim; every
    other parameter keeps that dim whole; the ``embed`` dims left whole
    are the ones the ShardingReport notes."""
    cfg = get_config(arch, "full")
    shape = {"data": 16, "model": 16}
    if pods == 2:
        shape = {"pod": 2, **shape}
    mesh = sharding.CutMesh(shape)
    model = build_model(cfg, "meta", seed=None).shard(mesh)
    assert model.fsdp is not None and model.fsdp.size == 16
    rules = sharding.default_rules(pods == 2)
    report = sharding.ShardingReport()
    n_cut = 0
    for name, p in model.named_parameters():
        whole = whole_shape(p)
        spec = sharding.spec_for(whole, p.logical_axes, rules, mesh, report,
                                 name)
        spec = tuple(spec) + (None,) * (len(whole) - len(spec))
        assert not any(e == "pod" or (isinstance(e, tuple) and "pod" in e)
                       for e in spec), name
        block = [s // 16 if e in ("data", "model") and
                 (e == "data" or hasattr(p, "cut")) else s
                 for s, e in zip(whole, spec)]
        if "data" in spec:
            dim = spec.index("data")
            assert p.data_cut == (dim, 0, 16), name
            n_cut += 1
        else:
            assert not hasattr(p, "data_cut"), name
        assert list(p.shape) == block, (name, tuple(p.shape), block)
    assert n_cut > 0
    whole_embed = {name for name, p in model.named_parameters()
                   if "embed" in p.logical_axes and not hasattr(p, "data_cut")}
    noted = {path for path, axis, _ in report.degraded if axis == "embed"
             and not hasattr(model.get_parameter(path), "data_cut")}
    assert whole_embed == noted, (whole_embed ^ noted)


def test_a_model_cut_over_data_needs_its_group():
    """Cut over ``data`` by a stand-in mesh that gives no process group,
    the model raises at its first gather, in the forward and the
    prefill: it never runs whole."""
    cfg = get_config("qwen2-vl-2b", "smoke")
    model = build_model(cfg, "cpu", seed=3,
                        mesh=sharding.CutMesh({"data": 2, "model": 1}))
    assert model.fsdp.group is None
    tok = torch.from_numpy(np.zeros((2, 8), np.int64))
    with pytest.raises(RuntimeError, match="data group"):
        model(tok)
    with pytest.raises(RuntimeError, match="data group"):
        model.prefill(tok, model.init_cache(2, 8))
    # the blocks are back in place after the failed gather
    assert all(isinstance(p, torch.nn.Parameter) for p in model.parameters())


def test_dryrun_train_row_gathers_only_the_weights():
    """The dry run of qwen2-vl-2b's smoke config at 16 q and kv heads, a
    d_ff of 128 and a vocabulary of 512 x train_4k at 16x16
    (``test_torch_tensor_parallel._dryrun_row``): the bytes its
    all-gathers write on rank 0 equal ``fsdp.weight_gather_bytes``,
    the weights cut over ``data`` gathered in each microbatch's forward
    and remat recompute; a reduce-scatter brings their gradients back."""
    import dataclasses
    from repro_torch.dist.fsdp import weight_gather_bytes
    from repro_torch.launch.shapes import TRAIN_MICROBATCHES
    row, log = _dryrun_row(False)
    cfg = dataclasses.replace(get_config("qwen2-vl-2b", "smoke"), n_heads=16,
                              n_kv_heads=16, d_ff=128, vocab_size=512)
    micro = TRAIN_MICROBATCHES.get("qwen2-vl-2b",
                                   TRAIN_MICROBATCHES["default"])
    model = build_model(cfg, "meta", seed=None,
                        mesh=sharding.CutMesh({"data": 16, "model": 16}))
    want = weight_gather_bytes(model, micro)
    assert want > 0
    assert row["collective_bytes"]["all-gather"] == want, \
        (row["collective_bytes"], want)
    assert row["collective_bytes"]["reduce-scatter"] > 0
    assert "data axis 16: " in log, log
