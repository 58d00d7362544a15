"""The model-axis split of the MoE family (``experts``, or each expert's
``expert_mlp`` where the experts do not divide, and MLA's heads) against
the JAX package's unsplit results, on the CPU, as
``test_torch_tensor_parallel`` holds the dense families (its references
and bounds, computed in this process):

- gloo groups of 2 ranks (1, 2) and 4 ranks (2, 2) and (2, 1, 2) hold the
  forward, the loss, every gathered gradient, three sharded steps and
  prefill with 4 greedy decode steps of mixtral-8x22b's smoke config (4
  experts: 2 a rank), deepseek-v3-671b's (MLA's 4 heads, 8 experts, the
  shared expert and the dense FFN split) and mixtral's at 3 experts (each
  expert's 128 columns split, the experts whole);
- the router's gradient leaves the reference's bound when the
  load-balance loss's path is summed over ``model`` or when the gates
  enter the experts without ``copy_to``;
- the full configs' plans at ``model`` = 2 and 16 (on the meta device):
  exactly the leaves whose ``spec_for`` shards a dim over ``model`` are
  cut, to the spec's blocks.
"""
import pytest

import _dist_workers
from repro_torch.configs import get_config
from repro_torch.dist import sharding
from repro_torch.dist.tensor_parallel import (AttentionSplit, ExpertSplit,
                                              MlaSplit, MlpSplit)
from repro_torch.models.model import build_model
from test_torch_tensor_parallel import (GROUP_TIMEOUT_S, MOE_CONFIGS,
                                        _reference, _write_case)


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("name", MOE_CONFIGS)
def test_split_matches_reference(tmp_path, name, world):
    """The split model against the reference's unsplit results on every
    mesh of ``_dist_workers.TP_MESHES[world]``."""
    _write_case(tmp_path, _reference(name))
    _dist_workers.spawn_group(tmp_path, world, ["tp_parity"],
                              GROUP_TIMEOUT_S)


def test_router_gradient_needs_both_conjugates(tmp_path):
    """mixtral's smoke config split over 2 ranks: the router's gradient
    within the reference's bound, and outside it with the aux path summed
    over ``model`` or the gates entering as they are
    (``_dist_workers.tp_moe_router_faults``)."""
    _write_case(tmp_path, _reference("mixtral-8x22b"))
    _dist_workers.spawn_group(tmp_path, 2, ["tp_moe_router_faults"],
                              GROUP_TIMEOUT_S)


# a rank's block of each split leaf of the full configs, by the leaf's
# name's end: (model, leaf) -> its shape
BLOCKS = {
    ("deepseek-v3-671b", 16): {
        "moe.w_gate": (16, 7168, 2048), "moe.w_down": (16, 2048, 7168),
        "attn.wq_b": (1536, 8, 192), "attn.wkv_b": (512, 8, 256),
        "attn.wo": (8, 128, 7168), "attn.wq_a": (7168, 1536),
        "attn.wkv_a": (7168, 576), "shared.w_gate": (7168, 128),
        "ffn.w_gate": (7168, 1152), "embedding": (8080, 7168),
        "head": (7168, 8080)},
    ("deepseek-v3-671b", 2): {
        "moe.w_gate": (128, 7168, 2048), "attn.wq_b": (1536, 64, 192),
        "shared.w_gate": (7168, 1024), "ffn.w_gate": (7168, 9216)},
    ("mixtral-8x22b", 16): {
        "moe.w_gate": (8, 6144, 1024), "moe.w_up": (8, 6144, 1024),
        "moe.w_down": (8, 1024, 6144), "attn.wq": (6144, 3, 128),
        "attn.wk": (6144, 8, 128), "attn.wo": (3, 128, 6144),
        "embedding": (2048, 6144), "head": (6144, 2048)},
    ("mixtral-8x22b", 2): {
        "moe.w_gate": (4, 6144, 16384), "moe.w_down": (4, 16384, 6144),
        "attn.wq": (6144, 24, 128), "attn.wk": (6144, 4, 128)},
}
DEEPSEEK_RUNS = {"mla": True, "mlp": True, "experts": True,
                 "expert mlp": False, "vocab": True}
RUNS = {("deepseek-v3-671b", 16): DEEPSEEK_RUNS,
        ("deepseek-v3-671b", 2): DEEPSEEK_RUNS,
        ("mixtral-8x22b", 16): {"attention": True, "experts": False,
                                "expert mlp": True, "vocab": True},
        ("mixtral-8x22b", 2): {"attention": True, "experts": True,
                               "expert mlp": False, "vocab": True}}


@pytest.mark.parametrize("n", [2, 16])
@pytest.mark.parametrize("arch", ["mixtral-8x22b", "deepseek-v3-671b"])
def test_moe_families_split_as_spec_for(arch, n):
    """The full mixtral-8x22b and deepseek-v3-671b at ``model`` = 2 and 16
    (on the meta device): exactly the leaves whose ``spec_for`` shards a
    dim over ``model`` are cut, each to the spec's block (deepseek at 16:
    16 experts, 8 heads, 128 shared and 1,152 dense FFN columns, 8,080
    vocabulary rows a rank; mixtral at 16: its 8 experts whole, 1,024
    ``expert_mlp`` columns, 3 q heads over its 8 whole kv heads, 2,048
    vocabulary rows; each a block over ``model``, its ``data`` cut
    undone), the regions run split as the plan says, and the caches stay
    whole.  The mesh's ``data`` axis of 16 cuts the dims the spec shards
    over ``data`` too (``dist.fsdp``)."""
    cfg = get_config(arch, "full")
    model = build_model(cfg, "meta", seed=None)
    mesh = sharding.CutMesh({"data": 16, "model": n})
    model.shard(mesh)
    plan = model.split_plan
    rules = sharding.default_rules(False)
    n_cut = 0
    for name, p in model.named_parameters():
        shape = getattr(p, "whole_shape", tuple(p.shape))
        spec = sharding.spec_for(shape, p.logical_axes, rules, mesh)
        assert plan.specs[name] == spec, name
        spec = tuple(spec) + (None,) * (len(shape) - len(spec))
        block = [s // n if e == "model" else s // 16 if e == "data" else s
                 for s, e in zip(shape, spec)]
        assert hasattr(p, "cut") == ("model" in spec), name
        assert hasattr(p, "data_cut") == ("data" in spec), name
        assert list(p.shape) == block, (name, tuple(p.shape), block)
        n_cut += hasattr(p, "cut")
        over_model = [s * 16 if e == "data" else s
                      for s, e in zip(p.shape, spec)]
        for leaf, want in BLOCKS.get((arch, n), {}).items():
            if name.endswith("." + leaf) or name == leaf:
                assert tuple(over_model) == want, (name, over_model, want)
    assert n_cut > 0
    runs = plan.runs()
    assert runs == RUNS[(arch, n)], runs
    moe_layer = model.layers[0]
    assert isinstance(moe_layer.moe.tp, ExpertSplit)
    assert moe_layer.moe.tp.by_experts == runs["experts"]
    if arch == "deepseek-v3-671b":
        assert isinstance(moe_layer.attn.tp, MlaSplit)
        assert isinstance(moe_layer.moe.shared.tp, MlpSplit)
        assert isinstance(model.dense_layers[0].ffn.tp, MlpSplit)
        assert "expert_mlp 2048 whole (the experts take model)" \
            in plan.describe()
        cache = model.init_cache(1, 4)
        assert cache["layers"]["ckv"].shape[-1] == cfg.kv_lora_rank
    else:
        assert isinstance(moe_layer.attn.tp, AttentionSplit)
        if n == 16:
            assert "experts 8 whole (8 % 16 != 0)" in plan.describe()
            assert moe_layer.attn.tp.kv_index is not None
            assert model.init_cache(1, 4)["layers"]["k"].shape[3] == 8
        else:
            assert "expert_mlp 16384 whole (the experts take model)" \
                in plan.describe()
            assert model.init_cache(1, 4)["layers"]["k"].shape[3] == 4
