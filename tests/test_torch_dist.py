"""The port's ``dist/`` (sharding rules, collectives, the pipeline), its
sharded train step and elastic resharding against the JAX package's, on
the CPU.

- ``spec_for``: the reference's six cases, equal specs and equal
  degradation reports.  ``Model.param_axes`` equal to the reference's
  ``Model.init`` axes for all ten smoke configs, and ``tree_shardings`` of
  each config's parameters and AdamW state on stand-in (16, 16) and
  (2, 16, 16) meshes equal to the reference's on ``AbstractMesh``es of the
  same shape (a per-layer leaf's spec is its stack's without the leading
  ``"layers"`` entry); ``opt_state_axes`` equal.
- The collectives on a one-rank gloo group against the reference's
  ``shard_map`` on its one-device mesh, bit for bit: the same float32
  copies, and an int8 quantization with the same float32 divisions and
  half-to-even rounding.
- ``ici_environment`` built from the reference's ``ICI_LINK`` values: the
  history, the tuner's transfer (on the reference's knowledge, carried over
  as the tuner tests carry it) and the plan equal; on the port's own link,
  a valid plan.
- The pipeline at S = 1 against the reference's (rtol 1e-6).
- The (1, 1) sharded step of the reference's ``_mini_cfg`` from the
  reference's weights and AdamW state, against its jit-with-shardings step:
  loss and every parameter to 1e-5 of their scale.
- ``carve_mesh``, ``reshard_state`` and ``recover`` round trips.
- What one rank cannot show, on 2 and 4 spawned processes joined by a gloo
  group (``_dist_workers``): the all-reduces against the sum of the ranks'
  vectors and the reference's int8 formula in numpy, the pipeline at S = 2
  and 4 against the sequential stack, a 2-rank data-parallel step against
  the one-process step, and ``recover`` onto a (2, 1) mesh.
"""
import dataclasses

import numpy as np
import pytest
import torch
import torch.distributed as dist

import jax
import jax.numpy as jnp
from jax.sharding import AbstractMesh, Mesh
from jax.sharding import PartitionSpec as JP

import _dist_workers
import repro.core as jcore
import repro.netsim as jn
import repro_torch.core as pcore
import repro_torch.netsim as pn
from _port_parity import plain
from repro.configs import get_config as jget
from repro.dist import collectives as jcoll
from repro.dist import pipeline_par as jpipe
from repro.dist import sharding as jshard
from repro.dist.compat import shard_map
from repro.models.model import build_model as jbuild
from repro.models.params import paths_from_tree as jpaths
from repro.optim import adamw_init as jadamw_init
from repro.train import loop as jloop
from repro_torch.checkpoint.ckpt import save_checkpoint
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.core.state import offline_db_from_state, offline_db_to_state
from repro_torch.dist import collectives, pipeline_par, sharding
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models.model import build_model
from repro_torch.netsim.environment import LinkSpec
from repro_torch.models.params import (load_reference_params,
                                       opt_state_from_reference,
                                       paths_from_tree, reference_path,
                                       reference_paths)
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.train import elastic
from repro_torch.train.loop import (TrainConfig, init_train_state,
                                    make_train_step, opt_state_axes)


class _FakeMesh:
    """Just enough of a mesh for spec_for (shape lookup)."""
    def __init__(self, shape: dict):
        self.shape = shape


@pytest.fixture(scope="module")
def one_rank():
    """A one-rank gloo group (an in-memory store, no sockets) for the
    module's tests, torn down after them."""
    assert not dist.is_initialized()
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    yield
    dist.destroy_process_group()


# ----------------------------- sharding ------------------------------- #
SPEC_CASES = {
    "divisible": ({"data": 16, "model": 16}, False, (16384, 128, 128),
                  ("embed", "heads", "head_dim")),
    "non_divisible": ({"data": 16, "model": 16}, False, (5120, 40, 128),
                      ("embed", "heads", "head_dim")),
    "partial_prefix": ({"pod": 2, "data": 4, "model": 16}, True, (12, 64),
                       ("batch", None)),
    "indivisible_after_drops": ({"pod": 2, "data": 4}, True, (7,),
                                ("batch",)),
    "one_axis_per_tensor": ({"data": 16, "model": 16}, False,
                            (256, 7168, 2048),
                            ("experts", "embed", "expert_mlp")),
    "multipod_batch": ({"pod": 2, "data": 16, "model": 16}, True, (256, 4096),
                       ("batch", "seq")),
}


@pytest.mark.parametrize("case", list(SPEC_CASES))
def test_spec_for_matches_reference(case):
    mesh, multi_pod, shape, axes = SPEC_CASES[case]
    want_rep, got_rep = jshard.ShardingReport(), sharding.ShardingReport()
    want = jshard.spec_for(shape, axes, jshard.default_rules(multi_pod),
                           _FakeMesh(mesh), want_rep, "x")
    got = sharding.spec_for(shape, axes, sharding.default_rules(multi_pod),
                            _FakeMesh(mesh), got_rep, "x")
    assert tuple(got) == tuple(want)
    assert got == sharding.P(*tuple(want))
    assert got_rep.degraded == want_rep.degraded
    assert sharding.default_rules(multi_pod) == \
        jshard.default_rules(multi_pod)


def test_spec_entries_compare_and_trim_like_partition_specs():
    P = sharding.P
    assert P("data", None) != P("data") and P() == P()
    assert sharding.spec_for((8, 3, 5), ("embed", None, None),
                             sharding.default_rules(False),
                             _FakeMesh({"data": 2})) == P("data")
    assert tuple(JP("data")) == tuple(P("data"))


def test_placements_follow_the_spec():
    from torch.distributed.tensor import Replicate, Shard
    mesh = _FakeMesh({"pod": 2, "data": 4, "model": 8})
    s = sharding.NamedSharding(mesh, sharding.P(("pod", "data"), None,
                                                "model"))
    assert s.placements == (Shard(0), Shard(0), Shard(2))
    assert sharding.replicated(mesh).placements == (Replicate(),) * 3
    assert sharding.batch_sharding(mesh, ndim=2).spec == \
        sharding.P(("pod", "data"))
    assert sharding.batch_sharding(mesh, ndim=2, batch_size=12).spec == \
        sharding.P("data")
    assert sharding.batch_sharding(mesh, ndim=2, batch_size=7).spec == \
        sharding.P()


def _reference_init(arch):
    model = jbuild(jget(arch, "smoke"))
    return model.init(jax.random.PRNGKey(0), abstract=True)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_axes_match_reference(arch):
    _, want = _reference_init(arch)
    model = build_model(get_config(arch, "smoke"), "cpu", seed=None)
    assert model.param_axes() == dict(want)
    assert opt_state_axes(model.param_axes()) == \
        jloop.opt_state_axes(dict(want))


MESHES = {"single_pod": ((16, 16), ("data", "model"), False),
          "multi_pod": ((2, 16, 16), ("pod", "data", "model"), True)}


def _port_specs(tree, axes, mesh, rules):
    rep = sharding.ShardingReport()
    got = sharding.tree_shardings(tree, axes, mesh, rules, rep)
    return {path: s.spec for path, s in got.items()}, rep


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_tree_shardings_match_reference(arch, mesh_name):
    """Every leaf of the parameters and of the AdamW state: the port's
    spec (a per-layer leaf's) equals the reference's (its stack's, less the
    leading replicated ``"layers"`` entry); the degradation reports name the
    same leaves, axes and reasons."""
    shape, names, multi_pod = MESHES[mesh_name]
    jmesh = AbstractMesh(shape, names)
    fake = _FakeMesh(dict(zip(names, shape)))
    jparams, jaxes = _reference_init(arch)
    jrules = jshard.default_rules(multi_pod)
    model = build_model(get_config(arch, "smoke"), "cpu", seed=None)
    axes = model.param_axes()
    rules = sharding.default_rules(multi_pod)
    jopt = jadamw_init(jparams, jloop.TrainConfig().opt, abstract=True)
    opt = adamw_init(model, AdamWConfig(), abstract=True)
    for jtree, jtree_axes, tree, tree_axes in (
            (jparams, jaxes, dict(model.named_parameters()), axes),
            (jopt, jloop.opt_state_axes(jaxes), opt, opt_state_axes(axes))):
        jrep = jshard.ShardingReport()
        want = {p: s.spec for p, s in jpaths(jshard.tree_shardings(
            jtree, jtree_axes, jmesh, jrules, jrep)).items()}
        got, rep = _port_specs(tree, tree_axes, fake, rules)
        for path, spec in got.items():
            ref, stacked = reference_path(path)
            w = tuple(want[ref])
            if stacked:
                assert w[:1] in ((), (None,)), (path, w)
                w = w[1:]
            assert tuple(spec) == w, (path, spec, want[ref])
        assert {reference_path(p)[0] for p in got} == set(want)
        assert {(reference_path(p)[0], a, why) for p, a, why in rep.degraded} \
            == set(jrep.degraded)


def test_tree_shardings_take_stacked_leaves_as_they_are():
    """A tree in the reference's stacked layout (``reference_paths``) takes
    each path's axes whole, the leading ``"layers"`` entry included."""
    model = build_model(get_config("minitron-4b", "smoke"), "cpu", seed=0)
    mesh = _FakeMesh({"data": 2, "model": 2})
    rules = sharding.default_rules(False)
    stacked = reference_paths(dict(model.named_parameters()))
    got = sharding.tree_shardings(stacked, model.param_axes(), mesh, rules)
    axes = model.param_axes()
    for path in ("layers.attn.wq", "embed"):
        assert got[path].spec == sharding.spec_for(
            tuple(stacked[path].shape), axes[path], rules, mesh)
    assert got["layers.attn.wq"].spec[:2] == (None, "data")
    assert got["embed"].spec == sharding.P("model", "data")
    assert sharding.tree_shardings({"x": torch.zeros(4)}, {}, mesh,
                                   rules)["x"].spec == sharding.P()


# ---------------------------- collectives ----------------------------- #
def test_flatten_round_trip():
    tree = {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "b": {"c": torch.ones(4, dtype=torch.bfloat16)},
            "layers.0.w": torch.full((2,), 3.0)}
    flat, spec = collectives.flatten_grads(tree)
    assert flat.dtype == torch.float32 and flat.shape == (12,)
    back = collectives.unflatten_grads(flat, spec)
    assert back["a"].shape == (2, 3) and back["b"]["c"].dtype == torch.bfloat16
    for key in ("a", "layers.0.w"):
        assert torch.equal(back[key], tree[key])
    assert torch.equal(back["b"]["c"], tree["b"]["c"])
    jflat, _ = jcoll.flatten_grads({"a": jnp.asarray(tree["a"].numpy())})
    np.testing.assert_array_equal(collectives.flatten_grads(
        {"a": tree["a"]})[0].numpy(), np.asarray(jflat))
    empty, spec = collectives.flatten_grads({})
    assert empty.shape == (0,) and collectives.unflatten_grads(empty,
                                                              spec) == {}


def _reference_allreduce(fn_name, x, plan):
    mesh = Mesh(np.array(jax.devices()[:1]), ("data",))
    fn = getattr(jcoll, fn_name)
    jplan = jcoll.BucketPlan(*dataclasses.astuple(plan))
    run = shard_map(lambda v: fn(v, jplan, "data"), mesh=mesh,
                    in_specs=(JP(),), out_specs=JP(), check_vma=False)
    return np.asarray(run(jnp.asarray(x)))


ALLREDUCE_CASES = {
    "37_elements_3x2": (37, (3, 2, 1)),
    "257_elements_2x1": (257, (2, 1, 1)),
    "depth_past_the_chunks": (37, (2, 2, 9)),
    "waves_of_2": (1000, (3, 2, 2)),
    "empty": (0, (2, 2, 1)),
}


@pytest.mark.parametrize("fn_name", ["bucketed_allreduce",
                                     "quantized_allreduce"])
@pytest.mark.parametrize("case", list(ALLREDUCE_CASES))
def test_allreduce_matches_reference_on_one_rank(one_rank, fn_name, case):
    n, plan = ALLREDUCE_CASES[case]
    x = (np.random.default_rng(n).normal(size=n) * 3).astype(np.float32)
    plan = collectives.BucketPlan(*plan)
    want = _reference_allreduce(fn_name, x, plan)
    t = torch.from_numpy(x.copy())
    got = getattr(collectives, fn_name)(t, plan)
    assert got.dtype == torch.float32 and got.shape == t.shape
    np.testing.assert_array_equal(got.numpy(), want)
    assert torch.equal(t, torch.from_numpy(x)), "the input was written"
    if fn_name == "quantized_allreduce" and n:
        per = -(-n // plan.n_chunks)
        for c in range(plan.n_chunks):
            block = x[c * per:(c + 1) * per]
            if block.size:
                half_step = np.abs(block).max() / 127.0 / 2
                gap = np.abs(got.numpy()[c * per:(c + 1) * per] - block).max()
                assert gap <= half_step * (1 + 1e-6), (c, gap, half_step)


def test_allreduce_takes_a_group_or_a_mesh_dim(one_rank):
    x = torch.arange(10, dtype=torch.float32)
    mesh = make_host_mesh(device="cpu")
    plan = collectives.BucketPlan(2, 1, 1)
    for group in (None, dist.group.WORLD, (mesh, "data"), mesh["model"]):
        assert torch.equal(collectives.bucketed_allreduce(x, plan, group), x)
    assert collectives.allreduce_bytes(100, 4) == \
        jcoll.allreduce_bytes(100, 4) == 800.0
    assert collectives.allreduce_bytes(100, 4, 4) == \
        jcoll.allreduce_bytes(100, 4, 4)


def _plan_fields(plan):
    return (plan.n_buckets, plan.chunks_per_bucket, plan.pipeline_depth)


@pytest.fixture(scope="module")
def ici_reference():
    env = jcoll.ici_environment(seed=0)
    hist = jn.generate_history(env, days=2, transfers_per_day=150, seed=1)
    tuner = jcore.TransferTuner(jcore.TunerConfig(seed=0)).fit(hist)
    ds = jn.Dataset("grads", "large", avg_file_mb=1600.0, n_files=64)
    rep = tuner.transfer(jcoll.ici_environment(seed=9), ds)
    return hist, tuner.db, rep, jcoll.plan_from_tuner_params(rep.params)


def test_ici_environment_matches_reference_on_its_link(ici_reference):
    hist, db, rep, plan = ici_reference
    link = LinkSpec(**dataclasses.asdict(jcoll.ICI_LINK))
    env = collectives.ici_environment(seed=0, link=link)
    got_hist = pn.generate_history(env, days=2, transfers_per_day=150,
                                   seed=1)
    assert plain(got_hist) == plain(hist)
    tuner = pcore.TransferTuner(pcore.TunerConfig(seed=0, device="cpu"))
    tuner.db = offline_db_from_state(offline_db_to_state(db), device="cpu")
    ds = pn.Dataset("grads", "large", avg_file_mb=1600.0, n_files=64)
    got = tuner.transfer(collectives.ici_environment(seed=9, link=link), ds)
    assert plain(got) == plain(rep)
    assert _plan_fields(collectives.plan_from_tuner_params(got.params)) == \
        _plan_fields(plan)
    const = collectives.ici_environment(seed=0, constant_load=0.3, link=link)
    jconst = jcoll.ici_environment(seed=0, constant_load=0.3)
    assert plain(const.traffic) == plain(jconst.traffic)


def test_ici_environment_on_the_card_link_gives_a_valid_plan():
    """The default link is the H100's NVLink, not the reference's fabric;
    the paper's tuner fits it and converges to a plan."""
    link = collectives.H100_NVLINK
    assert link.bandwidth_mbps == 3_600_000.0
    assert link.disk_read_mbps == link.disk_write_mbps == 26_800_000.0
    assert link.bandwidth_mbps != jcoll.ICI_LINK.bandwidth_mbps
    env = collectives.ici_environment(seed=0)
    assert env.link is link
    hist = pn.generate_history(env, days=2, transfers_per_day=150, seed=1)
    tuner = pcore.TransferTuner(pcore.TunerConfig(seed=0, device="cpu")
                                ).fit(hist)
    ds = pn.Dataset("grads", "large", avg_file_mb=1600.0, n_files=64)
    rep = tuner.transfer(collectives.ici_environment(seed=9), ds)
    assert rep.achieved_mbps > 0
    plan = collectives.plan_from_tuner_params(rep.params)
    assert plan.n_buckets >= 1 and plan.chunks_per_bucket >= 1
    assert plan.pipeline_depth >= 1
    assert _plan_fields(collectives.plan_from_tuner_params(
        pn.TransferParams(0, -1, 3))) == (1, 1, 3)


# ------------------------------ pipeline ------------------------------ #
def test_bubble_fraction_and_split_stages():
    for s, m in ((4, 12), (1, 8), (2, 3)):
        assert pipeline_par.PipelineConfig(s, m).bubble_fraction == \
            jpipe.PipelineConfig(s, m).bubble_fraction
    params = {"w": torch.arange(24.0).reshape(8, 3),
              "sub": {"b": torch.arange(8.0)}}
    out = pipeline_par.split_stages(params, 4)
    want = jpipe.split_stages({"w": jnp.arange(24.0).reshape(8, 3)}, 4)
    assert out["w"].shape == (4, 2, 3) and out["sub"]["b"].shape == (4, 2)
    np.testing.assert_array_equal(out["w"].numpy(), np.asarray(want["w"]))
    with pytest.raises(ValueError, match="not divisible"):
        pipeline_par.split_stages(params, 3)


def test_pipeline_matches_reference_at_one_stage(one_rank):
    L, d, M, mb = 4, 8, 3, 5
    rng = np.random.default_rng(0)
    w = (rng.normal(size=(L, d, d)) * 0.3).astype(np.float32)
    xs = rng.normal(size=(M, mb, d)).astype(np.float32)

    def jslice(params, x):
        def body(x, w):
            return jnp.tanh(x @ w), None
        return jax.lax.scan(body, x, params["w"])[0]

    jmesh = Mesh(np.array(jax.devices()[:1]).reshape(1), ("stage",))
    jfn = jpipe.make_pipeline_fn(jslice, jmesh, jpipe.PipelineConfig(1, M))
    want = np.asarray(jfn(jpipe.split_stages({"w": jnp.asarray(w)}, 1),
                          jnp.asarray(xs)))
    from torch.distributed.device_mesh import init_device_mesh
    mesh = init_device_mesh("cpu", (1,), mesh_dim_names=("stage",))
    fn = pipeline_par.make_pipeline_fn(_dist_workers._tanh_slice, mesh,
                                       pipeline_par.PipelineConfig(1, M))
    got = fn(pipeline_par.split_stages({"w": torch.from_numpy(w)}, 1),
             torch.from_numpy(xs))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    seq = torch.stack([_dist_workers._tanh_slice({"w": torch.from_numpy(w)},
                                                 x)
                       for x in torch.from_numpy(xs)])
    assert torch.equal(got, seq)
    with pytest.raises(ValueError, match="stage"):
        pipeline_par.make_pipeline_fn(_dist_workers._tanh_slice, mesh,
                                      pipeline_par.PipelineConfig(2, M))


# --------------------------- the sharded step -------------------------- #
def _mini_cfg():
    """The reference's ``_mini_cfg`` in float32: its bf16 forwards differ
    between the frameworks by far more than 1e-5 (ROADMAP queue 3)."""
    return dataclasses.replace(jget("minitron-4b", "smoke"), remat=False,
                               dtype=jnp.float32)


def test_sharded_step_matches_reference_on_a_one_device_mesh(one_rank):
    """The reference's ``test_sharded_train_step_on_host_mesh`` on a (1, 1)
    mesh, in float32, 2 steps (the schedule's first is 0), from its weights
    and AdamW state (float32 moments): the loss and every parameter within
    1e-5 of their scale, and the step equal bit for bit to the port's
    unsharded one.  AdamW's eps is 1 here, so that an update is linear in
    its gradient: at eps 1e-8 the first updates are each gradient
    element's sign times the rate, and an element whose terms cancel to
    float32 rounding takes either sign in either framework (the default
    is held by ``test_torch_train``'s three steps at their tolerance)."""
    jm = jbuild(_mini_cfg())
    jt = jloop.TrainConfig(
        opt=dataclasses.replace(jloop.AdamWConfig(), moment_dtype=jnp.float32,
                                lr=1e-3, eps=1.0),
        warmup_steps=1, total_steps=5)
    jmesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))
    rules = jshard.default_rules(False)
    with jmesh:
        jparams, jaxes = jm.init(jax.random.PRNGKey(0))
        jopt = jadamw_init(jparams, jt.opt)
        p_shard = jshard.tree_shardings(jparams, jaxes, jmesh, rules)
        o_shard = jshard.tree_shardings(jopt, jloop.opt_state_axes(jaxes),
                                        jmesh, rules)
        b_shard = {k: jshard.batch_sharding(jmesh, ndim=2)
                   for k in ("tokens", "labels")}
        jfn = jax.jit(jloop.make_train_step(jm, jt),
                      in_shardings=(p_shard, o_shard, b_shard),
                      out_shardings=(p_shard, o_shard,
                                     jshard.replicated(jmesh)))
    tt = TrainConfig(opt=AdamWConfig(moment_dtype=torch.float32, lr=1e-3,
                                     eps=1.0),
                     warmup_steps=1, total_steps=5)
    ref_params = {k: np.asarray(v) for k, v in jpaths(jparams).items()}
    models, steps, opts = [], [], []
    mesh = make_host_mesh(device="cpu")
    for m in (mesh, None):
        model = build_model(_mini_cfg_port(), "cpu", seed=None)
        load_reference_params(model, ref_params)
        model.requires_grad_(True)
        models.append(model)
        opts.append(opt_state_from_reference(jopt, tt.opt, "cpu"))
        steps.append(make_train_step(model, tt, mesh=m,
                                     plan=collectives.BucketPlan(3, 2, 2)))
    for i in range(2):
        rng = np.random.default_rng(30 + i)
        tok = rng.integers(0, _mini_cfg().vocab_size, (4, 16)).astype(np.int32)
        with jmesh:
            jparams, jopt, jmet = jfn(jparams, jopt,
                                      {"tokens": tok, "labels": tok})
        mets = []
        for j in range(2):
            opts[j], met = steps[j](opts[j], {"tokens": torch.from_numpy(tok),
                                              "labels": torch.from_numpy(tok)})
            mets.append(met)
        for key in ("loss", "ce", "grad_norm", "lr_scale"):
            assert float(mets[0][key]) == float(mets[1][key]), key
            assert float(mets[0][key]) == pytest.approx(float(jmet[key]),
                                                        rel=1e-5), key
    for (name, p), q in zip(models[0].named_parameters(),
                            models[1].parameters()):
        assert torch.equal(p, q), name
    got = reference_paths(dict(models[0].named_parameters()))
    for path, want in jpaths(jparams).items():
        want = np.asarray(want)
        gap = np.abs(got[path].detach().numpy() - want).max()
        assert gap <= 1e-5 * np.abs(want).max(), (path, gap)
    from torch.distributed.tensor import DTensor
    for path, leaf in paths_from_tree(opts[0]).items():
        assert isinstance(leaf, DTensor), path
        assert leaf.placements == steps[0].shardings["opt_state"][
            path].placements, path
    assert int(opts[0]["step"].to_local()) == 2
    assert steps[0].shardings["params"]["layers.0.attn.wq"].spec == \
        sharding.P("data", "model")


def test_sharded_step_refuses_a_batch_that_does_not_split(one_rank):
    model = build_model(dataclasses.replace(
        get_config("minitron-4b", "smoke"), remat=False), "cpu", seed=0)
    tcfg = TrainConfig()
    _, opt = init_train_state(model, 0, tcfg)
    mesh = make_host_mesh(device="cpu")
    step = make_train_step(model, tcfg, mesh=mesh)
    tok = torch.zeros((3, 8), dtype=torch.int64)
    with pytest.raises(ValueError, match="microbatches|blocks"):
        make_train_step(model, dataclasses.replace(tcfg, microbatches=2),
                        mesh=mesh)(opt, {"tokens": tok, "labels": tok})
    opt, met = step(opt, {"tokens": tok, "labels": tok})
    assert np.isfinite(float(met["loss"]))


# ------------------------------ elastic ------------------------------- #
def test_carve_reshard_and_recover_round_trip(one_rank, tmp_path):
    from torch.distributed.tensor import DTensor
    model = build_model(_mini_cfg_port(torch.bfloat16), "cpu", seed=0)
    axes = model.param_axes()
    saved = reference_paths(dict(model.named_parameters()))
    save_checkpoint(str(tmp_path / "ck"), 1, saved)
    plan = elastic.plan_mesh(1, model_parallel=16)
    mesh = elastic.carve_mesh(plan, device="cpu")
    assert tuple(mesh.shape) == (1, 1) and mesh.mesh_dim_names == \
        ("data", "model")
    with pytest.raises(ValueError, match="cannot carve"):
        elastic.carve_mesh(elastic.MeshPlan((2, 1), ("data", "model"), 2),
                           device="cpu")
    placed = elastic.reshard_state(saved, axes, mesh)
    shardings = sharding.tree_shardings(saved, axes, mesh,
                                        sharding.default_rules(False))
    plan2, mesh2, state = elastic.recover(str(tmp_path / "ck"), axes, [0],
                                          device="cpu")
    assert plan2 == plan and tuple(mesh2.shape) == (1, 1)
    for tree in (placed, state):
        assert sorted(tree) == sorted(saved)
        for path, want in saved.items():
            got = tree[path]
            assert isinstance(got, DTensor)
            assert got.placements == shardings[path].placements, path
            assert torch.equal(got.full_tensor(), want.detach()), path
    assert state["layers.attn.wq"].placements[0] == \
        sharding.NamedSharding(mesh, sharding.P(None, "data")).placements[0]


def _mini_cfg_port(dtype=torch.float32):
    return dataclasses.replace(get_config("minitron-4b", "smoke"),
                               remat=False, dtype=dtype)


# --------------------------- several ranks ---------------------------- #
# one spawned group per world size runs every check; each group must end
# within its timeout (a few seconds when it passes)
GROUP_TIMEOUT_S = 240


def test_two_ranks_on_gloo(tmp_path):
    """Bucketed and int8 all-reduce against the ranks' sum and the
    reference's formula, the pipeline at S = 2 against the sequential
    stack, the data-parallel step against the one-process step on the whole
    batch, and ``recover`` onto a (2, 1) mesh."""
    _dist_workers.spawn_group(
        tmp_path, 2, ["bucketed_sum", "quantized_sum", "pipeline_stages",
                      "data_parallel_step", "reshard_round_trip"],
        GROUP_TIMEOUT_S)


def test_four_ranks_on_gloo(tmp_path):
    """The all-reduces and the pipeline at S = 4, and the data-parallel
    step on a (4, 1) mesh."""
    _dist_workers.spawn_group(
        tmp_path, 4, ["bucketed_sum", "quantized_sum", "pipeline_stages",
                      "data_parallel_step"], GROUP_TIMEOUT_S)


def test_quantized_formula_is_the_reference_s(one_rank):
    """The numpy rendering the multi-rank test holds the port to gives the
    reference's ``quantized_allreduce`` at one rank."""
    x = (np.random.default_rng(4).normal(size=101) * 2).astype(np.float32)
    for plan in ((3, 2, 1), (1, 1, 1), (4, 1, 3)):
        want = _reference_allreduce("quantized_allreduce", x,
                                    collectives.BucketPlan(*plan))
        np.testing.assert_array_equal(
            _dist_workers.quantized_formula([x], plan[0] * plan[1], plan[2]),
            want)
