"""The port's multi-head latent attention (MLA), DeepSeek's first_k_dense
stack and the deepseek-v3-671b serving path against the JAX package's, on
the CPU.

Each MLA function is held to its counterpart in ``repro.models.attention``
on the reference's weights carried over by ``load_reference_params``, in
float32 to 1e-5 of the output's scale: ``_mla_qkv``, ``mla_forward``,
``mla_prefill`` (output and latent cache) and the absorbed ``mla_decode``
after a prefill, which is other arithmetic than the forward and is held to
the reference's decode, not to the forward.  Then the deepseek smoke model
whole (3 layers, the first dense; MLA; 8 experts, top 2 by a sigmoid gate,
one shared expert; capacity factor 8) as ``tests/test_torch_dense.py``
runs the dense ones: float32 to 1e-4 of the logits and the cache, with
the routing itself compared; bf16 no farther from the reference's float32
than its own bf16, each run on the float32 reference's experts
(``_lm_parity.pinned_bf16``).  On the CPU the port's kernel route is the
plain version; the kernel at MLA's head width runs on the card
(``tests/test_torch_lm_kernels.py``, ``chip_smoke.py``).
"""
import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

import _lm_parity as lm  # noqa: E402
from _port_parity import interpret_reference_lm_kernels  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.models.params import (  # noqa: E402
    InitCtx, load_reference_params, paths_from_tree,
)

ARCH = "deepseek-v3-671b"
B, S, STEPS = 2, 12, 4
TOKENS = np.random.default_rng(0).integers(0, 256, (B, S + STEPS))


# --------------------------------------------------------------------- #
# the MLA functions
# --------------------------------------------------------------------- #
def _cfgs(**over):
    from repro.configs import get_config as jget
    return (dataclasses.replace(jget(ARCH, "smoke"), dtype=jnp.float32,
                                **over),
            dataclasses.replace(get_config(ARCH, "smoke"),
                                dtype=torch.float32, **over))


def _mla_pair(seed: int = 0):
    """A reference MLA parameter tree, the port's ``MLA`` filled from it,
    and their float32 configs."""
    from repro.models import attention as jattn
    from repro.models.params import InitCtx as JCtx
    jcfg, tcfg = _cfgs()
    jp = jattn.mla_init(jcfg, JCtx(key=jax.random.PRNGKey(seed),
                                   dtype=jnp.float32, abstract=False), "attn")
    tp = tattn.mla_init(tcfg, InitCtx(torch.float32, torch.device("cpu")))
    load_reference_params(tp, {k: np.asarray(v) for k, v
                               in paths_from_tree(jp).items()})
    return jp, tp, jcfg, tcfg


def _x(cfg, n=S + STEPS, seed=1):
    return np.random.default_rng(seed).normal(
        size=(B, n, cfg.d_model)).astype(np.float32)


def _pos(n, offset=0):
    return np.broadcast_to(np.arange(n)[None] + offset, (B, n)).copy()


def _close(got, want, rel=1e-5):
    got, want = lm.f32(got), lm.f32(want)
    assert got.shape == want.shape
    bound = rel * max(float(np.abs(want).max()), 1e-30)
    assert lm.err(got, want) <= bound, (lm.err(got, want), bound)


def test_mla_leaves_are_the_reference_s():
    jp, tp, jcfg, _ = _mla_pair()
    flat = paths_from_tree(jp)
    own = dict(tp.named_parameters())
    assert set(own) == set(flat) == {"wq_a", "wq_b", "wkv_a", "wkv_b", "wo"}
    for name, leaf in flat.items():
        assert tuple(own[name].shape) == leaf.shape, name
    H = jcfg.n_heads
    assert tuple(own["wkv_b"].shape) == (jcfg.kv_lora_rank, H,
                                         jcfg.qk_nope_head_dim
                                         + jcfg.v_head_dim)


def test_mla_qkv_matches_reference():
    """q, k (B, S, H, dn + dr), v (B, S, H, dv); k's RoPE half is one
    k_rope for every head."""
    from repro.models import attention as jattn
    jp, tp, jcfg, tcfg = _mla_pair()
    x, pos = _x(tcfg), _pos(S + STEPS)
    want = jattn._mla_qkv(jp, jnp.asarray(x), jcfg, jnp.asarray(pos))
    got = tattn._mla_qkv(tp, torch.from_numpy(x), tcfg, torch.from_numpy(pos))
    for g, w in zip(got, want):
        _close(g, w)
    dn = tcfg.qk_nope_head_dim
    k = got[1]
    assert torch.equal(k[:, :, :1, dn:].expand_as(k[..., dn:]), k[..., dn:])


@pytest.mark.parametrize("kernels", [False, True], ids=["oracles", "kernels"])
def test_mla_forward_matches_reference(kernels, monkeypatch):
    """The padded-v attention, through the reference's oracle or its
    Pallas kernel in interpret mode, and the port's plain route or its
    kernel route (on the CPU, the plain version)."""
    from repro.models import attention as jattn
    if kernels:
        interpret_reference_lm_kernels(monkeypatch)
    jp, tp, jcfg, tcfg = _mla_pair()
    jcfg = dataclasses.replace(jcfg, use_pallas=kernels)
    tcfg = dataclasses.replace(tcfg, use_kernel=kernels)
    x, pos = _x(tcfg), _pos(S + STEPS)
    want = jattn.mla_forward(jp, jnp.asarray(x), jcfg, jnp.asarray(pos))
    got = tattn.mla_forward(tp, torch.from_numpy(x), tcfg,
                            torch.from_numpy(pos))
    _close(got, want)


def _prefilled(jp, tp, jcfg, tcfg, x, L=S + STEPS + 2):
    """Both packages' prefill of x[:, :S] into an empty cache of L."""
    from repro.models import attention as jattn
    from repro.models.params import InitCtx as JCtx
    jcache = jattn.mla_cache_init(jcfg, JCtx(key=None, dtype=jnp.float32,
                                             abstract=False), "c", B, L)
    tcache = tattn.mla_cache_init(tcfg, B, L, device="cpu")
    pos = _pos(S)
    jo, jcache = jattn.mla_prefill(jp, jnp.asarray(x[:, :S]), jcfg,
                                   jnp.asarray(pos), jcache)
    to, tcache = tattn.mla_prefill(tp, torch.from_numpy(x[:, :S]), tcfg,
                                   torch.from_numpy(pos), tcache)
    return (jo, jcache), (to, tcache)


def test_mla_prefill_matches_reference_and_caches_the_latents():
    jp, tp, jcfg, tcfg = _mla_pair()
    x = _x(tcfg)
    (jo, jcache), (to, tcache) = _prefilled(jp, tp, jcfg, tcfg, x)
    _close(to, jo)
    assert set(tcache) == set(jcache) == {"ckv", "krope", "len"}
    for key in ("ckv", "krope"):
        assert tuple(tcache[key].shape) == jcache[key].shape
        _close(tcache[key], jcache[key])
        assert not tcache[key][:, S:].any()
    assert tcache["ckv"].shape[-1] == tcfg.kv_lora_rank
    assert tcache["krope"].shape[-1] == tcfg.qk_rope_head_dim
    assert tcache["len"].tolist() == np.asarray(jcache["len"]).tolist() == [S]


def test_mla_decode_matches_the_reference_s_absorbed_decode():
    """``STEPS`` absorbed decode steps after the prefill: each step's
    output and the latent cache against the reference's ``mla_decode``,
    and the cache's length counter bumped in place."""
    from repro.models import attention as jattn
    jp, tp, jcfg, tcfg = _mla_pair()
    x = _x(tcfg)
    (_, jcache), (_, tcache) = _prefilled(jp, tp, jcfg, tcfg, x)
    for j in range(STEPS):
        xt, pos = x[:, S + j:S + j + 1], _pos(1, S + j)
        jo, jcache = jattn.mla_decode(jp, jnp.asarray(xt), jcfg,
                                      jnp.asarray(pos), jcache)
        same = tcache["len"]
        to, tcache = tattn.mla_decode(tp, torch.from_numpy(xt), tcfg,
                                      torch.from_numpy(pos), tcache)
        _close(to, jo)
        assert tcache["len"] is same and tcache["len"].tolist() == [S + j + 1]
    for key in ("ckv", "krope"):
        _close(tcache[key], jcache[key])


def test_mla_decode_is_the_forward_at_its_position():
    """The absorbed decode and the full forward are two forms of one
    attention: in float32 each decode step gives the forward's output at
    that position, within 1e-4 of its scale (the sums run in another
    order and through the latent space)."""
    _, tp, _, tcfg = _mla_pair(seed=3)
    x = _x(tcfg)
    full = tattn.mla_forward(tp, torch.from_numpy(x), tcfg,
                             torch.from_numpy(_pos(S + STEPS)))
    cache = tattn.mla_cache_init(tcfg, B, S + STEPS, device="cpu")
    tattn.mla_prefill(tp, torch.from_numpy(x[:, :S]), tcfg,
                      torch.from_numpy(_pos(S)), cache)
    for j in range(STEPS):
        out, cache = tattn.mla_decode(
            tp, torch.from_numpy(x[:, S + j:S + j + 1]), tcfg,
            torch.from_numpy(_pos(1, S + j)), cache)
        _close(out, full[:, S + j:S + j + 1], rel=1e-4)


# --------------------------------------------------------------------- #
# the deepseek smoke model whole
# --------------------------------------------------------------------- #
_REFERENCE = {}


def _reference(dtype: str, use_pallas: bool):
    key = (dtype, use_pallas)
    if key not in _REFERENCE:
        jm, params = lm.jax_model(ARCH, dtype, use_pallas)
        _REFERENCE[key] = lm.run(jm, TOKENS, S, STEPS, params)
    return _REFERENCE[key]


@pytest.fixture
def interpret_pallas(monkeypatch):
    interpret_reference_lm_kernels(monkeypatch)


@pytest.mark.parametrize("kernels", [False, True], ids=["oracles", "kernels"])
def test_deepseek_smoke_matches_reference_float32(kernels, request):
    """forward, prefill and 4 teacher-forced decode steps: logits to 1e-4
    of their scale, both stacks' latent caches to 1e-4 and their lengths
    equal, the load-balance aux of the MoE layers."""
    if kernels:
        request.getfixturevalue("interpret_pallas")
    want = _reference("float32", kernels)
    got = lm.run(lm.port_model(ARCH, "float32", kernels), TOKENS, S, STEPS)
    lm.assert_float32_parity(got, want, STEPS)
    assert want["aux"] > 0
    assert set(k for k in got if "." in k) == {
        "dense_layers.ckv", "dense_layers.krope", "dense_layers.len"}
    assert got["dense_layers.len"].tolist() == [[S + STEPS]]
    assert got["len"].tolist() == [[S + STEPS]] * 2


def test_deepseek_smoke_routing_is_the_reference_s(monkeypatch):
    """In float32 the port's router picks the reference's experts, in the
    same order, at every MoE call of the forward, the prefill and each
    decode step."""
    from repro_torch.models import moe as tmoe
    top_k, route = jax.lax.top_k, tmoe._route
    theirs, ours = [], []

    def recording_jax(probs, k):
        v, i = top_k(probs, k)
        theirs.append(np.asarray(i))
        return v, i

    def recording_port(p, xt, cfg):
        out = route(p, xt, cfg)
        ours.append(out[2].numpy())
        return out

    monkeypatch.setattr(jax.lax, "top_k", recording_jax)
    jm, params = lm.jax_model(ARCH, "float32", False, **lm.UNROLLED)
    lm.run(jm, TOKENS, S, STEPS, params)
    monkeypatch.setattr(tmoe, "_route", recording_port)
    lm.run(lm.port_model(ARCH, "float32", False), TOKENS, S, STEPS)
    assert len(ours) == len(theirs) == lm.moe_calls(jm.cfg, STEPS) == 12
    for a, b in zip(ours, theirs):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("kernels", [False, True], ids=["oracles", "kernels"])
def test_deepseek_smoke_bfloat16_as_close_as_the_reference(
        kernels, request, monkeypatch):
    """bf16, each run on the float32 reference's experts: the port no
    farther from the reference's float32 logits than the reference's own
    bf16 run (1.5x per row, 1.25x on the RMS)."""
    if kernels:
        request.getfixturevalue("interpret_pallas")
    got, ref_bf16, ref_f32 = lm.pinned_bf16(monkeypatch, ARCH, TOKENS, S,
                                            STEPS, kernels)
    lm.assert_bfloat16_as_close(got, ref_bf16, ref_f32, STEPS)


def test_prefill_decode_consistency_on_the_port():
    lm.prefill_decode_consistency(ARCH)


def test_decode_position_comes_from_the_dense_stack(monkeypatch):
    """A decode step ropes every layer of both stacks at the position the
    dense stack's ``len`` held before the step, a copy taken before any
    layer bumps the counters in place; after the step every layer's
    counter has risen by one."""
    from repro_torch.models import model as tmodel
    cfg = dataclasses.replace(get_config(ARCH, "smoke"), dtype=torch.float32)
    model = build_model(cfg, "cpu", seed=2)
    toks = torch.from_numpy(TOKENS)
    cache = model.init_cache(B, S + 4)
    model.prefill(toks[:, :S], cache)
    seen = []
    decode = tattn.mla_decode

    def recording(p, x, cfg, positions, layer_cache):
        seen.append((positions.tolist(), int(layer_cache["len"][0])))
        return decode(p, x, cfg, positions, layer_cache)

    monkeypatch.setitem(tmodel._ATTENTION["mla"], "decode", recording)
    model.decode(toks[:, S:S + 1], cache)
    assert seen == [([[S]] * B, S)] * cfg.n_layers
    lens = torch.cat([c["len"].flatten() for c in cache.values()])
    assert lens.tolist() == [S + 1] * cfg.n_layers


def test_init_follows_each_stack_s_depth():
    """A stacked leaf has std 1/sqrt(its own stack's depth): the dense
    stack's 1 layer 1/sqrt(1), the MoE stack's 2 layers 1/sqrt(2), as the
    reference's own init; norms are ones; the embedding and head keep
    their 0.02; a seed fixes the weights."""
    from repro.configs import get_config as jget
    from repro.models.model import build_model as jbuild
    cfg = dataclasses.replace(get_config(ARCH, "smoke"), dtype=torch.float32)
    model = build_model(cfg, "cpu", seed=3)
    jparams, _ = jbuild(dataclasses.replace(
        jget(ARCH, "smoke"), dtype=jnp.float32)).init(jax.random.PRNGKey(3))
    jflat = paths_from_tree(jparams)
    own = dict(model.named_parameters())
    depth = {"dense_layers": cfg.first_k_dense,
             "layers": cfg.n_layers - cfg.first_k_dense}
    assert depth == {"dense_layers": 1, "layers": 2}
    leaves = {"dense_layers": ("attn.wq_a", "attn.wq_b", "attn.wkv_a",
                               "attn.wkv_b", "attn.wo", "ffn.w_gate",
                               "ffn.w_up", "ffn.w_down"),
              "layers": ("attn.wq_b", "attn.wkv_b", "attn.wo", "moe.router",
                         "moe.w_gate", "moe.w_down", "moe.shared.w_up")}
    for stack, names in leaves.items():
        n = depth[stack]
        for leaf in names:
            port = torch.stack([own[f"{stack}.{i}.{leaf}"] for i in range(n)])
            ref = np.asarray(jflat[f"{stack}.{leaf}"])
            assert tuple(port.shape) == ref.shape, (stack, leaf)
            for got in (port.std().item(), float(np.std(ref))):
                assert abs(got * np.sqrt(n) - 1) < 0.15, (stack, leaf, got)
    for path in ("embed", "head"):
        got = own["embedding" if path == "embed" else path].std().item()
        assert abs(got / 0.02 - 1) < 0.15
    for name in ("dense_layers.0.ln1", "layers.1.ln2", "ln_f"):
        assert torch.equal(own[name], torch.ones(cfg.d_model))
    again = build_model(cfg, "cpu", seed=3)
    assert all(torch.equal(p, q) for p, q in zip(model.parameters(),
                                                 again.parameters()))


def test_load_reference_params_matches_every_leaf():
    """The port's parameters and the reference's flat tree, unstacked,
    are the same names with the same shapes, nothing left over on either
    side; a reference tree without one dense-stack leaf is refused."""
    _, params = lm.jax_model(ARCH, "float32", False)
    flat = {k: np.asarray(v) for k, v in paths_from_tree(params).items()}
    model = build_model(get_config(ARCH, "smoke"), "cpu", seed=None)
    names = set()
    for path, arr in flat.items():
        top, _, rest = path.partition(".")
        if top in ("layers", "dense_layers"):
            names |= {f"{top}.{i}.{rest}" for i in range(arr.shape[0])}
        else:
            names.add("embedding" if path == "embed" else path)
    own = dict(model.named_parameters())
    assert names == set(own)
    assert any(n.startswith("dense_layers.0.ffn.") for n in own)
    assert any(n.startswith("layers.1.moe.shared.") for n in own)
    load_reference_params(model, flat)
    del flat["dense_layers.attn.wkv_b"]
    with pytest.raises(KeyError, match="no reference value"):
        load_reference_params(model, flat)


def test_deepseek_cache_layout_is_the_reference_s():
    """``init_cache``: ``dense_layers`` and ``layers``, each {ckv (n, B, L,
    kv_lora), krope (n, B, L, dr) in the model's dtype, len (n, 1) int32},
    zeroed, as the reference's."""
    from repro.configs import get_config as jget
    from repro.models.model import build_model as jbuild
    cfg = get_config(ARCH, "smoke")
    cache = build_model(cfg, "cpu").init_cache(3, 10)
    jcache, _ = jbuild(jget(ARCH, "smoke")).init_cache(3, 10)
    assert set(cache) == set(jcache) == {"dense_layers", "layers"}
    for stack in cache:
        assert set(cache[stack]) == set(jcache[stack]) == {"ckv", "krope",
                                                          "len"}
        for key, val in cache[stack].items():
            assert tuple(val.shape) == jcache[stack][key].shape, (stack, key)
            assert not val.any()
        assert cache[stack]["ckv"].dtype == torch.bfloat16
        assert cache[stack]["len"].dtype == torch.int32


def test_serve_runs_deepseek_end_to_end_on_the_cpu(capsys):
    res = tserve.main(["--arch", ARCH, "--variant", "smoke", "--device",
                       "cpu", "--batch", "2", "--prompt-len", "8",
                       "--tokens", "5"])
    out = capsys.readouterr().out
    assert "arch=deepseek-v3-smoke batch=2: prefill" in out
    assert "tok/s" in out and "device: cpu" in out
    assert res.tokens.shape == (2, 5) and len(res.decode_ms) == 4
    assert ((res.tokens >= 0) & (res.tokens < 256)).all()
    assert res.cache["dense_layers"]["len"].flatten().tolist() == [12]
    assert res.cache["layers"]["len"].flatten().tolist() == [12, 12]


# --------------------------------------------------------------------- #
# chip_smoke.py's float64 attention bound for MLA's activations
# --------------------------------------------------------------------- #
def _chip_smoke():
    import sys
    from pathlib import Path
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke
    return chip_smoke


@pytest.mark.parametrize("scale", [1.0, 10.0, 30.0, 100.0])
def test_float64_attention_bound_holds_for_float32_orders_and_has_power(
        scale):
    """``chip_smoke.conditioned_attention_gaps`` at MLA's head width, on
    bf16 inputs whose scores reach ~1e1 to ~1e5 (the reference's init
    gives MLA ~1e5-1e6): the bf16 kernel's order of operations
    (``chip_smoke._attention_order``), the bf16 plain version and the
    float32 plain route all lie within ATTN_BF16_C units beyond the
    float32 scores' reach of float64 attention, and within twice that of
    each other.  Where the scores are large (scale 10 and up) the same
    order with its scores kept in bf16 does not: it picks other keys than
    the rounding allows.  At scale 1 that control needs 2048 keys to show
    (``tests/test_torch_lm_kernels.py``'s faults)."""
    from repro_torch.kernels import ops
    cs = _chip_smoke()
    rng = np.random.default_rng(int(scale))
    B_, S_, H, D = 1, 256, 4, 192

    def bf16(shape, s):
        return torch.from_numpy(rng.normal(size=shape) * s).float().bfloat16()
    q, k = bf16((B_, S_, H, D), scale), bf16((B_, S_, H, D), scale)
    v = bf16((B_, S_, H, D), 1.0)
    want = ops.plain_attention(q, k, v, causal=True)
    C = cs.ATTN_BF16_C
    for out in (cs._attention_order(q, k, v, ""), want,
                ops.plain_attention(q.float(), k.float(), v.float(),
                                    causal=True)):
        r = cs.conditioned_attention_gaps(q, k, v, out, want, "bf16")
        assert r["kernel"] <= C and r["plain"] <= C and r["pair"] <= 2 * C, r
        assert r["rows"] == B_ * S_ * H
    r = cs.conditioned_attention_gaps(q, k, v,
                                      cs._attention_order(q, k, v, "s"), want,
                                      "bf16")
    assert r["score_max"] > scale ** 2
    if scale >= 10:
        assert r["kernel"] > 30 * C and r["near_rows"] > 0, r
