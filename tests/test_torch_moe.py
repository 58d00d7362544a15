"""The port's mixture of experts and the MoE serving path against the JAX
package's, on the CPU.

``moe_forward`` is held to ``repro.models.moe.moe_forward`` on the same
parameters and inputs: the softmax gate (mixtral), the sigmoid gate that
``attn_type="mla"`` selects with a shared expert (DeepSeek's), tokens
dropped at a low capacity factor, exact ties in the router, and the
load-balance aux; with ample capacity it equals both packages'
``moe_forward_oracle``.  Then the mixtral-8x22b smoke model end to end as
``tests/test_torch_dense.py`` runs the dense ones, at a prompt inside its
window of 32 and at one past it (the ring cache in prefill and decode).

In bfloat16 the expert choice is pinned (``_pinned_bf16``): routing is a
discrete function of bf16-rounded activations, and the reference's own
bf16 run and the port's each send some tokens of these prompts to another
expert than float32 does, near-ties that fall either way, and not the same
tokens.  Unpinned, a logit row's distance to float32
is decided by which tokens flipped, not by the arithmetic; pinned, every
run takes the float32 reference's experts and the bf16 arithmetic alone is
compared.  Float32 and the function-level tests compare the routing itself.
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
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.models.params import (  # noqa: E402
    InitCtx, load_reference_params, paths_from_tree,
)

ARCH = "mixtral-8x22b"
GATES = {"softmax": {}, "sigmoid": {"attn_type": "mla", "n_shared_experts": 1}}


def _cfgs(gate: str, **extra):
    """The (reference, port) float32 configs of the smoke mixtral, with the
    gate's fields set at the function level."""
    from repro.configs import get_config as jget
    over = {**GATES[gate], **extra}
    return (dataclasses.replace(jget(ARCH, "smoke"), dtype=jnp.float32,
                                **over),
            dataclasses.replace(get_config(ARCH, "smoke"),
                                dtype=torch.float32, **over))


def _moe_pair(gate: str, seed: int = 0, **extra):
    """A reference MoE parameter tree and the port's ``MoE`` filled from
    it, and their configs."""
    from repro.models import moe as jmoe
    from repro.models.params import InitCtx as JCtx
    jcfg, tcfg = _cfgs(gate, **extra)
    jp = jmoe.moe_init(jcfg, JCtx(key=jax.random.PRNGKey(seed),
                                  dtype=jnp.float32, abstract=False), "moe")
    tp = tmoe.moe_init(tcfg, InitCtx(torch.float32, torch.device("cpu")))
    load_reference_params(tp, {k: np.asarray(v) for k, v
                               in paths_from_tree(jp).items()})
    return jp, tp, jcfg, tcfg


def _x(cfg, B=2, S=16, seed=1):
    return np.random.default_rng(seed).normal(
        size=(B, S, cfg.d_model)).astype(np.float32)


def _dropped(jp, x, jcfg) -> int:
    """(token, expert) pairs past their expert's capacity, counted from the
    reference's own routing."""
    from repro.models import moe as jmoe
    xt = jnp.asarray(x.reshape(-1, x.shape[-1]))
    logits = xt @ jp["router"]
    probs = jax.nn.sigmoid(logits) if jcfg.attn_type == "mla" \
        else jax.nn.softmax(logits, axis=-1)
    _, topi = jax.lax.top_k(probs, jcfg.experts_per_token)
    counts = np.bincount(np.asarray(topi).ravel(), minlength=jcfg.n_experts)
    C = jmoe.expert_capacity(xt.shape[0], jcfg)
    return int(np.maximum(counts - C, 0).sum())


def _close(got, want, rel=1e-5):
    got, want = lm.f32(got), lm.f32(want)
    assert got.shape == want.shape
    assert lm.err(got, want) <= rel * max(float(np.abs(want).max()), 1.0), \
        lm.err(got, want)


@pytest.mark.parametrize("capacity", [None, 0.5], ids=["ample", "drops"])
@pytest.mark.parametrize("gate", list(GATES))
def test_moe_forward_matches_reference(gate, capacity):
    """Output and aux against the reference on the same parameters and
    inputs; at capacity factor 0.5 tokens are really dropped (counted from
    the reference's routing), and they are the same tokens."""
    from repro.models import moe as jmoe
    extra = {} if capacity is None else {"capacity_factor": capacity}
    jp, tp, jcfg, tcfg = _moe_pair(gate, **extra)
    x = _x(tcfg)
    want, want_aux = jmoe.moe_forward(jp, jnp.asarray(x), jcfg)
    got, got_aux = tmoe.moe_forward(tp, torch.from_numpy(x), tcfg)
    _close(got, want)
    assert abs(float(got_aux) - float(want_aux)) <= 1e-6 * float(want_aux)
    assert hasattr(tp, "shared") == (gate == "sigmoid")
    n_drop = _dropped(jp, x, jcfg)
    if capacity is None:
        assert n_drop == 0
    else:
        assert n_drop > 0
        oracle = tmoe.moe_forward_oracle(tp, torch.from_numpy(x), tcfg)
        assert lm.err(lm.f32(got), lm.f32(oracle)) > 1e-2


@pytest.mark.parametrize("gate", list(GATES))
def test_moe_forward_with_ample_capacity_is_the_oracle(gate):
    """Nothing dropped: the dispatch equals the per-expert dense oracle,
    the port's and the reference's."""
    from repro.models import moe as jmoe
    jp, tp, jcfg, tcfg = _moe_pair(gate, seed=2)
    x = _x(tcfg, seed=3)
    assert _dropped(jp, x, jcfg) == 0
    got, _ = tmoe.moe_forward(tp, torch.from_numpy(x), tcfg)
    ours = tmoe.moe_forward_oracle(tp, torch.from_numpy(x), tcfg)
    theirs = jmoe.moe_forward_oracle(jp, jnp.asarray(x), jcfg)
    _close(got, ours)
    _close(ours, theirs)


def test_router_ties_go_to_the_lower_expert_as_in_jax():
    """A zero router gives every expert the same probability: JAX's top_k
    takes experts 0 and 1 for every token (the lower index first), and so
    must the port, whatever order ``torch.topk`` would give; with capacity
    8 per expert, the stable dispatch keeps the first 8 tokens of each
    and drops the rest in the same places."""
    from repro.models import moe as jmoe
    jp, tp, jcfg, tcfg = _moe_pair("softmax", capacity_factor=0.25)
    jp["router"] = jnp.zeros_like(jp["router"])
    with torch.no_grad():
        tp.router.zero_()
    x = _x(tcfg)
    _, topv, topi = tmoe._route(tp, torch.from_numpy(x).reshape(-1, 64),
                                tcfg)
    assert topi.tolist() == [[0, 1]] * 32
    assert torch.equal(topv, torch.full((32, 2), 0.5))
    want, _ = jmoe.moe_forward(jp, jnp.asarray(x), jcfg)
    got, _ = tmoe.moe_forward(tp, torch.from_numpy(x), tcfg)
    _close(got, want)
    kept = np.abs(lm.f32(got)).reshape(32, -1).sum(-1) > 0
    assert kept.tolist() == [True] * 8 + [False] * 24


def test_expert_capacity_is_the_reference_s():
    from repro.models import moe as jmoe
    for gate in GATES:
        jcfg, tcfg = _cfgs(gate)
        for n in (1, 2, 8, 31, 32, 1000, 16384):
            assert tmoe.expert_capacity(n, tcfg) == \
                jmoe.expert_capacity(n, jcfg)
    full = get_config(ARCH, "full")
    assert tmoe.expert_capacity(8 * 2048, full) == 5120
    assert tmoe.expert_capacity(8, full) == 8


# --------------------------------------------------------------------- #
# the mixtral smoke model end to end
# --------------------------------------------------------------------- #
B, STEPS = 2, 4
PROMPTS = {"inside-window": 16, "past-window": 40}     # the window is 32
TOKENS = np.random.default_rng(0).integers(0, 256, (B, 40 + STEPS))

_REFERENCE = {}


def _reference(S: int, dtype: str, use_pallas: bool):
    key = (S, dtype, use_pallas)
    if key not in _REFERENCE:
        jm, params = lm.jax_model(ARCH, dtype, use_pallas)
        _REFERENCE[key] = lm.run(jm, TOKENS[:, :S + STEPS], S, STEPS, params)
    return _REFERENCE[key]


@pytest.fixture
def interpret_pallas(monkeypatch):
    interpret_reference_lm_kernels(monkeypatch)


@pytest.mark.parametrize("kernels", [False, True], ids=["oracles", "kernels"])
@pytest.mark.parametrize("prompt", list(PROMPTS))
def test_mixtral_smoke_matches_reference_float32(prompt, kernels, request):
    if kernels:
        request.getfixturevalue("interpret_pallas")
    S = PROMPTS[prompt]
    want = _reference(S, "float32", kernels)
    got = lm.run(lm.port_model(ARCH, "float32", kernels),
                 TOKENS[:, :S + STEPS], S, STEPS)
    lm.assert_float32_parity(got, want, STEPS)
    assert want["aux"] > 0
    L = got["k"].shape[2]
    assert L == (32 if S > 32 else S + STEPS + 4)     # a ring past the window


def _pinned_bf16(monkeypatch, S: int, kernels: bool):
    """``_lm_parity.pinned_bf16`` of the mixtral smoke model on the first
    ``S`` tokens and ``STEPS`` decode steps."""
    return lm.pinned_bf16(monkeypatch, ARCH, TOKENS[:, :S + STEPS], S, STEPS,
                          kernels)


@pytest.mark.parametrize("kernels", [False, True], ids=["oracles", "kernels"])
@pytest.mark.parametrize("prompt", list(PROMPTS))
def test_mixtral_smoke_bfloat16_as_close_as_the_reference(
        prompt, kernels, request, monkeypatch):
    """bf16, each run on the float32 reference's experts: the port no
    farther from the reference's float32 logits than the reference's own
    bf16 run (1.5x per row, 1.25x on the RMS)."""
    if kernels:
        request.getfixturevalue("interpret_pallas")
    got, ref_bf16, ref_f32 = _pinned_bf16(monkeypatch, PROMPTS[prompt],
                                          kernels)
    lm.assert_bfloat16_as_close(got, ref_bf16, ref_f32, STEPS)


def test_ring_cache_holds_each_position_at_its_slot():
    """Past the window the cache keeps the last 32 positions, position p at
    slot p % 32, after the prefill and after each decode step: the keys
    there equal the full forward's keys at those positions."""
    from repro_torch.models import attention as tattn
    from repro_torch.models.layers import rms_norm
    cfg = dataclasses.replace(get_config(ARCH, "smoke"), dtype=torch.float32)
    model = build_model(cfg, "cpu", seed=4)
    S, W = 40, cfg.sliding_window
    toks = torch.from_numpy(TOKENS)
    x = model.embed(toks)
    pos = model._positions(toks)
    layer = model.layers[0]
    _, k_all, _ = tattn._project_qkv(layer.attn, rms_norm(
        x, layer.ln1, cfg.norm_eps), cfg, pos)          # layer 0's keys
    cache = model.init_cache(B, S + STEPS + 4)
    assert cache["layers"]["k"].shape[2] == W
    model.prefill(toks[:, :S], cache)
    for j in range(STEPS + 1):
        n = S + j                                       # positions cached
        want = k_all[:, n - W:n]
        slots = torch.arange(n - W, n) % W
        got = cache["layers"]["k"][0][:, slots]
        assert float((got - want).abs().max()) <= 1e-5, j
        assert int(cache["layers"]["len"][0, 0]) == n
        if j < STEPS:
            model.decode(toks[:, n:n + 1], cache)


def test_prefill_decode_consistency_on_the_port():
    lm.prefill_decode_consistency(ARCH)


def test_forward_aux_is_the_layers_sum():
    """``forward``'s aux is the sum over layers of each MoE's load-balance
    loss, as the reference's ``_scan_stack`` sums it."""
    cfg = dataclasses.replace(get_config(ARCH, "smoke"), dtype=torch.float32)
    model = build_model(cfg, "cpu", seed=5)
    toks = torch.from_numpy(TOKENS[:, :12])
    _, aux = model.forward(toks)
    from repro_torch.models.model import _dense_layer_fwd
    x, total = model.embed(toks), 0.0
    for layer in model.layers:
        x, _, a = _dense_layer_fwd(layer, x, cfg, model._positions(toks),
                                   "train")
        total += float(a)
    assert float(aux) == pytest.approx(total, rel=1e-6)
    assert aux.dtype == torch.float32 and total > 0


def test_init_follows_the_reference_rule():
    """Stacked MoE leaves (router and the experts' (E, d, f) tensors) have
    std 1/sqrt(n_layers), norms are ones, as the reference's own init."""
    from repro.configs import get_config as jget
    from repro.models.model import build_model as jbuild
    cfg = dataclasses.replace(get_config(ARCH, "smoke"), dtype=torch.float32)
    model = build_model(cfg, "cpu", seed=3)
    jparams, _ = jbuild(dataclasses.replace(
        jget(ARCH, "smoke"), dtype=jnp.float32)).init(jax.random.PRNGKey(3))
    jflat = paths_from_tree(jparams)
    n = cfg.n_layers
    own = dict(model.named_parameters())
    for leaf in ("moe.router", "moe.w_gate", "moe.w_up", "moe.w_down",
                 "attn.wq", "attn.wo"):
        port = torch.stack([own[f"layers.{i}.{leaf}"] for i in range(n)])
        ref = np.asarray(jflat[f"layers.{leaf}"])
        assert tuple(port.shape) == ref.shape, leaf
        for got in (port.std().item(), float(np.std(ref))):
            assert abs(got * np.sqrt(n) - 1) < 0.15, (leaf, got)
    for name in ("layers.0.ln1", "layers.1.ln2", "ln_f"):
        assert torch.equal(own[name], torch.ones(cfg.d_model))
    assert not any(name.startswith(("layers.0.ffn", "layers.0.moe.shared"))
                   for name in own)


def test_serve_runs_mixtral_end_to_end_on_the_cpu(capsys):
    """Past the window: a 40-token prompt and 4 decode steps on the ring."""
    res = tserve.main(["--arch", ARCH, "--variant", "smoke", "--device",
                       "cpu", "--batch", "2", "--prompt-len", "40",
                       "--tokens", "5"])
    out = capsys.readouterr().out
    assert "arch=mixtral-8x22b-smoke batch=2: prefill" in out
    assert "tok/s" in out and "device: cpu" in out
    assert res.tokens.shape == (2, 5) and len(res.decode_ms) == 4
    assert res.cache["layers"]["k"].shape[2] == 32
    assert res.cache["layers"]["len"].flatten().tolist() == [44, 44]
