"""The port's dense (GQA) serving path against the JAX package's, on the CPU.

Each dense smoke config (minitron-4b, internlm2-20b, qwen2.5-32b with its
QKV bias, llama3-405b: 2 layers of GQA attention + SwiGLU) with the
reference's weights carried over by ``load_reference_params``: ``forward``
logits, ``prefill`` logits and 4 teacher-forced ``decode`` steps, with the
reference at ``use_pallas=False`` (its oracles) and at ``use_pallas=True``
(its Pallas flash attention in interpret mode), and the port at
``use_kernel`` False and True (on the CPU both are the plain versions; the
kernel route on the card is ``chip_smoke.py``'s serve phase).

Tolerances, as ``tests/test_torch_serve.py`` sets them for zamba2: in
float32 logits and the KV cache agree to 1e-4 of their scale and greedy
picks are compared where the best logit leads by more than twice that; in
bfloat16 the port is held to the reference's float32 run, no farther from
it than the reference's own bf16 run (1.5x per row, 1.25x on the RMS).
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
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.models.params import paths_from_tree  # noqa: E402

DENSE = ["minitron-4b", "internlm2-20b", "qwen2.5-32b", "llama3-405b"]
B, S, STEPS = 2, 16, 4
TOKENS = np.random.default_rng(0).integers(0, 256, (B, S + STEPS))

_REFERENCE = {}


def _reference(arch: str, dtype: str, use_pallas: bool):
    """The JAX model's outputs, computed once per (arch, dtype, route)."""
    key = (arch, dtype, use_pallas)
    if key not in _REFERENCE:
        jm, params = lm.jax_model(arch, dtype, use_pallas)
        _REFERENCE[key] = lm.run(jm, TOKENS, S, STEPS, params)
    return _REFERENCE[key]


@pytest.fixture
def interpret_pallas(monkeypatch):
    """The reference's LM kernels in interpret mode, as its own tests run
    them."""
    interpret_reference_lm_kernels(monkeypatch)


@pytest.mark.parametrize("kernels", [False, True], ids=["oracles", "kernels"])
@pytest.mark.parametrize("arch", DENSE)
def test_dense_smoke_matches_reference_float32(arch, kernels, request):
    if kernels:
        request.getfixturevalue("interpret_pallas")
    want = _reference(arch, "float32", kernels)
    got = lm.run(lm.port_model(arch, "float32", kernels), TOKENS, S, STEPS)
    lm.assert_float32_parity(got, want, STEPS)
    assert got["aux"] == want["aux"] == 0.0
    assert got["len"].tolist() == [[S + STEPS]] * 2


@pytest.mark.parametrize("kernels", [False, True], ids=["oracles", "kernels"])
@pytest.mark.parametrize("arch", DENSE)
def test_dense_smoke_bfloat16_as_close_as_the_reference(arch, kernels,
                                                        request):
    if kernels:
        request.getfixturevalue("interpret_pallas")
    got = lm.run(lm.port_model(arch, "bfloat16", kernels), TOKENS, S, STEPS)
    lm.assert_bfloat16_as_close(got, _reference(arch, "bfloat16", kernels),
                                _reference(arch, "float32", kernels), STEPS)


def test_qwen_smoke_carries_its_qkv_bias():
    """qwen2.5-32b's smoke config has q, k and v biases; the reference's
    init makes them zeros, so the float32 parity above would pass without
    them: here they are set, and both packages still agree."""
    assert get_config("qwen2.5-32b", "smoke").qkv_bias
    jm, params = lm.jax_model("qwen2.5-32b", "float32", False)
    rng = np.random.default_rng(5)
    for name in ("bq", "bk", "bv"):
        leaf = params["layers"]["attn"][name]
        params["layers"]["attn"][name] = jnp.asarray(
            rng.normal(0.0, 0.5, leaf.shape).astype(np.float32))
    want = lm.run(jm, TOKENS, S, STEPS, params)
    cfg = dataclasses.replace(get_config("qwen2.5-32b", "smoke"),
                              dtype=torch.float32)
    tm = build_model(cfg, "cpu", seed=None)
    from repro_torch.models.params import load_reference_params
    load_reference_params(tm, {k: np.asarray(v) for k, v
                               in paths_from_tree(params).items()})
    got = lm.run(tm, TOKENS, S, STEPS)
    lm.assert_float32_parity(got, want, STEPS)
    zero_bias = lm.run(lm.port_model("qwen2.5-32b", "float32", False),
                       TOKENS, S, STEPS)
    assert lm.err(zero_bias["prefill"], want["prefill"]) > 1e-3


@pytest.mark.parametrize("arch", ["minitron-4b", "llama3-405b"])
def test_prefill_decode_consistency_on_the_port(arch):
    lm.prefill_decode_consistency(arch)


def test_init_follows_the_reference_rule():
    """Stacked layer weights have std 1/sqrt(n_layers) whatever their
    fan-in; norms are ones; the embedding and head keep their 0.02; the
    reference's own init shows the same spreads; a seed fixes the
    weights."""
    from repro.configs import get_config as jget
    from repro.models.model import build_model as jbuild
    cfg = dataclasses.replace(get_config("minitron-4b", "smoke"),
                              dtype=torch.float32)
    model = build_model(cfg, "cpu", seed=3)
    jparams, _ = jbuild(dataclasses.replace(
        jget("minitron-4b", "smoke"), dtype=jnp.float32)).init(
            jax.random.PRNGKey(3))
    jflat = paths_from_tree(jparams)
    n = cfg.n_layers
    want = {f"layers.{leaf}": 1 / np.sqrt(n) for leaf in (
        "attn.wq", "attn.wk", "attn.wv", "attn.wo", "ffn.w_gate",
        "ffn.w_up", "ffn.w_down")}
    want.update({"embed": 0.02, "head": 0.02})
    own = dict(model.named_parameters())
    for path, std in want.items():
        top, _, rest = path.partition(".")
        if top == "layers":
            port = torch.stack([own[f"layers.{i}.{rest}"] for i in range(n)])
        else:
            port = own["embedding" if path == "embed" else path]
        for got in (port.std().item(), float(np.std(np.asarray(jflat[path])))):
            assert abs(got / std - 1) < 0.15, (path, got, std)
    for name in ("layers.0.ln1", "layers.1.ln2", "ln_f"):
        assert torch.equal(own[name], torch.ones(cfg.d_model))
    again = build_model(cfg, "cpu", seed=3)
    assert all(torch.equal(p, q) for p, q in zip(model.parameters(),
                                                 again.parameters()))


def test_dense_cache_layout_is_the_reference_s():
    """``init_cache``: k, v (n, B, L, Hkv, hd) in the model's dtype and len
    (n, 1) int32, zeroed, as the reference's."""
    from repro.configs import get_config as jget
    from repro.models.model import build_model as jbuild
    cfg = get_config("internlm2-20b", "smoke")
    cache = build_model(cfg, "cpu").init_cache(3, 10)
    jcache, _ = jbuild(jget("internlm2-20b", "smoke")).init_cache(3, 10)
    assert set(cache) == set(jcache) == {"layers"}
    for key in ("k", "v", "len"):
        assert tuple(cache["layers"][key].shape) == \
            jcache["layers"][key].shape, key
        assert not cache["layers"][key].any()
    assert cache["layers"]["k"].dtype == torch.bfloat16
    assert cache["layers"]["len"].dtype == torch.int32


def test_serve_runs_minitron_end_to_end_on_the_cpu(capsys):
    res = tserve.main(["--arch", "minitron-4b", "--variant", "smoke",
                       "--device", "cpu", "--batch", "2", "--prompt-len", "8",
                       "--tokens", "5"])
    out = capsys.readouterr().out
    assert "arch=minitron-4b-smoke batch=2: prefill" in out
    assert "tok/s" in out and "device: cpu" in out
    assert res.tokens.shape == (2, 5) and len(res.decode_ms) == 4
    assert ((res.tokens >= 0) & (res.tokens < 512)).all()
    assert res.cache["layers"]["len"].flatten().tolist() == [12, 12]
