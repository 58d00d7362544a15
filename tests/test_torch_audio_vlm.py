"""The port's audio (musicgen-large: 4 codebook streams) and vision-language
(qwen2-vl-2b: M-RoPE, QKV bias, the vision stub) serving paths against the
JAX package's, on the CPU.

Each smoke config (2 layers) with the reference's weights carried over by
``load_reference_params``: ``forward`` logits, ``prefill`` logits and 4
teacher-forced ``decode`` steps and the KV cache, with the reference at
``use_pallas=False`` (its oracles) and at ``use_pallas=True`` (its Pallas
flash attention in interpret mode), and the port at ``use_kernel`` False
and True (on the CPU both are the plain versions; the kernel route on the
card is ``chip_smoke.py``'s serve phase).  musicgen's tokens are (B, S, 4)
and its logits (B, S, 4, V); qwen2-vl's forward and prefill take seeded
patch embeddings in place of their first 8 positions.

Tolerances, as ``tests/test_torch_dense.py`` sets them: in float32 logits
and the KV cache agree to 1e-4 of their scale; in bfloat16 the port is
held to the reference's float32 run, no farther from it than the
reference's own bf16 run (1.5x per row, 1.25x on the RMS).  ``apply_mrope``
is held to the reference's with distinct t/h/w position streams, which the
models' text-like ids (all three equal) never exercise.
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
from repro_torch.models.layers import apply_mrope, apply_rope  # noqa: E402
from repro_torch.models.model import Model, build_model  # noqa: E402
from repro_torch.models.params import paths_from_tree  # noqa: E402

ARCHS = ["musicgen-large", "qwen2-vl-2b"]
B, S, STEPS = 2, 16, 4
_RNG = np.random.default_rng(0)
TOKENS = {"musicgen-large": _RNG.integers(0, 64, (B, S + STEPS, 4)),
          "qwen2-vl-2b": _RNG.integers(0, 256, (B, S + STEPS))}
PATCHES = {"musicgen-large": None,
           "qwen2-vl-2b": lm.patch_embeds(
               _RNG, B, get_config("qwen2-vl-2b", "smoke"))}

_REFERENCE = {}


def _reference(arch: str, dtype: str, use_pallas: bool):
    """The JAX model's outputs, computed once per (arch, dtype, route)."""
    key = (arch, dtype, use_pallas)
    if key not in _REFERENCE:
        jm, params = lm.jax_model(arch, dtype, use_pallas)
        _REFERENCE[key] = lm.run(jm, TOKENS[arch], S, STEPS, params,
                                 PATCHES[arch])
    return _REFERENCE[key]


def _port(arch: str, dtype: str, kernels: bool) -> dict:
    return lm.run(lm.port_model(arch, dtype, kernels), TOKENS[arch], S,
                  STEPS, patch_embeds=PATCHES[arch])


@pytest.fixture
def interpret_pallas(monkeypatch):
    """The reference's LM kernels in interpret mode, as its own tests run
    them."""
    interpret_reference_lm_kernels(monkeypatch)


@pytest.mark.parametrize("kernels", [False, True], ids=["oracles", "kernels"])
@pytest.mark.parametrize("arch", ARCHS)
def test_smoke_matches_reference_float32(arch, kernels, request):
    if kernels:
        request.getfixturevalue("interpret_pallas")
    want = _reference(arch, "float32", kernels)
    got = _port(arch, "float32", kernels)
    lm.assert_float32_parity(got, want, STEPS)
    assert got["len"].tolist() == [[S + STEPS]] * 2
    cb = get_config(arch, "smoke").n_codebooks
    assert got["forward"].shape[2:] == ((cb, 64) if cb else (256,))
    assert got["prefill"].shape[:2] == got["decode0"].shape[:2] == (B, 1)


@pytest.mark.parametrize("kernels", [False, True], ids=["oracles", "kernels"])
@pytest.mark.parametrize("arch", ARCHS)
def test_smoke_bfloat16_as_close_as_the_reference(arch, kernels, request):
    if kernels:
        request.getfixturevalue("interpret_pallas")
    got = _port(arch, "bfloat16", kernels)
    lm.assert_bfloat16_as_close(got, _reference(arch, "bfloat16", kernels),
                                _reference(arch, "float32", kernels), STEPS)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_mrope_matches_reference_on_distinct_streams(dtype):
    """Distinct t, h and w streams (each slot must take its own section's),
    at qwen2-vl's full sections (16, 24, 24) over D = 128 and its smoke
    ones, within 1e-6 of the values' scale in float32 (bf16: one rounding
    of the same float32 values, equal); on text-like ids (three equal
    streams) M-RoPE is RoPE bit for bit."""
    from repro.models.layers import apply_mrope as japply_mrope
    rng = np.random.default_rng(7)
    for sections, D in (((16, 24, 24), 128), ((2, 3, 3), 16)):
        x = rng.normal(size=(2, 9, 3, D)).astype(np.float32)
        pos3 = np.stack([rng.integers(0, 4096, (2, 9)) for _ in range(3)])
        jdt, tdt = lm.DTYPES[dtype]
        want = lm.f32(japply_mrope(jnp.asarray(x, jdt), jnp.asarray(pos3),
                                   1e6, sections))
        got = lm.f32(apply_mrope(torch.from_numpy(x).to(tdt),
                                 torch.from_numpy(pos3), 1e6, sections))
        tol = 1e-6 * np.abs(want).max() if dtype == "float32" else 0.0
        assert lm.err(got, want) <= tol, (sections, lm.err(got, want))
        # a wrong section map moves the result far beyond that
        swapped = lm.f32(apply_mrope(torch.from_numpy(x).to(tdt),
                                     torch.from_numpy(pos3[[1, 2, 0]]), 1e6,
                                     sections))
        assert lm.err(swapped, want) > 0.1
        text = torch.from_numpy(np.broadcast_to(pos3[0], (3, 2, 9)).copy())
        xt = torch.from_numpy(x).to(tdt)
        assert torch.equal(apply_mrope(xt, text, 1e6, sections),
                           apply_rope(xt, text[0], 1e6))
    with pytest.raises(AssertionError):
        apply_mrope(torch.zeros(1, 2, 1, 16), torch.zeros(3, 1, 2), 1e6,
                    (2, 3, 4))


def test_patch_embeds_replace_the_first_positions_in_both_packages():
    """qwen2-vl's vision stub: n patch embeddings, cast to the model's
    dtype, replace positions 0..n-1 and the token embeddings stay at the
    rest, in the port as in the reference; more patches than positions
    raise; a model without the stub ignores them, as the reference's
    does."""
    jm, params = lm.jax_model("qwen2-vl-2b", "bfloat16", False)
    tm = lm.port_model("qwen2-vl-2b", "bfloat16", False)
    toks = TOKENS["qwen2-vl-2b"][:, :12]
    pe = PATCHES["qwen2-vl-2b"]
    n = pe.shape[1]
    want = lm.f32(jm.embed(params, jnp.asarray(toks), jnp.asarray(pe)))
    got = tm.embed(torch.from_numpy(toks), torch.from_numpy(pe))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(lm.f32(got), want)
    np.testing.assert_array_equal(
        lm.f32(got[:, :n]), lm.f32(torch.from_numpy(pe).bfloat16()))
    np.testing.assert_array_equal(lm.f32(got[:, n:]),
                                  lm.f32(tm.embedding[torch.from_numpy(
                                      toks[:, n:])]))
    with pytest.raises(ValueError, match="patch embeddings"):
        tm.embed(torch.from_numpy(toks[:, :n - 1]), torch.from_numpy(pe))
    dense = build_model(get_config("minitron-4b", "smoke"), "cpu")
    t = torch.from_numpy(toks)
    assert torch.equal(dense.embed(t, torch.from_numpy(pe)), dense.embed(t))


def test_codebook_embeddings_and_heads_match_the_reference():
    """musicgen's streams: the 4 rows of ``embed_cb`` summed (in stream
    order, as the reference's Python ``sum``) and one ``head_cb`` product a
    stream, (B, S, CB, V), against the reference's ``embed`` and ``logits``
    in float32 (1e-6 of the scale); the unread ``embed`` and ``head``
    leaves are carried over all the same."""
    jm, params = lm.jax_model("musicgen-large", "float32", False)
    tm = lm.port_model("musicgen-large", "float32", False)
    toks = TOKENS["musicgen-large"]
    x = tm.embed(torch.from_numpy(toks))
    want = lm.f32(jm.embed(params, jnp.asarray(toks)))
    assert lm.err(lm.f32(x), want) <= 1e-6 * np.abs(want).max()
    lg = lm.f32(tm.logits(x))
    want = lm.f32(jm.logits(params, jnp.asarray(want)))
    assert lg.shape == want.shape == (B, S + STEPS, 4, 64)
    assert lm.err(lg, want) <= 1e-5 * np.abs(want).max()
    np.testing.assert_array_equal(lm.f32(tm.embedding),
                                  np.asarray(params["embed"]))
    np.testing.assert_array_equal(lm.f32(tm.head), np.asarray(params["head"]))


@pytest.mark.parametrize("arch", ARCHS)
def test_full_model_takes_the_reference_tree_whole(arch):
    """The full config's parameters on the ``meta`` device (no memory):
    the same names (the reference's stacked leaves per layer, ``embed`` as
    ``embedding``) and shapes as the reference's abstract tree, 3.26 B
    (musicgen-large) and 1.78 B (qwen2-vl-2b) parameters in both."""
    from repro.configs import get_config as jget
    from repro.models.model import build_model as jbuild
    jparams, _ = jbuild(jget(arch, "full")).init(None, abstract=True)
    want = {}
    for path, leaf in paths_from_tree(jparams).items():
        top, _, rest = path.partition(".")
        if top == "layers":
            for i in range(leaf.shape[0]):
                want[f"layers.{i}.{rest}"] = tuple(leaf.shape[1:])
        else:
            want["embedding" if path == "embed" else path] = tuple(leaf.shape)
    model = Model(get_config(arch, "full"), "meta")
    got = {name: tuple(p.shape) for name, p in model.named_parameters()}
    assert got == want
    n = sum(int(np.prod(s)) for s in got.values())
    assert round(n / 1e9, 2) == {"musicgen-large": 3.26,
                                 "qwen2-vl-2b": 1.78}[arch]


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_decode_consistency_on_the_port(arch):
    lm.prefill_decode_consistency(arch)


def test_decode_position_is_three_axis_under_mrope(monkeypatch):
    """qwen2-vl's decode ropes its token at (3, B, 1) positions, all three
    the cache's length before the step, in every layer."""
    from repro_torch.models import attention
    seen = []
    mrope = attention.apply_mrope

    def spy(x, positions, theta, sections):
        seen.append(positions.clone())
        return mrope(x, positions, theta, sections)

    monkeypatch.setattr(attention, "apply_mrope", spy)
    model = build_model(get_config("qwen2-vl-2b", "smoke"), "cpu")
    cache = model.init_cache(B, 12)
    model.prefill(torch.from_numpy(TOKENS["qwen2-vl-2b"][:, :9]), cache)
    seen.clear()
    model.decode(torch.from_numpy(TOKENS["qwen2-vl-2b"][:, 9:10]), cache)
    assert len(seen) == 2 * model.cfg.n_layers        # q and k a layer
    for pos in seen:
        assert pos.tolist() == [[[9]] * B] * 3


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_runs_end_to_end_on_the_cpu(arch, capsys):
    res = tserve.main(["--arch", arch, "--variant", "smoke", "--device",
                       "cpu", "--batch", "2", "--prompt-len", "10",
                       "--tokens", "5"])
    out = capsys.readouterr().out
    assert f"arch={arch}-smoke batch=2: prefill" in out
    assert "tok/s" in out and "device: cpu" in out
    cfg = get_config(arch, "smoke")
    shape = (2, 5, 4) if cfg.n_codebooks else (2, 5)
    assert tuple(res.tokens.shape) == shape and len(res.decode_ms) == 4
    assert ((res.tokens >= 0) & (res.tokens < cfg.vocab_size)).all()
    assert res.cache["layers"]["len"].flatten().tolist() == [14, 14]


def test_serve_takes_patch_embeds_and_codebook_teacher_forcing():
    """``serve`` hands ``patch_embeds`` to the prefill alone (its logits
    differ from a run without them; decode runs on); with codebooks a
    teacher-forced run is fed (B, n, CB) tokens and keeps (B, 1, CB, V)
    logits a step."""
    cfg = dataclasses.replace(get_config("qwen2-vl-2b", "smoke"),
                              dtype=torch.float32)
    model = build_model(cfg, "cpu", seed=2)
    prompts = tserve.make_prompts(cfg, B, 10, seed=2, device="cpu")
    pe = torch.from_numpy(PATCHES["qwen2-vl-2b"])
    with_pe = tserve.serve(model, prompts, 3, patch_embeds=pe,
                           keep_logits=True)
    without = tserve.serve(model, prompts, 3, keep_logits=True)
    assert (with_pe.prefill_logits - without.prefill_logits).abs().max() > 0
    assert with_pe.tokens.shape == (B, 3)

    cfg = dataclasses.replace(get_config("musicgen-large", "smoke"),
                              dtype=torch.float32)
    model = build_model(cfg, "cpu", seed=2)
    prompts = tserve.make_prompts(cfg, B, 10, seed=2, device="cpu")
    assert prompts.shape == (B, 10, 4)
    run = tserve.serve(model, prompts, 4, keep_logits=True)
    forced = tserve.serve(model, prompts, 4, force=run.tokens,
                          keep_logits=True)
    assert run.tokens.shape == forced.tokens.shape == (B, 4, 4)
    assert torch.equal(run.tokens, forced.tokens)
    for a, b in zip(run.decode_logits, forced.decode_logits):
        assert a.shape == (B, 1, 4, 64) and torch.equal(a, b)
