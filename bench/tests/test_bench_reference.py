"""The plain references against the port's plain route, in float32 at the
port's smoke sizes on the CPU: the same weights (``bench.weights``), the
same prompts, the logits and the decode state a prefill hands on, and the
logits of decode steps through the cache."""
from __future__ import annotations

import pytest
import torch

from bench import check, families, harness, traffic, weights
from bench.reference import dense, hybrid, quant
from bench.tests.smoke import smoke_cfg

# relative L2 of a float32 result against the other float32 route: their
# sums run in different orders (chunked scans of other chunk sizes, the
# decode's one-token recurrence against the chunked scan, attention blocked
# or not), ~1e-6 at these sizes
F32_REL = 1e-4


def _program(cfg: dict, seed: int):
    from repro_torch.models.model import build_model
    model = build_model(harness.program_config(cfg), "cpu", seed=None)
    W = weights.make(cfg, seed, "cpu")
    for name, p in model.named_parameters():
        p.data = W[name].float()
    return model, W


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    return (torch.linalg.vector_norm(a.float() - b.float())
            / torch.linalg.vector_norm(b.float())).item()


@pytest.mark.parametrize("name,ref", [("zamba2-7b", hybrid),
                                      ("minitron-4b", dense)])
@pytest.mark.parametrize("S", [5, 24])
def test_prefill_matches_the_port(name, ref, S):
    from repro_torch.launch.serve import serve
    cfg = smoke_cfg(name, dtype="float32")
    model, W = _program(cfg, 3)
    b = traffic.Batch(0, 2, S, 1)
    prompts = traffic.prompts(b, cfg["vocab_size"], 3, "cpu")
    res = serve(model, prompts, 1, keep_logits=True)
    pos = torch.arange(S)
    for row in range(2):
        want = ref.prefill(W, cfg, prompts[row], pos)
        assert _rel(res.prefill_logits[row, 0], want["logits"]) < F32_REL
        heads = torch.tensor([0, 2]) if name == "zamba2-7b" else None
        picks = {"k": pos, "v": pos} | ({"ssm": heads} if heads is not None
                                        else {})
        got = harness._keep(res.cache, row, picks)
        assert set(got) == {k for k in want if k != "logits"}
        cut = families.of(cfg).CUT
        err, where = check.state_err(got, check._picked(want, picks, cut),
                                     "cpu")
        assert err < F32_REL, where


def _decode_matches(name: str, ref) -> float:
    """The port's prefill, then its decode steps through the cache,
    against the reference over the whole sequence at once; the largest
    relative gap of the logits."""
    from repro_torch.launch.serve import serve
    cfg = smoke_cfg(name, dtype="float32")
    model, W = _program(cfg, 4)
    b = traffic.Batch(0, 2, 12, 6)
    prompts = traffic.prompts(b, cfg["vocab_size"], 4, "cpu")
    res = serve(model, prompts, 6, keep_logits=True)
    got = torch.cat([res.prefill_logits] + res.decode_logits, dim=1)
    top = 0.0
    for row in range(2):
        seq = torch.cat([prompts[row], res.tokens[row, :-1]])
        want = ref.logits_from(W, cfg, seq, 11)
        assert want.shape == got[row].shape
        top = max(top, _rel(got[row], want))
        assert check.gap(want, res.tokens[row]).max().item() < 1e-4
    return top


def test_dense_decode_matches_the_port():
    assert _decode_matches("minitron-4b", dense) < F32_REL


def test_hybrid_decode_matches_the_port():
    """The hybrid's decode takes the one-token Mamba2 recurrence and the
    shared block's cached keys and values; the reference the chunked scan
    over the whole sequence."""
    assert _decode_matches("zamba2-7b", hybrid) < F32_REL


def test_bf16_program_stays_near_the_reference():
    # the served precision: bf16 weights and activations, f32 state
    from repro_torch.launch.serve import serve
    cfg = smoke_cfg("zamba2-7b")
    model = harness.build_program(cfg, 5, "cpu")
    b = traffic.Batch(0, 2, 16, 1)
    prompts = traffic.prompts(b, cfg["vocab_size"], 5, "cpu")
    res = serve(model, prompts, 1, keep_logits=True)
    W = weights.make(cfg, traffic.subseed(5, traffic.STREAM_WEIGHTS), "cpu")
    want = hybrid.prefill(W, cfg, prompts[1], torch.arange(16))
    assert 0 < _rel(res.prefill_logits[1, 0], want["logits"]) < 0.1


def test_fp8_rounds_to_float8_values():
    x = torch.randn(64, 32, generator=torch.Generator().manual_seed(0))
    for kind in ("weight", "activation"):
        q = quant.fp8(x, kind)
        assert torch.equal(quant.fp8(q, kind), q)
        rel = (q - x).abs() / x.abs().clamp(min=1e-3)
        assert 0 < _rel(q, x) < 0.1 and rel.median() < 2 ** -3
    assert quant.fp8(x, "weight").abs().max() <= x.abs().max()


def test_weights_follow_the_seed():
    cfg = smoke_cfg("zamba2-7b")
    a, b = weights.make(cfg, 1, "cpu"), weights.make(cfg, 1, "cpu")
    assert list(a) == list(weights.spec(cfg))
    assert all(torch.equal(a[k], b[k]) for k in a)
    c = weights.make(cfg, 2, "cpu")
    assert not torch.equal(a["head"], c["head"])
    A = torch.exp(a["layers.0.mixer.A_log"].float())
    assert A.min() >= 1 - 1e-2 and A.max() <= 16 + 1e-1
    dt = torch.nn.functional.softplus(a["layers.0.mixer.dt_bias"].float())
    assert dt.min() >= 1e-3 * 0.98 and dt.max() <= 1e-1 * 1.02
    std = a["layers.0.mixer.w_in"].float().std().item()
    assert std == pytest.approx(cfg["d_model"] ** -0.5, rel=0.1)
