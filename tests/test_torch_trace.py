"""The serving path's spans (``repro_torch.trace``), on the CPU.

One prefill and one decode step of zamba2-7b's, minitron-4b's and
rwkv6-1.6b's smoke configurations under ``torch.profiler`` record each
span the number of times the configuration gives, each inside the span
the call nests it in; without a profiler a span is the one shared null
context; and the profiler changes no logit and no cache entry.
"""
from __future__ import annotations

import collections
import re
from pathlib import Path

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import trace
from repro_torch.configs import get_config
from repro_torch.models.model import build_model

SRC = Path(trace.__file__).resolve().parent
B, S = 2, 16


def _model(arch: str):
    return build_model(get_config(arch, "smoke"), "cpu", seed=0)


def _serve(model, prompts):
    """init_cache, one prefill and one decode step -> (logits, cache)."""
    cache = model.init_cache(B, S + 4)
    logits, cache = model.prefill(prompts, cache)
    step, cache = model.decode(torch.argmax(logits, dim=-1), cache)
    return [logits, step], cache


def _prompts(model):
    gen = torch.Generator().manual_seed(7)
    return torch.randint(0, model.cfg.vocab_size, (B, S), generator=gen)


def _spans(prof) -> list[tuple[str, str | None]]:
    """(span, the innermost span around it or None) of every ``repro.``
    span the profiler recorded, in the order they opened."""
    evs = sorted(((e.correlation_id(), e.name(), e.start_ns(), e.end_ns())
                  for e in prof.profiler.kineto_results.events()
                  if e.name().startswith(trace.PREFIX)))
    out = []
    for i, (_, name, a, b) in enumerate(evs):
        parents = [n for _, n, pa, pb in evs[:i] if pa <= a and b <= pb]
        out.append((name, parents[-1] if parents else None))
    return out


def _expected(cfg) -> collections.Counter:
    """(span, parent) counts of init_cache, a prefill and a decode step."""
    n, want = cfg.n_layers, collections.Counter()
    want[("repro.init_cache", None)] = 1
    for step in ("repro.prefill", "repro.decode"):
        attend = "repro.attend" if step == "repro.prefill" \
            else "repro.decode_attend"
        n_attn = n // cfg.hybrid_attn_every if cfg.hybrid_attn_every else n
        want[(step, None)] += 1
        want[("repro.embed", step)] += 1
        want[("repro.head", step)] += 1
        want[("repro.rms_norm", "repro.head")] += 1
        if cfg.rwkv:        # ln1, ln2 and the time mix's ln_x a layer
            want[("repro.rms_norm", step)] += 3 * n
            continue
        want[("repro.rms_norm", step)] += 2 * n_attn
        for child in ("repro.attention", "repro.mlp"):
            want[(child, step)] += n_attn
        for child in ("repro.rope", "repro.cache_write", attend):
            want[(child, "repro.attention")] += n_attn
        if cfg.family != "hybrid":
            continue
        if step == "repro.prefill":
            want[("repro.rms_norm", step)] += n
            want[("repro.mamba2", step)] += n
            for child in ("repro.causal_conv", "repro.scan",
                          "repro.rms_norm"):
                want[(child, "repro.mamba2")] += n
        else:               # the layer's norm and the mixer's gated one
            want[("repro.rms_norm", step)] += 2 * n
    return want


@pytest.mark.parametrize("arch", ["zamba2-7b", "minitron-4b", "rwkv6-1.6b"])
def test_spans_count_and_nest_as_the_calls(arch):
    model = _model(arch)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _serve(model, _prompts(model))
    got = collections.Counter(_spans(prof))
    assert got == _expected(model.cfg)


def test_a_span_without_a_profiler_is_the_shared_null_context():
    off = trace.span("repro.prefill")
    assert off is trace.span("repro.decode")
    with off:
        pass
    with profile(activities=[ProfilerActivity.CPU]):
        on = trace.span("repro.prefill")
        assert on is not off
        with on:
            pass
    assert trace.span("repro.prefill") is off


@pytest.mark.parametrize("arch", ["zamba2-7b", "minitron-4b"])
def test_the_profiler_changes_no_logit_and_no_cache_entry(arch):
    model = _model(arch)
    prompts = _prompts(model)
    plain_logits, plain_cache = _serve(model, prompts)
    with profile(activities=[ProfilerActivity.CPU]):
        traced_logits, traced_cache = _serve(model, prompts)
    for a, b in zip(plain_logits, traced_logits):
        assert torch.equal(a, b)
    assert plain_cache.keys() == traced_cache.keys()
    for stack in plain_cache:
        for leaf, t in plain_cache[stack].items():
            assert torch.equal(t, traced_cache[stack][leaf]), (stack, leaf)


def span_names() -> set[str]:
    """Every span name the package's source opens."""
    pat = re.compile(r"""\bspan\(\s*["']([^"']+)["']""")
    return {m for path in SRC.rglob("*.py")
            for m in pat.findall(path.read_text())}


def test_every_span_is_named_under_the_prefix():
    assert span_names() == {trace.PREFIX + n for n in (
        "init_cache", "prefill", "decode", "embed", "head", "mamba2",
        "causal_conv", "scan", "attention", "rope", "cache_write", "attend",
        "decode_attend", "mlp", "rms_norm")}
