"""One run of one cell: set-up, the measured window, the check of what the
window served against the plain reference, and the metrics.

``run_cell`` takes a ``Cell`` (a configuration, a traffic mix and the
limits of the check) and runs it on a device; ``bench/run.py`` builds the
cell from its files and prints the result.  The program under test is
``repro_torch``: the harness builds its model, hands it the weights the
benchmark made, and drives its serving entry points.  The window is timed
on the host's clock, each request or step ending when its tokens are on
the host.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import importlib
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

from bench import families, traffic, weights
from bench.check import Kept, check_decode, check_prefill
from bench.trace import Trace, read as read_trace

ROOT = Path(__file__).resolve().parents[1]
BENCH = ROOT / "bench"
# top-level module names the run's process must not hold (the JAX package
# and JAX itself); compared whole, so ``repro_torch`` passes
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
# decode steps run in set-up, after the first batch's prefill
WARM_STEPS = 2


def load(kind: str, name: str) -> dict:
    return json.loads((BENCH / kind / f"{name}.json").read_text())


@dataclasses.dataclass
class Cell:
    name: str
    cfg: dict           # configs/<config>.json
    mix: dict           # traffic/<mix>.json
    limits: dict        # {number compared: limit}
    sample: dict        # what the check compares (see bench.check)


def cell(name: str) -> Cell:
    wl = load("workloads", name)
    cfg = load("configs", wl["config"])
    departs = cfg.get("departs_from_published")
    if not (isinstance(departs, list)
            and all(isinstance(d, str) for d in departs)):
        raise ValueError(f"configs/{wl['config']}.json lists no "
                         f"departs_from_published (a list, [] for none)")
    return Cell(name, cfg, load("traffic", wl["traffic"]), wl["limits"],
                wl["sample"])


def rendition(cfg: dict) -> str:
    """One line on what a configuration runs against its source."""
    departs = cfg["departs_from_published"]
    return (f"{cfg['name']}: as the repository's model defines it, after "
            f"{cfg['source']}; " + ("; ".join(departs) if departs else
                                    "no departure from it"))


@dataclasses.dataclass
class Prefill:
    batch: int
    length: int
    wall_s: float


@dataclasses.dataclass
class Step:
    batch: int
    valid: int          # cache positions the step reads, its own included
    wall_s: float
    enqueue_s: float    # from the step's start to ``Model.decode`` returning


@dataclasses.dataclass
class Run:
    """What a run measured; the metric readers take it."""
    cell: Cell
    setup_s: float
    window_s: float
    prefills: list[Prefill]
    steps: list[Step]
    ttft_s: list[float]             # a request each
    tokens: int                     # prompt tokens taken + tokens generated
    requests: int
    peak_bytes: int
    trace: Trace | None = None
    checks: dict = dataclasses.field(default_factory=dict)


def program_config(cfg: dict):
    from repro_torch.models.config import ModelConfig
    kw = {k: cfg[k] for k in families.of(cfg).PROGRAM_KEYS if k in cfg}
    return ModelConfig(**kw, dtype=getattr(torch, cfg["dtype"]))


def build_program(cfg: dict, seed: int, device):
    """The program's model with the benchmark's weights in its named
    parameters."""
    from repro_torch.models.model import build_model
    model = build_model(program_config(cfg), device, seed=None)
    W = weights.make(cfg, traffic.subseed(seed, traffic.STREAM_WEIGHTS),
                     device)
    params = dict(model.named_parameters())
    if set(params) != set(W):
        odd = sorted(set(params) ^ set(W))[:8]
        raise RuntimeError(f"the program's parameters and the benchmark's "
                           f"differ: {odd}")
    for name, p in params.items():
        if p.shape != W[name].shape or p.dtype != W[name].dtype:
            raise RuntimeError(f"{name}: the program has {tuple(p.shape)} "
                               f"{p.dtype}, the benchmark "
                               f"{tuple(W[name].shape)} {W[name].dtype}")
        p.data = W[name]
    return model


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def span(name: str):
    return torch.profiler.record_function(name)


def _serve_module():
    return importlib.import_module("repro_torch.launch.serve")


# --------------------------------------------------------------------- #
# prefill pool
# --------------------------------------------------------------------- #
def kept_names(cache: dict) -> dict[tuple[str, str], str]:
    """{(stack, leaf): the name a kept request's state keys it by} for
    every leaf of the cache's stacks but ``len``: the leaf's own name where
    no other stack holds it, ``<stack>.<leaf>`` where two or more do."""
    pairs = [(stack, leaf) for stack, leaves in cache.items()
             for leaf in leaves if leaf != "len"]
    held = collections.Counter(leaf for _, leaf in pairs)
    return {(stack, leaf): leaf if held[leaf] == 1 else f"{stack}.{leaf}"
            for stack, leaf in pairs}


def _keep(cache: dict, row: int, picks: dict) -> dict:
    """One request's decode state, on the host, keyed as ``kept_names``
    keys it: every stacked leaf's row, where ``picks`` names the leaf only
    the entries it picks along the row's axis 1 (cache positions of keys
    and values, heads of the SSM state)."""
    out = {}
    for (stack, leaf), name in kept_names(cache).items():
        part = cache[stack][leaf][:, row]
        if name in picks:
            part = part.index_select(1, picks[name].to(part.device))
        out[name] = part.to("cpu")
    return out


def _prefill_warm(model, c: Cell, seed: int, device) -> None:
    serve = _serve_module().serve
    for B, S in traffic.shapes(c.mix):
        b = traffic.Batch(0, B, S, 1)
        prompts = traffic.prompts(b, c.cfg["vocab_size"], seed, device,
                                  stream=traffic.STREAM_WARM)
        res = serve(model, prompts, 1, keep_logits=True)
        res.tokens.cpu()
        res.prefill_logits[0, 0].to("cpu")
        _keep(res.cache, 0, picks(b, seed, c))
        del res


def _prefill_window(model, c: Cell, seed: int, seconds: float, device):
    serve_mod = _serve_module()
    V = c.cfg["vocab_size"]
    prefills, ttft, kept = [], [], []
    tokens = shared = 0
    start = time.perf_counter()
    with span("window"):
        for b in traffic.batches(c.mix, seed):
            with span("client"):
                prompts = traffic.prompts(b, V, seed, device)
                sync(device)
            t0 = time.perf_counter()
            with span("serve"):
                res = serve_mod.serve(model, prompts, 1, keep_logits=True)
            with span("sync"):
                res.tokens.to("cpu")
            wall = time.perf_counter() - t0
            prefills.append(Prefill(b.batch, b.length, wall))
            ttft += [wall] * b.batch
            tokens += b.batch * (b.length + 1)
            with span("client"):
                row = kept_row(b, seed, shared)
                shared += b.batch > 1
                chosen = picks(b, seed, c)
                logits = res.prefill_logits[row, 0].to("cpu")
                kept.append(Kept(b, row, logits,
                                 _keep(res.cache, row, chosen), chosen))
            del res
            if time.perf_counter() - start >= seconds:
                break
    window = time.perf_counter() - start
    return dict(window_s=window, prefills=prefills, steps=[], ttft_s=ttft,
                tokens=tokens, requests=len(ttft)), kept


def kept_row(b: traffic.Batch, seed: int, nth: int) -> int:
    """The request of batch ``b`` whose state a run keeps for the check,
    drawn from the seed: in the ``nth`` batch of two or more requests of
    the window, from the first half of the batch where ``nth`` is even and
    from the second half where it is odd."""
    if b.batch == 1:
        return 0
    rng = np.random.default_rng(traffic.subseed(seed, traffic.STREAM_SAMPLE,
                                                b.index))
    half = b.batch // 2
    lo, hi = (0, half) if nth % 2 == 0 else (half, b.batch)
    return int(lo + rng.integers(hi - lo))


def picks(b: traffic.Batch, seed: int, c: Cell) -> dict:
    """What a kept request's check compares of the state it hands on: the
    family's picks (``bench.families``), drawn from the seed."""
    return families.of(c.cfg).picks(b, seed, c)


# --------------------------------------------------------------------- #
# decode pool
# --------------------------------------------------------------------- #
@dataclasses.dataclass
class Generation:
    """A decode batch in flight: its cache, the token it feeds next, and
    every token it has generated so far, on the host ((B, n) int64)."""
    batch: traffic.Batch
    cache: dict
    feed: torch.Tensor
    history: list[torch.Tensor]

    @property
    def done(self) -> int:
        return len(self.history)


def _start_generation(model, c: Cell, b: traffic.Batch, seed: int, device):
    prompts = traffic.prompts(b, c.cfg["vocab_size"], seed, device)
    with span("init_cache"):
        cache = model.init_cache(b.batch, b.length + b.new_tokens
                                 + c.mix["cache_slack"])
    with span("prefill"):
        logits, cache = model.prefill(prompts, cache)
    tok = torch.argmax(logits, dim=-1)
    with span("sync"):
        host = tok.to("cpu")
    return Generation(b, cache, tok, [host])


def _decode_step(model, g: Generation, steps: list[Step]) -> None:
    t0 = time.perf_counter()
    with span("decode"):
        logits, g.cache = model.decode(g.feed, g.cache)
    t1 = time.perf_counter()
    with span("argmax"):
        g.feed = torch.argmax(logits, dim=-1)
    with span("sync"):
        host = g.feed.to("cpu")
    wall = time.perf_counter() - t0
    g.history.append(host)
    steps.append(Step(g.batch.batch, g.batch.length + g.done - 1, wall,
                      t1 - t0))


def _decode_warm(model, c: Cell, seed: int, device) -> list[Generation]:
    b = next(traffic.batches(c.mix, seed))
    g = _start_generation(model, c, b, seed, device)
    for _ in range(WARM_STEPS):
        _decode_step(model, g, [])
    return [g]


def _decode_window(model, c: Cell, seed: int, seconds: float, device,
                   gens: list[Generation]):
    batches = traffic.batches(c.mix, seed)
    next(batches)                       # the first is in flight already
    steps, prefills, ttft = [], [], []
    tokens = 0
    start = time.perf_counter()
    with span("window"):
        while time.perf_counter() - start < seconds:
            g = gens[-1]
            if g.done >= g.batch.new_tokens:
                g.cache = None
                b = next(batches)
                t0 = time.perf_counter()
                g = _start_generation(model, c, b, seed, device)
                wall = time.perf_counter() - t0
                prefills.append(Prefill(b.batch, b.length, wall))
                ttft += [wall] * b.batch
                tokens += b.batch * (b.length + 1)
                gens.append(g)
                continue
            _decode_step(model, g, steps)
            tokens += g.batch.batch
    window = time.perf_counter() - start
    return dict(window_s=window, prefills=prefills, steps=steps,
                ttft_s=ttft, tokens=tokens,
                requests=sum(g.batch.batch for g in gens))


# --------------------------------------------------------------------- #
def _profiler(device):
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    return profile(activities=acts)


def _peak_reset(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)


def _peak(device) -> int:
    if torch.device(device).type == "cuda":
        return int(torch.cuda.max_memory_allocated(device))
    return 0


def _free(device) -> None:
    import gc
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def run_cell(c: Cell, seed: int, seconds: float, trace: bool, device,
             t_start: float, control: bool = False,
             witness: bool = False) -> Run:
    """Set up, measure for ``seconds``, then check.  ``t_start``: the
    host clock when the run began (the set-up is counted from it).  With
    ``control`` the check also reads the control's numbers (the reference
    in float8 in the program's place) on the same requests, and with
    ``witness`` a prefill's check those of the reference in bfloat16."""
    model = build_program(c.cfg, seed, device)
    decode = c.mix["kind"] == "decode"
    gens = None
    if decode:
        gens = _decode_warm(model, c, seed, device)
    else:
        _prefill_warm(model, c, seed, device)
    sync(device)
    prof = _profiler(device) if trace else contextlib.nullcontext()
    with prof:
        _peak_reset(device)
        setup_s = time.perf_counter() - t_start
        if decode:
            out = _decode_window(model, c, seed, seconds, device, gens)
            kept = None
        else:
            out, kept = _prefill_window(model, c, seed, seconds, device)
        sync(device)
        peak = _peak(device)
    run = Run(c, setup_s, trace=read_trace(prof) if trace else None,
              peak_bytes=peak, **out)
    # the program's state is freed before the reference runs
    histories = None
    if decode:
        histories = [(g.batch, torch.cat(g.history, dim=1)) for g in gens]
        for g in gens:
            g.cache = None
    del model, gens
    _free(device)
    if decode:
        run.checks = check_decode(c, seed, histories, device, control)
    else:
        run.checks = check_prefill(c, seed, kept, device, control, witness)
    _free(device)
    return run


def forbidden_modules() -> list[str]:
    """Top-level names of loaded modules that a run may not hold."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def percentile(values: list[float], q: float) -> float:
    return float(np.percentile(np.asarray(values, dtype=np.float64), q))


