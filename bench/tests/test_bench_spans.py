"""Device and idle time put down to the program's spans (``bench.spans``)
and the five readers of them, on synthetic traces: host spans, launch
calls and the device operations they launch, written by a small tape."""
from __future__ import annotations

import contextlib
import dataclasses
import re
from pathlib import Path

import pytest

from bench import harness, kernel_names, run, spans
from bench.roofline import PEAK_BF16_FLOPS, PEAK_BYTES
from bench.trace import SPANS, Trace, read

TINY_DENSE = {"family": "dense", "n_layers": 2, "d_model": 8, "n_heads": 2,
              "n_kv_heads": 1, "d_ff": 16, "vocab_size": 32}
TINY_HYBRID = {"family": "hybrid", "n_layers": 2, "d_model": 4, "n_heads": 2,
               "n_kv_heads": 2, "d_ff": 8, "vocab_size": 10, "ssm_state": 2,
               "ssm_head_dim": 2, "ssm_expand": 2, "ssm_conv": 4,
               "ssm_chunk": 4, "hybrid_attn_every": 2}


class Tape:
    """A traced window written in order: host spans nest as ``with``
    blocks; a launch takes host time and queues one device operation,
    which starts once the device is free and after the call began."""

    def __init__(self, program: bool = True):
        self.t, self.free = 0, 0
        self.host, self.ops = [], []
        self.program = program

    def tick(self, dt: int = 10) -> int:
        self.t += dt
        return self.t

    @contextlib.contextmanager
    def span(self, name: str):
        if name.startswith(spans.PREFIX) and not self.program:
            yield
            return
        a = self.tick()
        yield
        self.host.append((name, a, self.tick()))

    def launch(self, name: str, ns: int, api: str = "cudaLaunchKernel"):
        a = self.tick()
        self.host.append((api, a, self.tick(2)))
        start = max(self.free, a + 5)
        self.ops.append((name, start, start + ns))
        self.free = start + ns

    def wait(self):
        """The host blocks until the device is free."""
        self.t = max(self.t, self.free) + 1

    def sync(self):
        with self.span("sync"):
            self.launch("Memcpy DtoH (Device -> Pageable)", 3,
                        "cudaMemcpyAsync")
            self.wait()

    def trace(self) -> Trace:
        window = [h for h in self.host if h[0] == "window"][0]
        return Trace(window[1], window[2], list(self.ops), list(self.host))


# --------------------------------------------------------------------- #
# the rule
# --------------------------------------------------------------------- #
def test_nesting_two_threads_and_an_unlinked_operation():
    ops = [("a", 100, 110), ("b", 110, 130), ("c", 130, 160),
           ("d", 160, 200), ("e", 200, 205)]
    launches = [(1, 12), (1, 22), (2, 15), None, (1, 45)]
    host = [("window", 0, 300, 1),
            ("repro.decode", 10, 50, 1), ("repro.attention", 20, 30, 1),
            ("repro.decode_attend", 21, 29, 1),
            ("repro.mlp", 10, 20, 2)]
    at = spans.attribute(ops, launches, host, 1, [(0, 100), (205, 300)])
    assert at.total_ns == 105 and at.linked_ns == 65
    assert at.linked == pytest.approx(65 / 105)
    # a on thread 1 in decode; b in decode/attention/decode_attend; c on
    # thread 2 in mlp; d unlinked; e in decode after attention closed
    assert at.inclusive == {"repro.decode": 10 + 20 + 5,
                            "repro.attention": 20,
                            "repro.decode_attend": 20, "repro.mlp": 30}
    assert at.self_ns == {"repro.decode": 15, "repro.decode_attend": 20,
                          "repro.mlp": 30}
    assert at.launched == {"repro.decode": 3, "repro.attention": 1,
                           "repro.decode_attend": 1, "repro.mlp": 1}
    assert at.innermost == {"repro.decode": 15, "repro.decode_attend": 20,
                            "repro.mlp": 30}
    assert at.covered == pytest.approx(65 / 105)
    # spans are counted on the main thread only
    assert at.counts["repro.decode"] == 1 and at.counts["repro.mlp"] == 0


def test_idle_time_goes_to_the_innermost_span_of_the_main_thread():
    host = [("window", 0, 100, 0), ("decode", 10, 60, 0),
            ("repro.decode", 12, 58, 0), ("repro.embed", 14, 20, 0),
            ("sync", 70, 90, 0), ("repro.mlp", 0, 100, 1)]
    at = spans.attribute([], [], host, 0, [(0, 16), (50, 80)])
    assert at.idle == {"window": 10 + 10, "decode": 2 + 2,
                       "repro.decode": 2 + 8, "repro.embed": 2, "sync": 10}
    assert at.idle_in_program_ns == 12
    assert sum(at.idle.values()) == 16 + 30


def _two_steps() -> Tape:
    tape = Tape()
    with tape.span("window"):
        with tape.span("decode"):
            tape.launch("k1", 50)
            tape.launch("k2", 5, "cuLaunchKernelEx")
            tape.launch("Memset (Device)", 2, "cudaMemsetAsync")
        tape.sync()
        with tape.span("decode"):
            tape.launch("k3", 5)
            tape.tick(100)
            tape.launch("k4", 5)
        tape.sync()
    return tape


def test_links_follow_the_stream_between_copies_and_sets():
    tr = _two_steps().trace()
    calls = sorted(a for name, a, _ in tr.host if name in spans.LAUNCHES)
    assert spans.links(tr) == [(0, a) for a in calls]
    # an operation no listed call launched leaves its stretch unlinked,
    # and the copy after it linked
    unseen = _two_steps().trace()
    k3 = unseen.ops[4]
    unseen.ops.insert(4, ("k_unseen", k3[1] - 2, k3[1] - 1))
    assert spans.links(unseen) == [(0, a) for a in calls[:4]] \
        + [None] * 3 + [(0, calls[-1])]
    # a kernel whose start reads after the set launched after it: the two
    # stretches it falls between are left unlinked, the set linked
    swapped = _two_steps().trace()
    (k2, a2, b2), (st, a3, b3) = swapped.ops[1:3]
    swapped.ops[1:3] = [(st, a2, b2), (k2, a3, b3)]
    assert spans.links(swapped) == [None, (0, calls[2]), None] \
        + [(0, a) for a in calls[3:]]
    # copies that do not pair up leave everything unlinked
    tr.ops.pop(3)
    assert spans.links(tr) == [None] * len(tr.ops)


def test_idle_is_read_from_the_launch_that_ends_it():
    tape = _two_steps()
    tr = tape.trace()
    linked = spans.links(tr)
    gaps, lost = spans.host_gaps(tr, linked)
    assert lost == 0
    # the 100 ns of host work between k3 and k4 starve the device: the gap
    # ends with k4's launch, on the host's clock
    k4 = [a for n, a, _ in tr.host if n == "cudaLaunchKernel"][-1]
    ops = sorted(tr.ops, key=lambda o: o[1])
    g = ops[5][1] - ops[4][2]
    assert (k4 - g, k4) in gaps
    # a device clock that runs behind the host's (its operations read as
    # starting before their launches) moves no gap between two of them
    skewed = dataclasses.replace(tr, ops=[(n, a - 4, b - 4)
                                          for n, a, b in tr.ops])
    got, lost = spans.host_gaps(skewed, linked)
    assert got[1:-1] == gaps[1:-1] and lost == 0
    at = spans.of_trace(skewed)
    assert at.idle["decode"] == spans.of_trace(tr).idle["decode"] > 0


def test_of_trace_covers_the_whole_window():
    tape = Tape()
    with tape.span("window"):
        for _ in range(2):
            _decode_step(tape, layers=2)
    at = spans.of_trace(tape.trace())
    assert at.linked == 1.0 and at.covered == 1.0
    assert at.counts["repro.decode"] == 2
    assert at.counts["repro.decode_attend"] == 4
    # 2 a layer, the embed and the head: 6 a step
    assert at.launched["repro.decode"] == 12


# --------------------------------------------------------------------- #
# the five readers
# --------------------------------------------------------------------- #
ATTEND_NS, LAYER_NS = 13, 7


def _decode_step(tape: Tape, layers: int):
    with tape.span("decode"):
        with tape.span("repro.decode"):
            with tape.span("repro.embed"):
                tape.launch("gather", 2)
            for _ in range(layers):
                with tape.span("repro.attention"):
                    with tape.span("repro.decode_attend"):
                        tape.launch("attend", ATTEND_NS)
                with tape.span("repro.mlp"):
                    tape.tick(40)       # host work while the device idles
                    tape.launch("mlp", LAYER_NS)
            with tape.span("repro.head"):
                tape.launch("head", 3)
    with tape.span("argmax"):
        tape.launch("argmax_kernel", 1)
    tape.sync()


def _run(cfg: dict, kind: str, tape: Tape, prefills=(), steps=()):
    name = {"decode": "minitron-4b.decode",
            "prefill": "minitron-4b.prefill-long"}[kind]
    c = dataclasses.replace(harness.cell(name), cfg=cfg)
    return harness.Run(c, setup_s=1.0, window_s=1.0, prefills=list(prefills),
                       steps=list(steps), ttft_s=[1.0], tokens=1, requests=1,
                       peak_bytes=1, trace=tape.trace())


def _decode_run(program: bool = True):
    tape = Tape(program)
    with tape.span("window"):
        for _ in range(3):
            _decode_step(tape, TINY_DENSE["n_layers"])
    steps = [harness.Step(4, 100 + i, 0.1, 0.05) for i in range(3)]
    return _run(TINY_DENSE, "decode", tape, steps=steps)


def test_decode_attention_roofline():
    r = _decode_run()
    # B 4, 100-102 valid positions, 2 q heads over 1 kv head of D 4: the
    # bytes bound it (bf16 K and V of the valid positions, q and o)
    least = sum(2 * (2 * 4 * v * 1 * 4 + 2 * 4 * 2 * 4) / PEAK_BYTES
                for v in (100, 101, 102))
    assert 4 * 4 * 2 * 4 * 102 / PEAK_BF16_FLOPS < least / 3
    want = 100 * 2 * least / (3 * 2 * ATTEND_NS * 1e-9)
    assert run._reader("decode_attention_roofline")(r) == pytest.approx(want)


def test_decode_launches_per_step_and_idle_in_program():
    r = _decode_run()
    assert run._reader("decode.launches_per_step")(r) == 6
    tr, at = r.trace, spans.of(r.trace)
    idle = run._reader("idle_in_program.decode")(r)
    assert idle == pytest.approx(100 * at.idle_in_program_ns
                                 / (tr.end_ns - tr.start_ns))
    # the 40 ns of host work a layer, inside repro.mlp, leave the device
    # idle: 2 layers, 3 steps
    assert at.idle["repro.mlp"] >= 3 * 2 * 30
    assert 0 < idle < run._reader("idle_share.decode")(r)


def test_launches_per_step_counts_the_host_s_calls_without_links():
    """A CUDA graph's replay is one call, however many operations it
    runs, and the count needs no device operation linked to its call."""
    tape = Tape()
    with tape.span("window"):
        for _ in range(2):
            with tape.span("decode"):
                with tape.span("repro.decode"):
                    tape.launch("embed", 2)
                    tape.launch("graph_kernel", 50, "cudaGraphLaunch")
                    for name in ("layer_0", "layer_1", "head"):
                        tape.ops.append((name, tape.free, tape.free + 5))
                        tape.free += 5
            tape.sync()
    r = _run(TINY_DENSE, "decode", tape)
    assert spans.linked(r.trace) is None
    assert spans.calls_under(r.trace, "repro.decode") == (4, 2)
    assert run._reader("decode.launches_per_step")(r) == 2


def _prefill(tape: Tape, cfg: dict):
    with tape.span("serve"):
        with tape.span("repro.prefill"):
            for i in range(cfg["n_layers"]):
                if cfg["family"] == "hybrid":
                    with tape.span("repro.rms_norm"):
                        tape.launch("norm", 5)
                    with tape.span("repro.mamba2"):
                        tape.launch("w_in", 20)
                        with tape.span("repro.scan"):
                            tape.launch("ssd_scan_bf16", 30)
                        with tape.span("repro.rms_norm"):
                            tape.launch("norm", 5)
                        tape.launch("w_out", 10)
                else:
                    for block in ("repro.attention", "repro.mlp"):
                        with tape.span("repro.rms_norm"):
                            tape.launch("norm", 5)
                        with tape.span(block):
                            tape.launch("gemm", 20)
            with tape.span("repro.head"):
                with tape.span("repro.rms_norm"):
                    tape.launch("norm", 5)
                tape.launch("head", 4)
    tape.sync()


def _prefill_run(cfg: dict, program: bool = True):
    tape = Tape(program)
    with tape.span("window"):
        for _ in range(2):
            _prefill(tape, cfg)
    prefills = [harness.Prefill(2, 8, 0.5), harness.Prefill(1, 16, 0.5)]
    return _run(cfg, "prefill", tape, prefills=prefills)


def test_mamba2_mixer_roofline():
    cfg = TINY_HYBRID
    r = _prefill_run(cfg)
    # d 4, di 8, N 2, P 2, H 4, K 4, C 12; w_in is 4 x 24
    weights = 4 * 24 + 8 * 4 + 4 * 12 + 12 + 3 * 4 + 8
    least = 0.0
    for B, S in ((2, 8), (1, 16)):
        n_bytes = 2 * (weights + 2 * B * S * 4) + 4 * B * 4 * 2 * 2 \
            + 2 * B * 3 * 12
        least += n_bytes / PEAK_BYTES
    # the mixer's own operations take less than its bytes
    want = 100 * 2 * least / (2 * 2 * (20 + 30 + 5 + 10) * 1e-9)
    assert run._reader("mamba2_mixer_roofline")(r) == pytest.approx(want)


def test_rms_norm_roofline():
    cfg = TINY_DENSE
    r = _prefill_run(cfg)
    least = sum((2 * 2 * 2 * (2 * B * S * 8 + 8) + 2 * (2 * B * 8 + 8))
                / PEAK_BYTES for B, S in ((2, 8), (1, 16)))
    want = 100 * least / (2 * 5 * 5 * 1e-9)
    assert run._reader("rms_norm_roofline")(r) == pytest.approx(want)


NEW = ("decode_attention_roofline", "decode.launches_per_step",
       "idle_in_program.decode", "mamba2_mixer_roofline",
       "rms_norm_roofline")


@pytest.mark.parametrize("name", NEW)
def test_the_new_readers_read_nothing_without_the_spans(name):
    for r in (_decode_run(program=False),
              _prefill_run(TINY_HYBRID, program=False),
              _prefill_run(TINY_DENSE, program=False)):
        assert run._reader(name)(r) is None


def test_a_count_that_is_not_one_a_layer_reads_nothing():
    r = _decode_run()
    r.steps.pop()
    assert run._reader("decode_attention_roofline")(r) is None
    r = _prefill_run(TINY_DENSE)
    r.prefills.pop()
    assert run._reader("rms_norm_roofline")(r) is None
    r = _prefill_run(TINY_HYBRID)
    r.prefills.pop()
    assert run._reader("mamba2_mixer_roofline")(r) is None


# --------------------------------------------------------------------- #
# the program's spans leave the accepted metrics as they were
# --------------------------------------------------------------------- #
class _Event:
    """A kineto event as ``bench.trace.read`` reads it."""

    def __init__(self, name, start, end, device, annotation=False):
        self._v = (name, start, end, device, annotation)

    def name(self):
        return self._v[0]

    def start_ns(self):
        return self._v[1]

    def duration_ns(self):
        return self._v[2] - self._v[1]

    def device_type(self):
        return self._v[3]

    def is_user_annotation(self):
        return self._v[4]


class _Prof:
    def __init__(self, events):
        results = type("R", (), {"events": lambda _self: events})()
        self.profiler = type("P", (), {"kineto_results": results})()


def _events(tape: Tape) -> list:
    """The tape as the profiler gives it: each host event on the CPU, a
    user annotation where it is a span, each span also as a device-side
    annotation over the operations launched under it, and the
    operations."""
    from torch.autograd import DeviceType
    out = [_Event(n, a, b, DeviceType.CPU, spans.is_span(n))
           for n, a, b in tape.host]
    links = spans.links(tape.trace())
    for n, a, b in tape.host:
        if spans.is_span(n):
            under = [o for o, link in zip(tape.ops, links)
                     if link is not None and a <= link[1] < b]
            if under:
                out.append(_Event(n, under[0][1], under[-1][2],
                                  DeviceType.CUDA, True))
    out += [_Event(n, a, b, DeviceType.CUDA) for n, a, b in tape.ops]
    return out


ACCEPTED = ("plain_ops_share.decode", "plain_ops_share.prefill",
            "idle_share.decode", "idle_share.prefill", "ssd_scan_roofline",
            "flash_attention_roofline", "mfu.decode", "mfu.prefill",
            "decode.enqueue_ms", "peak_mem_gib")


@pytest.mark.parametrize("which", ["decode", "hybrid", "dense"])
def test_accepted_readers_read_the_same_with_the_program_s_spans(which):
    def made(program):
        return {"decode": _decode_run, "hybrid":
                lambda program: _prefill_run(TINY_HYBRID, program),
                "dense": lambda program: _prefill_run(TINY_DENSE, program)
                }[which](program)
    with_spans, without = made(True), made(True)
    tape = _tape_of(with_spans)
    with_spans.trace = read(_Prof(_events(tape)))
    assert with_spans.trace.ops == tape.ops
    assert any(n.startswith(spans.PREFIX) for n, _, _ in
               with_spans.trace.host)
    tape.host = [h for h in tape.host if not h[0].startswith(spans.PREFIX)]
    without.trace = read(_Prof(_events(tape)))
    for name in ACCEPTED:
        assert run._reader(name)(with_spans) == \
            run._reader(name)(without), name


def _tape_of(r) -> Tape:
    tape = Tape()
    tape.host, tape.ops = list(r.trace.host), list(r.trace.ops)
    return tape


def test_program_span_names_are_none_of_the_benchmark_s():
    src = Path(harness.ROOT / "src" / "repro_torch")
    pat = re.compile(r"""\bspan\(\s*["']([^"']+)["']""")
    names = {m for p in src.rglob("*.py") for m in pat.findall(p.read_text())}
    assert len(names) >= 15
    for n in names:
        assert n.startswith(spans.PREFIX) and n not in SPANS, n
        assert not (kernel_names.is_flash_attention(n)
                    or kernel_names.is_ssd_scan(n)
                    or kernel_names.is_plain(n)), n
