"""Device time and idle time of a traced run put down to the program's
spans.

The port opens spans named ``repro.*`` at its layer boundaries
(``repro_torch.trace``) while a profiler records; in a traced run they are
host events of the trace, beside the benchmark's own spans
(``bench.trace.SPANS``), the runtime's calls and PyTorch's operators.

**The rule.**  A device operation belongs to every ``repro.*`` span open
on the launching thread when the runtime call that launched it began:
each span name gets the operation's time once (its inclusive time), and
the innermost such span gets it as self time.  An operation with no link
to a launch is unattributed and counted so, never guessed.  Idle time is
put down by the main thread (the thread of the ``window`` span): each
part of a gap in the device's work goes to the innermost span, the
program's or the benchmark's, open on that thread during that part.

**The links** (``of_trace``), a stand-in for the profiler's correlation
ids.  ``bench.trace.Trace`` keeps each event's name and interval, not its
correlation id or thread, so a device operation is linked to its launch
by the stream's order: the benchmark launches everything from one thread
onto one stream, which runs operations in the order they were launched.
The k-th launch call (``LAUNCHES``) launched the k-th operation, checked
stretch by stretch: copies and sets anchor the two sequences (the k-th
copy call is the k-th copy, the k-th set call the k-th set), and between
two anchors the kernel calls and the operations have to be as many and
all kernels; a stretch that is not is left unlinked.  Times are not
compared across the two clocks: the device's, as the trace gives it,
drifts from the host's.  Held against the correlation ids on one H100,
one window a cell: minitron-4b decode 494,592 pairs agreed, none wrong,
none unlinked; zamba2-7b prefill 127,935 agreed, 10 wrong, none
unlinked; long minitron-4b prefill 165,093 agreed, 23 wrong, 32 unlinked.
A wrong pair is not seen here: its time lands in the wrong span
silently, and only an unlinked one counts against ``MIN_LINKED``.  A
cell that launches on a second stream or replays a CUDA graph breaks the
order's premise, so its device time by span is not to be trusted.

TEMPORARY: ``links``, ``host_gaps``, ``_kind`` and ``of_trace``'s use of
them go once ``bench.trace.read`` keeps each device operation's
correlation id and each host event's thread and correlation id (a
benchmark change); ``attribute`` then takes the ids' links as they are
and the gaps by the host's clock of each launch.

    python3 bench/spans.py --workload <cell> --seed <n> --seconds <s>

runs a traced cell and prints the tables of this module as JSON.
"""
from __future__ import annotations

import bisect
import dataclasses
import sys
from collections import Counter, defaultdict
from pathlib import Path

if __package__ in (None, ""):
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from bench.trace import SPANS, WINDOW  # noqa: E402

PREFIX = "repro."
# where the idle time that no link puts on the host's clock goes
UNLINKED = "unlinked"
# the share of the device time a reader of device time under the spans
# needs linked to launches
MIN_LINKED = 0.99
# CUDA calls (the runtime's cuda*, the lower-level cu*) that enqueue one
# device operation each
LAUNCHES = frozenset({
    "cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
    "cuLaunchKernelEx", "cudaMemcpyAsync", "cudaMemsetAsync", "cudaMemcpy",
    "cudaMemset"})


# the host's calls that hand the device work: one of ``LAUNCHES`` enqueues
# one operation, a CUDA graph's replay enqueues the graph
CALLS = LAUNCHES | {"cudaGraphLaunch", "cuGraphLaunch"}


@dataclasses.dataclass
class Attribution:
    """Device nanoseconds and counts by span name; ``repro.*`` names only
    where the field says so."""
    total_ns: int = 0                   # every device operation's time
    linked_ns: int = 0                  # of it, operations tied to a launch
    inclusive: Counter = dataclasses.field(default_factory=Counter)
    self_ns: Counter = dataclasses.field(default_factory=Counter)
    launched: Counter = dataclasses.field(default_factory=Counter)
    # the innermost span of either kind over each linked operation
    # (``window`` where no other is open)
    innermost: Counter = dataclasses.field(default_factory=Counter)
    counts: Counter = dataclasses.field(default_factory=Counter)
    idle: Counter = dataclasses.field(default_factory=Counter)

    @property
    def linked(self) -> float:
        return self.linked_ns / self.total_ns if self.total_ns else 0.0

    @property
    def covered(self) -> float:
        """Share of the device time under a ``repro.*`` span or one of the
        benchmark's other than ``window``."""
        out = sum(ns for name, ns in self.innermost.items() if name != WINDOW)
        return out / self.total_ns if self.total_ns else 0.0

    @property
    def idle_in_program_ns(self) -> int:
        return sum(ns for name, ns in self.idle.items()
                   if name.startswith(PREFIX))

    def seconds(self, name: str) -> float:
        return self.inclusive[name] * 1e-9


def is_span(name: str) -> bool:
    return name.startswith(PREFIX) or name in SPANS


def _stacks(spans: list, times: list) -> list[tuple]:
    """For each of the sorted ``times``, the names of the ``spans``
    ((name, start, end), sorted by start, nested as calls nest) open at it,
    outermost first."""
    out, stack, names, i = [], [], (), 0
    for t in times:
        changed = False
        while i < len(spans) and spans[i][1] <= t:
            name, a, b = spans[i]
            while stack and stack[-1][0] <= a:
                stack.pop()
            stack.append((b, name))
            i += 1
            changed = True
        while stack and stack[-1][0] <= t:
            stack.pop()
            changed = True
        if changed:
            names = tuple(n for _, n in stack)
        out.append(names)
    return out


def attribute(ops: list, launches: list, spans: list, main,
              gaps: list) -> Attribution:
    """The rule above.  ``ops``: device (name, start, end); ``launches``:
    for each operation its launch call's (thread, start), or None;
    ``spans``: host (name, start, end, thread); ``main``: the main
    thread; ``gaps``: the device's idle (start, end) intervals on the
    host's clock."""
    at = Attribution()
    by_thread = defaultdict(list)
    for name, a, b, thread in sorted(spans, key=lambda s: (s[1], -s[2])):
        by_thread[thread].append((name, a, b))
    at.counts.update(name for name, _, _ in by_thread.get(main, []))
    todo = defaultdict(list)
    for (_, a, b), link in zip(ops, launches):
        at.total_ns += b - a
        if link is not None:
            todo[link[0]].append((link[1], b - a))
    under_ns, under_n = Counter(), Counter()     # by the stack open
    for thread, items in todo.items():
        items.sort()
        stacks = _stacks(by_thread.get(thread, []), [t for t, _ in items])
        for (_, ns), stack in zip(items, stacks):
            under_ns[stack] += ns
            under_n[stack] += 1
    for stack, ns in under_ns.items():
        at.linked_ns += ns
        at.innermost[stack[-1] if stack else WINDOW] += ns
        mine = [n for n in stack if n.startswith(PREFIX)]
        if mine:
            at.self_ns[mine[-1]] += ns
            for name in set(mine):
                at.inclusive[name] += ns
                at.launched[name] += under_n[stack]
    _put_down_idle(at, by_thread.get(main, []), gaps)
    return at


def _put_down_idle(at: Attribution, spans: list, gaps: list) -> None:
    """Each gap's parts to the innermost span open on the main thread."""
    edges = sorted({t for _, a, b in spans for t in (a, b)})
    inner = [s[-1] if s else WINDOW for s in _stacks(spans, edges)]
    for a, b in gaps:
        k = bisect.bisect_right(edges, a) - 1   # the last edge at or before
        t = a
        while t < b:
            end = min(b, edges[k + 1]) if k + 1 < len(edges) else b
            at.idle[inner[k] if k >= 0 else WINDOW] += end - t
            t, k = end, k + 1


def calls_under(tr, name: str) -> tuple[int, int]:
    """(the host's ``CALLS`` that began inside a ``name`` span, the number
    of ``name`` spans) of a trace; read from the host alone, no links."""
    spans = sorted((a, b) for n, a, b in tr.host if n == name)
    starts = [a for a, _ in spans]
    n = 0
    for call, a, _ in tr.host:
        if call in CALLS:
            k = bisect.bisect_right(starts, a) - 1
            n += k >= 0 and a < spans[k][1]
    return n, len(spans)


def _kind(name: str, call: bool) -> str:
    """A launch call's or a device operation's kind: a copy, a set or a
    kernel."""
    if name.startswith("cudaMemcpy" if call else "Memcpy"):
        return "copy"
    if name.startswith("cudaMemset" if call else "Memset"):
        return "set"
    return "kernel"


def links(tr) -> list:
    """Each operation of ``tr.ops``'s launch call as (thread 0, its start),
    by the stream's order; None where a stretch does not pair up.

    Copies and sets anchor the two sequences: the k-th copy call launched
    the k-th copy, the k-th set call the k-th set.  Between two anchors
    next to each other in launch order, the kernel calls and the
    operations between the two anchors' operations pair in order where
    they are as many and all kernels."""
    calls = sorted((a, _kind(name, True)) for name, a, _ in tr.host
                   if name in LAUNCHES)
    order = sorted(range(len(tr.ops)), key=lambda i: tr.ops[i][1])
    kinds = [_kind(tr.ops[i][0], False) for i in order]
    out = [None] * len(tr.ops)
    anchors = [(-1, -1)]
    for kind in ("copy", "set"):
        cs = [j for j, (_, k) in enumerate(calls) if k == kind]
        os_ = [j for j, k in enumerate(kinds) if k == kind]
        if len(cs) != len(os_):
            return out
        anchors += zip(cs, os_)
    anchors.sort()
    anchors.append((len(calls), len(order)))
    for (c0, o0), (c1, o1) in zip(anchors, anchors[1:]):
        if c1 < len(calls):
            out[order[o1]] = (0, calls[c1][0])
        ops = range(o0 + 1, o1)
        if c1 - c0 == o1 - o0 and all(kinds[j] == "kernel" for j in ops):
            for (start, _), j in zip(calls[c0 + 1:c1], ops):
                out[order[j]] = (0, start)
    return out


def host_gaps(tr, linked: list) -> tuple[list, int]:
    """The window's intervals with no device operation running, on the
    host's clock, and the idle nanoseconds that could not be put there.

    The device's clock as the trace gives it drifts from the host's (by
    ~0.3 ms a second on the card), so a gap is read from the launch that
    ends it: a gap ends when the operation after it is launched, so it is
    the stretch of host time of the same length that ends at that launch
    (the launch's own latency, microseconds, left out).  The gap after the
    last operation ends with the window."""
    first = {}
    for (_, a, _), link in zip(tr.ops, linked):
        first.setdefault(a, link)
    edges = [tr.start_ns]
    for a, b in tr.busy_intervals():
        edges += [a, b]
    edges.append(tr.end_ns)
    out, lost = [], 0
    for a, b in zip(edges[::2], edges[1::2]):
        if b <= a:
            continue
        if b == tr.end_ns:
            out.append((a, b))
        elif first.get(b) is not None:
            end = first[b][1]
            out.append((end - (b - a), end))
        else:
            lost += b - a
    return out, lost


def of_trace(tr) -> Attribution:
    """``attribute`` over a ``bench.trace.Trace``: every host span read as
    the main thread's (the trace keeps no thread), linked by ``links``,
    the idle gaps by ``host_gaps``."""
    linked = links(tr)
    gaps, lost = host_gaps(tr, linked)
    spans = [(name, a, b, 0) for name, a, b in tr.host if is_span(name)]
    at = attribute(tr.ops, linked, spans, 0, gaps)
    at.idle[UNLINKED] += lost
    return at


# the last trace and its attribution: a run's readers are called one after
# another on one trace, and share it (goes with the order's links, whose
# pass over a window takes most of a traced run's reading time)
_LAST: list = []


def of(tr) -> Attribution | None:
    """``of_trace`` once a trace (the readers of one run share it); None
    for no trace."""
    if tr is None:
        return None
    if not (_LAST and _LAST[0] is tr):
        _LAST[:] = [tr, of_trace(tr)]
    return _LAST[1]


def linked(tr) -> Attribution | None:
    """``of(tr)`` where at least ``MIN_LINKED`` of its device time is
    linked to launches, else None."""
    at = of(tr)
    return at if at is not None and at.linked >= MIN_LINKED else None


def tables(at: Attribution, window_s: float) -> dict:
    """The attribution as the tables ``PERF.md`` keeps: device seconds by
    span (inclusive, self, operations launched), by the innermost span of
    either kind, idle seconds by host span, and the shares linked and
    covered."""
    def secs(c: Counter) -> dict:
        return {k: v * 1e-9 for k, v in c.most_common()}
    return {"window_s": window_s, "device_s": at.total_ns * 1e-9,
            "linked": at.linked, "covered": at.covered,
            "inclusive_s": secs(at.inclusive), "self_s": secs(at.self_ns),
            "launched": dict(at.launched.most_common()),
            "innermost_s": secs(at.innermost), "idle_s": secs(at.idle),
            "counts": dict(at.counts.most_common())}


def main(argv=None) -> int:
    import argparse
    import json
    import time

    t_start = time.perf_counter()
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    from bench import run
    run._environment()
    import torch

    from bench import harness
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    r = harness.run_cell(harness.cell(args.workload), args.seed,
                         args.seconds, True, torch.device("cuda", 0),
                         t_start)
    if r.trace is None:
        print("the profiler saw no device operation", file=sys.stderr)
        return 3
    print(json.dumps(tables(of(r.trace), r.trace.window_s)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
