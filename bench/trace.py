"""The device trace of a traced run, from ``torch.profiler``'s raw events.

``read(prof)`` keeps the device's operations (kernels, copies,
sets) and the host's spans inside the benchmark's ``window`` span.  Busy
time is the union of the device operations' intervals, so streams that
overlap count once; the idle gaps are what is left of the window, each
labelled by the benchmark's span and the innermost host operation running
where the gap starts.
"""
from __future__ import annotations

import dataclasses

# the benchmark's own spans (``torch.profiler.record_function``)
WINDOW = "window"
SPANS = (WINDOW, "serve", "sync", "client", "decode", "argmax",
         "init_cache", "prefill")
TOP = 10


@dataclasses.dataclass
class Trace:
    start_ns: int
    end_ns: int
    ops: list[tuple[str, int, int]]         # device (name, start, end) ns
    host: list[tuple[str, int, int]]        # host (name, start, end) ns

    @property
    def window_s(self) -> float:
        return (self.end_ns - self.start_ns) * 1e-9

    def busy_intervals(self) -> list[tuple[int, int]]:
        merged: list[list[int]] = []
        for _, a, b in sorted(self.ops, key=lambda o: o[1]):
            a, b = max(a, self.start_ns), min(b, self.end_ns)
            if b <= a:
                continue
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        return [(a, b) for a, b in merged]

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) * 1e-9

    def op_seconds(self, match) -> float:
        """Device seconds of the operations whose name ``match`` accepts."""
        return sum(b - a for n, a, b in self.ops if match(n)) * 1e-9

    def op_count(self, match) -> int:
        return sum(1 for n, _, _ in self.ops if match(n))

    def top_ops(self, n: int = TOP) -> list[list]:
        total: dict[str, int] = {}
        for name, a, b in self.ops:
            total[name] = total.get(name, 0) + b - a
        ranked = sorted(total.items(), key=lambda kv: -kv[1])[:n]
        return [[name, ns * 1e-9] for name, ns in ranked]

    def idle_gaps(self, n: int = TOP) -> list[list]:
        edges = [self.start_ns]
        for a, b in self.busy_intervals():
            edges += [a, b]
        edges.append(self.end_ns)
        gaps = sorted(((edges[i + 1] - edges[i], edges[i])
                       for i in range(0, len(edges), 2)
                       if edges[i + 1] > edges[i]), reverse=True)[:n]
        return [[self.label(at), ns * 1e-9] for ns, at in gaps]

    def label(self, at: int) -> str:
        """The benchmark's innermost span and the innermost other host
        operation running at ``at``."""
        span, op = None, None
        for name, a, b in self.host:
            if a <= at < b:
                if name in SPANS and name != WINDOW:
                    if span is None or a >= span[1]:
                        span = (name, a)
                elif name not in SPANS and (op is None or a >= op[1]):
                    op = (name, a)
        parts = [span[0] if span else "window"] + ([op[0]] if op else [])
        return "/".join(parts)


def _ns(event, what: str) -> int:
    fn = getattr(event, f"{what}_ns", None)
    if fn is not None:
        return int(fn())
    return int(getattr(event, f"{what}_us")() * 1000)


def read(prof) -> Trace | None:
    """The trace inside the ``window`` span, or None where the profiler
    saw no device operation."""
    from torch.autograd import DeviceType
    events = prof.profiler.kineto_results.events()
    ops, host, window = [], [], None
    for e in events:
        name = e.name()
        start = _ns(e, "start")
        end = start + _ns(e, "duration")
        if e.device_type() == DeviceType.CPU:
            if name == WINDOW:
                window = (start, end)
            host.append((name, start, end))
        elif not (e.is_user_annotation() or name in SPANS
                  or name.startswith("Command Buffer")):
            ops.append((name, start, end))
    if window is None or not ops:
        return None
    a, b = window
    return Trace(a, b, [o for o in ops if o[2] > a and o[1] < b],
                 [h for h in host if h[2] > a and h[1] < b])
