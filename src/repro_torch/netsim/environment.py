"""Throughput law for application-level transfer tuning.

Models the classic GridFTP parameter response documented across the paper's
reference set [9, 48-54]:

  * parallelism ``p`` opens more TCP streams per file -> each stream is limited
    by ``buffer/rtt``; aggregate is capped by the (load-reduced) link bandwidth;
  * concurrency ``cc`` opens more server processes -> hides per-file latency,
    adds server-side scheduling gain (the paper's cc=8,p=2 > cc=4,p=4 example),
    but burns end-system cores;
  * pipelining ``pp`` amortizes the per-file control-channel round trip, which
    dominates for small files on high-RTT paths;
  * too many total streams trip congestion (queueing + loss) -> interior maxima;
  * disk read/write caps bound everything (Assumption 3).

All quantities are Mbit/s and seconds.  The law is deterministic given
(params, load, seed); measurement noise is Gaussian per Sec. 3.1.1 of the paper.
"""
from __future__ import annotations

import dataclasses
import heapq
import math
import threading

import numpy as np


@dataclasses.dataclass(frozen=True)
class TransferParams:
    cc: int  # concurrency: parallel server processes (files in flight)
    p: int   # parallelism: TCP streams per file
    pp: int  # pipelining: command pipelining depth

    def clip(self, bounds: "ParamBounds") -> "TransferParams":
        return TransferParams(
            cc=int(min(max(self.cc, 1), bounds.max_cc)),
            p=int(min(max(self.p, 1), bounds.max_p)),
            pp=int(min(max(self.pp, 1), bounds.max_pp)),
        )

    def as_tuple(self) -> tuple[int, int, int]:
        return (self.cc, self.p, self.pp)


@dataclasses.dataclass(frozen=True)
class TransferResult:
    """Outcome of one (chunk) transfer.

    ``steady_mbps`` is the rate a monitoring loop would report once past the
    setup/slow-start ramp — this is what tuners compare against model
    predictions.  ``effective_mbps`` divides megabits moved by total elapsed
    time including setup, i.e. what the end user experiences.
    """
    effective_mbps: float
    steady_mbps: float
    elapsed_s: float


@dataclasses.dataclass(frozen=True)
class ParamBounds:
    """Bounded integer domain Psi = {1..beta} per Sec. 3.1.2."""
    max_cc: int = 16
    max_p: int = 16
    max_pp: int = 16

    def grid(self) -> list[TransferParams]:
        return [
            TransferParams(cc, p, pp)
            for cc in range(1, self.max_cc + 1)
            for p in range(1, self.max_p + 1)
            for pp in range(1, self.max_pp + 1)
        ]


@dataclasses.dataclass(frozen=True)
class LinkSpec:
    """Static characteristics of an end-to-end path (Table 1)."""
    name: str
    bandwidth_mbps: float          # link capacity
    rtt_s: float                   # round-trip time
    tcp_buffer_mb: float           # socket buffer per stream
    disk_read_mbps: float          # source storage cap
    disk_write_mbps: float         # destination storage cap
    cores: int = 8                 # end-system cores (cc beyond this thrashes)
    congestion_knee: float = 0.85  # utilization where queueing starts to bite
    loss_sensitivity: float = 2.0  # how hard over-subscription hurts
    streams_to_saturate: int = 16  # Mathis-law loss cap: streams needed to fill
                                   # the pipe (single TCP stream on a lossy WAN
                                   # never reaches buffer/RTT)


class Environment:
    """A simulated end-to-end transfer path with background traffic.

    The single entry point tuners may use is :meth:`transfer`, which performs a
    (sample or bulk) transfer of ``size_mb`` from a dataset with the given
    average file size and returns achieved throughput.  ``peek_load`` exists
    only for oracle/ground-truth computation in benchmarks, never for tuners.
    """

    def __init__(self, link: LinkSpec, traffic, *, noise_sigma: float = 0.03,
                 seed: int = 0, faults=None):
        self.link = link
        self.traffic = traffic          # DiurnalTraffic: time -> load in [0,1)
        self.noise_sigma = noise_sigma
        self._rng = np.random.default_rng(seed)
        self.clock_s: float = 0.0       # simulation wall-clock
        self.sample_count: int = 0      # number of probe transfers issued
        self._live_params: tuple[int, int, int] | None = None  # open sessions
        self.faults = faults            # netsim.faults.FaultSchedule | None
        self.tenant_id: int | None = None  # set by TenantEnvironment

    # ------------------------------------------------------------------ #
    # ground-truth throughput law
    # ------------------------------------------------------------------ #
    def mean_throughput(self, params: TransferParams, avg_file_mb: float,
                        n_files: int, ext_load: float,
                        contending_mbps: float = 0.0,
                        n_contending: int = 0,
                        link: LinkSpec | None = None) -> float:
        """Noise-free expected throughput (Mbit/s) for a parameter choice.

        ``link`` overrides the environment's static LinkSpec — the fault
        path evaluates the law under a fault-perturbed spec per segment;
        every fault-free caller leaves it ``None``.
        """
        if link is None:
            link = self.link
        cc, p, pp = params.cc, params.p, params.pp
        streams = cc * p

        # Per-stream steady-state TCP rate: the lesser of the window limit
        # (buffer/RTT) and the Mathis loss-rate cap, expressed as the number of
        # streams a lossy path needs to fill the pipe.
        window_cap = (link.tcp_buffer_mb * 8.0) / max(link.rtt_s, 1e-6)
        loss_cap = link.bandwidth_mbps / link.streams_to_saturate
        per_stream = min(window_cap, loss_cap)

        # Available capacity after diurnal external load and logged contenders.
        # TCP fair share puts a floor under the subtraction: with k active
        # contending flows, this flow still gets ~1/(k+1) of the post-load
        # capacity no matter how aggressively the others are pushing.
        post_load = link.bandwidth_mbps * (1.0 - ext_load)
        avail = post_load - contending_mbps
        if n_contending > 0:
            avail = max(avail, post_load / (1.0 + n_contending))
        avail = max(avail, 0.05 * link.bandwidth_mbps)

        # Server-process scheduling gain: a single GridFTP process cannot keep
        # all its streams busy; more processes push harder (the paper's
        # cc=8,p=2 > cc=4,p=4 example), saturating near 1.3x and degrading
        # once cc exceeds the end-system cores.
        cpu_factor = min((cc / (cc + 1.5)) * 1.55, 1.30)
        if cc > link.cores:
            cpu_factor /= 1.0 + 0.25 * (cc - link.cores)

        agg = min(streams * per_stream * cpu_factor, avail)

        # Congestion: stream demand past the knee causes loss + queueing
        # delay (raw window demand, regardless of how well the server feeds
        # it).  Smooth, gentle decline so the surface has an interior maximum.
        over = (streams * per_stream) / max(avail * link.congestion_knee, 1e-6)
        if over > 1.0:
            agg /= 1.0 + 0.12 * link.loss_sensitivity * (over - 1.0)

        # Per-file control-channel overhead, amortized by pipelining: each file
        # costs one control RTT unless pipelined; cc processes hide it further.
        rate = max(agg, 1e-3)
        xfer_time = (avg_file_mb * 8.0) / rate          # seconds per file
        eff_pp = min(pp, max(n_files // max(cc, 1), 1))
        overhead = link.rtt_s / (eff_pp * max(1.0, 0.8 * cc))
        efficiency = xfer_time / (xfer_time + overhead)
        agg *= efficiency

        # Storage bounds (Assumption 3).
        return float(min(agg, link.disk_read_mbps, link.disk_write_mbps))

    def optimal(self, bounds: ParamBounds, avg_file_mb: float, n_files: int,
                ext_load: float | None = None) -> tuple[TransferParams, float]:
        """Grid-exact optimum at current load; benchmark ground truth only."""
        load = self.current_load() if ext_load is None else ext_load
        best, best_th = None, -1.0
        for prm in bounds.grid():
            th = self.mean_throughput(prm, avg_file_mb, n_files, load)
            if th > best_th:
                best, best_th = prm, th
        return best, best_th

    # ------------------------------------------------------------------ #
    # dynamic state
    # ------------------------------------------------------------------ #
    def current_load(self) -> float:
        return float(self.traffic.load_at(self.clock_s))

    def peek_load(self) -> float:  # benchmarks only; tuners must not call
        return self.current_load()

    def advance(self, seconds: float) -> None:
        self.clock_s += float(seconds)

    def _setup_cost_s(self, params: TransferParams) -> float:
        """Process spawn + TCP slow-start ramp charged on a parameter
        change, and the live-session bookkeeping that goes with it.  The
        single definition both the fault-free and the faulted transfer
        paths charge — keeping them arithmetically identical is what the
        empty-schedule parity test relies on."""
        if self._live_params == params.as_tuple():
            return 0.0
        setup_s = 0.15 + 0.04 * params.cc + 0.01 * params.cc * params.p
        setup_s += min(4.0 * self.link.rtt_s
                       * math.log2(1 + params.cc * params.p), 2.0)
        self._live_params = params.as_tuple()
        return setup_s

    # ------------------------------------------------------------------ #
    # contention hooks (overridden by TenantEnvironment for shared links)
    # ------------------------------------------------------------------ #
    def _contention(self) -> tuple[float, int]:
        """(aggregate contending rate Mbit/s, number of contending flows)."""
        return 0.0, 0

    def _register_flow(self, rate_mbps: float, end_s: float) -> None:
        """Publish this transfer's rate so concurrent flows can see it."""

    # ------------------------------------------------------------------ #
    # tuner-facing API
    # ------------------------------------------------------------------ #
    def transfer(self, params: TransferParams, size_mb: float,
                 avg_file_mb: float, n_files: int, *,
                 is_sample: bool = False) -> TransferResult:
        """Run a transfer of ``size_mb`` with the given parameters.

        Parameter *changes* are expensive (process spawn + TCP slow start), so
        a setup penalty proportional to cc is charged whenever ``params``
        differ from the currently open sessions — mirroring the paper's
        Section 3.2 discussion.  Re-using live sessions is free.  The achieved
        rate carries Gaussian measurement noise (Sec. 3.1.1).

        With a ``FaultSchedule`` attached the call routes to the piecewise
        fault path; ``faults=None`` (the default) keeps this fast path
        byte-for-byte identical to the fault-free simulator.
        """
        if self.faults is not None:
            return self._transfer_faulted(params, size_mb, avg_file_mb,
                                          n_files, is_sample=is_sample)
        load = self.current_load()
        contending, n_active = self._contention()
        mean = self.mean_throughput(params, avg_file_mb, n_files, load,
                                    contending_mbps=contending,
                                    n_contending=n_active)
        noisy = mean * float(1.0 + self._rng.normal(0.0, self.noise_sigma))
        noisy = max(noisy, 0.01 * mean)

        # Setup cost: process spawn + slow-start ramp, only on param change.
        setup_s = self._setup_cost_s(params)
        steady_s = (size_mb * 8.0) / max(noisy, 1e-3)
        elapsed = setup_s + steady_s
        effective = (size_mb * 8.0) / elapsed

        self._register_flow(float(noisy), self.clock_s + elapsed)
        self.advance(elapsed)
        if is_sample:
            self.sample_count += 1
        return TransferResult(float(effective), float(noisy), float(elapsed))

    def _transfer_faulted(self, params: TransferParams, size_mb: float,
                          avg_file_mb: float, n_files: int, *,
                          is_sample: bool) -> TransferResult:
        """Piecewise transfer under an attached ``FaultSchedule``.

        Load, contention, and the single Gaussian noise draw are resolved
        once at chunk start (the same quasi-static discipline ``SharedLink``
        documents); only the *fault* state varies within the chunk.  The
        chunk is integrated segment-by-segment across fault boundaries, so a
        mid-chunk flap stalls progress for its duration and a capacity
        restore resumes it — the reported steady rate is the time-weighted
        average the monitoring loop would see.  A matching ``TenantKill``
        inside the chunk truncates it at the kill instant: the flow interval
        is registered only up to that instant (a full-chunk interval would
        leave phantom contention on the shared link after the session died)
        and ``SessionKilled`` carries the MB the chunk actually moved.
        """
        from repro_torch.netsim.faults import SessionKilled

        faults = self.faults
        load = self.current_load()
        contending, n_active = self._contention()
        noise = float(self._rng.normal(0.0, self.noise_sigma))
        setup_s = self._setup_cost_s(params)
        t0 = self.clock_s
        kill_at = faults.next_kill(self.tenant_id, t0)
        t = t0 + setup_s
        if kill_at is not None and kill_at <= t:
            # killed during process spawn / slow start: nothing moved, and
            # no flow interval is ever registered for this chunk
            self.clock_s = max(kill_at, t0)
            raise SessionKilled(0.0, self.clock_s)

        remaining_mbit = size_mb * 8.0
        moved_mbit = 0.0
        while remaining_mbit > 1e-12:
            link_t = faults.link_at(self.link, t)
            mean = self.mean_throughput(params, avg_file_mb, n_files, load,
                                        contending_mbps=contending,
                                        n_contending=n_active, link=link_t)
            rate = max(mean * (1.0 + noise), 0.01 * mean, 1e-3)
            seg_end = faults.next_change(t)
            if kill_at is not None:
                seg_end = min(seg_end, kill_at)
            if t + remaining_mbit / rate <= seg_end:
                t += remaining_mbit / rate
                moved_mbit += remaining_mbit
                remaining_mbit = 0.0
            else:
                dt = seg_end - t
                moved_mbit += rate * dt
                remaining_mbit -= rate * dt
                t = seg_end
                if kill_at is not None and t >= kill_at:
                    steady = moved_mbit / max(t - t0 - setup_s, 1e-9)
                    self._register_flow(float(steady), kill_at)
                    self.clock_s = t
                    raise SessionKilled(moved_mbit / 8.0, t)
        elapsed = t - t0
        steady = moved_mbit / max(elapsed - setup_s, 1e-9)
        effective = (size_mb * 8.0) / max(elapsed, 1e-9)
        self._register_flow(float(steady), t)
        self.advance(elapsed)
        if is_sample:
            self.sample_count += 1
        return TransferResult(float(effective), float(steady), float(elapsed))

    def measure_steady(self, params: TransferParams, avg_file_mb: float,
                       n_files: int) -> float:
        """Steady-state noisy rate (no setup charge) — used for log replay."""
        load = self.current_load()
        mean = self.mean_throughput(params, avg_file_mb, n_files, load)
        return float(max(mean * (1.0 + self._rng.normal(0.0, self.noise_sigma)),
                         0.01 * mean))


# ----------------------------------------------------------------------- #
# shared-link contention (fleet mode)
# ----------------------------------------------------------------------- #
class SharedLink:
    """Mutable contention state of one physical link carrying many transfers.

    Each tenant's chunk transfer registers its (rate, end-time) interval;
    chunks starting later see the aggregate rate of intervals still active
    and the contending-flow count, which the throughput law turns into a
    fair-share capacity division.  Rates are quasi-static: a chunk's rate is
    solved once at its start against the contenders visible at that instant,
    not re-solved when later chunks arrive mid-flight.
    """

    def __init__(self, link: LinkSpec):
        self.link = link
        self._flows: dict[int, tuple[float, float]] = {}  # id -> (rate, end_s)
        self._lock = threading.Lock()

    def snapshot(self, now_s: float, exclude: int) -> tuple[float, int]:
        """(aggregate contending Mbit/s, active flow count) at ``now_s``."""
        with self._lock:
            live = [rate for tid, (rate, end) in self._flows.items()
                    if tid != exclude and end > now_s]
        return float(sum(live)), len(live)

    def register(self, tenant_id: int, rate_mbps: float, end_s: float) -> None:
        with self._lock:
            self._flows[tenant_id] = (rate_mbps, end_s)

    def release(self, tenant_id: int) -> None:
        with self._lock:
            self._flows.pop(tenant_id, None)


class IndexedSharedLink:
    """Scalable drop-in for :class:`SharedLink`: O(log N) per operation.

    ``SharedLink.snapshot`` walks every registered flow on every call, which
    is O(N) per transfer and quadratic fleet-wide — fine for hundreds of
    tenants, fatal at 1e5+.  This variant keeps running ``sum``/``count``
    aggregates, expiring dead intervals lazily off a min-heap of
    ``(end_s, generation, tenant_id)`` records; the generation counter voids
    stale heap entries when a tenant re-registers before its old interval
    expired.

    Contract differences vs ``SharedLink``:

    * ``snapshot`` times must be nondecreasing (expiry is monotone).  The
      vectorized fleet engine guarantees this — it serializes interactions
      in event order — and the threaded scheduler's conservative clock does
      too, but arbitrary callers should stick with ``SharedLink``.
    * The aggregate is an incrementally-maintained float sum, so its
      rounding differs from ``SharedLink``'s per-snapshot fresh sum: results
      are numerically equal but not bit-identical.  Engines that need the
      oracle-parity guarantee use ``SharedLink`` (``contention="auto"``).

    Not thread-safe: built for the single-threaded vectorized engine.
    """

    def __init__(self, link: LinkSpec):
        self.link = link
        self._rate: dict[int, float] = {}
        self._end: dict[int, float] = {}
        self._gen: dict[int, int] = {}
        self._sum = 0.0
        self._count = 0
        self._next_gen = 0
        self._heap: list[tuple[float, int, int]] = []  # (end_s, gen, tid)

    def _expire(self, now_s: float) -> None:
        while self._heap and self._heap[0][0] <= now_s:
            end, gen, tid = heapq.heappop(self._heap)
            if self._gen.get(tid) == gen:
                self._sum -= self._rate.pop(tid)
                del self._end[tid]
                del self._gen[tid]
                self._count -= 1

    def snapshot(self, now_s: float, exclude: int) -> tuple[float, int]:
        """(aggregate contending Mbit/s, active flow count) at ``now_s``."""
        self._expire(now_s)
        agg, cnt = self._sum, self._count
        rate = self._rate.get(exclude)
        if rate is not None:  # post-expiry, every remaining end_s > now_s
            agg -= rate
            cnt -= 1
        return float(agg), cnt

    def register(self, tenant_id: int, rate_mbps: float, end_s: float) -> None:
        old = self._rate.pop(tenant_id, None)
        if old is not None:
            self._sum -= old
            self._count -= 1
        # Global monotone generation: never reused even across release(), so
        # a stale heap entry can never void a later registration.
        gen = self._next_gen
        self._next_gen += 1
        self._rate[tenant_id] = rate_mbps
        self._end[tenant_id] = end_s
        self._gen[tenant_id] = gen
        self._sum += rate_mbps
        self._count += 1
        heapq.heappush(self._heap, (end_s, gen, tenant_id))

    def live_flow(self, tenant_id: int) -> tuple[float, float] | None:
        """``(rate_mbps, end_s)`` of a tenant's registered flow, or ``None``.

        Reads the index without expiring — entries that survived the last
        ``snapshot`` all end after it, so a caller holding that snapshot can
        subtract its own contribution exactly.  The sharded fleet engine's
        windowed link wrapper uses this to self-exclude against a frozen
        window-start aggregate.
        """
        rate = self._rate.get(tenant_id)
        if rate is None:
            return None
        return rate, self._end[tenant_id]

    def release(self, tenant_id: int) -> None:
        old = self._rate.pop(tenant_id, None)
        if old is not None:
            self._sum -= old
            self._count -= 1
            del self._end[tenant_id]
            del self._gen[tenant_id]


class TenantEnvironment(Environment):
    """One tenant's view of a link shared with other concurrent transfers.

    Behaves exactly like :class:`Environment` when it is alone on the link
    (zero contenders reduce the fair-share division to the single-tenant
    law and the RNG stream is untouched), which is what lets an N=1 fleet
    reproduce the single-tenant ``TransferReport`` bit-for-bit.  ``turn_gate``
    is an optional callable returning a context manager; the fleet scheduler
    uses it to serialize env interactions in simulated-time order.
    """

    def __init__(self, link: LinkSpec, traffic, shared: SharedLink,
                 tenant_id: int, *, noise_sigma: float = 0.03, seed: int = 0,
                 turn_gate=None, faults=None):
        super().__init__(link, traffic, noise_sigma=noise_sigma, seed=seed,
                         faults=faults)
        self.shared = shared
        self.tenant_id = tenant_id
        self.turn_gate = turn_gate

    def _contention(self) -> tuple[float, int]:
        return self.shared.snapshot(self.clock_s, self.tenant_id)

    def _register_flow(self, rate_mbps: float, end_s: float) -> None:
        self.shared.register(self.tenant_id, rate_mbps, end_s)

    def transfer(self, params: TransferParams, size_mb: float,
                 avg_file_mb: float, n_files: int, *,
                 is_sample: bool = False) -> TransferResult:
        if self.turn_gate is None:
            return super().transfer(params, size_mb, avg_file_mb, n_files,
                                    is_sample=is_sample)
        with self.turn_gate(self):
            return super().transfer(params, size_mb, avg_file_mb, n_files,
                                    is_sample=is_sample)
