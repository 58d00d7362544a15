#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one card.

    python3 chip_smoke.py

Phases, each of which fails the run loudly (non-zero exit, no result line):

1. build   -- compile every CUDA kernel from ``src/repro_torch/kernels/csrc``
              with nvcc (one process per source, all at once);
2. kernels -- run each kernel and its plain-torch version on the card at the
              main path's shapes, hold them to each other, and time both
              (see ``cuda_ms``) beside the least time the card could take
              for the same work;
3. offline -- the offline clustering path at 10^6 log rows:
              ``fit_clusters(sample_feature_logs(1_000_000, seed=7),
              m_range=range(4, 13), seed=0, batched=True)`` on the card,
              held to the same call on the CPU;
4. tuner   -- ``TransferTuner`` fit on the merged three-testbed history,
              adaptive transfers over the three testbeds fed back through a
              ``KnowledgeRefresher`` (the additive refit), and one fresh day
              of logs folded in with ``tuner.update``;
5. fleet   -- the fleet path on the real xsede testbed's knowledge (every
              surface of every cluster on the 16^3 lattice): 256 requests
              through ``run_fleet`` on the vectorized engine with admission
              by ``auto_concurrency`` (``transfer_select`` on the card), held
              equal to the same run on knowledge fit on the CPU; 8 requests
              through the threaded, vectorized and sharded engines, held
              equal to each other; and 8 requests through a
              ``KnowledgeService`` that refits on the card.

Phases 3, 4 and 5 are the main path: every kernel's launch count is set to
0 just before each and read just after, and a kernel that the path did not
launch fails the run.  Each ends with one more, profiled run of its fit or
fleet, which reports how much of its wall time the card spent running
kernels.
The last lines are a JSON ``kernels`` summary, the card's name and power
limit, and ``{"ok": true, "device": {...}}``.  The script needs a CUDA card
and the checkout's ``src/`` beside it.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# Published peaks of one H100 SXM at its full 700 W power limit (NVIDIA's
# data sheet): HBM3 bandwidth and float32 outside the tensor cores.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOP_PER_S = 67e12

N_ROWS = 1_000_000          # the repo's stated clustering scale
M_RANGE = range(4, 13)      # its candidate model orders
SPLINE_KNOTS = (1.0, 2.0, 3.0, 4.0, 5.0, 6.0, 8.0, 12.0, 16.0)  # the pp grid
SPLINE_ROWS = 1024
TESTBED_NAMES = ("xsede", "didclab", "didclab-xsede")
FLEET_N = 256               # fleet_scale's largest admission-controller fleet
PARITY_N = 8                # its engine-parity and knowledge-service fleets
SCORE_B, SCORE_P = 64, 16   # its batched-scoring shape


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def _event_ms(run, iters: int) -> list[float]:
    import torch
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        run()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return times


def cuda_ms(fn, iters: int = 30, reps: int = 20) -> tuple[float, float]:
    """(device ms, call ms) of one call of ``fn``, medians over ``iters``.

    Device ms: ``reps`` calls captured in one CUDA graph and replayed
    between two CUDA events, so the host's time to enqueue each call (the
    Python wrapper, allocation, the ctypes call) is not in it.  Call ms: one
    eager call between two events, the host's enqueue time included, which
    is what a caller that waits on each call sees.
    """
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):       # warm-up off the capture stream
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    device = statistics.median(_event_ms(graph.replay, iters)) / reps
    for _ in range(3):
        fn()
    call = statistics.median(_event_ms(fn, iters))
    return device, call


def device_busy(fn) -> tuple[float, float | None]:
    """(wall s, summed kernel s or None) of one call of ``fn`` under
    ``torch.profiler``; None when the profiler saw no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    us = sum(getattr(e, "self_device_time_total", 0.0)
             for e in prof.key_averages())
    return wall, (us * 1e-6 if us > 0 else None)


def busy_text(wall: float, dev: float | None) -> str:
    if dev is None:
        return "device busy share not measured (profiler saw no device time)"
    return (f"device busy {dev:.4f} s of {wall:.3f} s wall under the profiler "
            f"= {100 * dev / wall:.2f}%")


def bound(n_bytes: float, n_flops: float) -> tuple[float, str]:
    """Least time the card could take, in ms, and what sets it."""
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = n_flops / PEAK_F32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _kernel_modules():
    from repro_torch.kernels import cluster_assign, spline_fit, transfer_select
    return {"cluster_assign": cluster_assign, "spline_fit": spline_fit,
            "transfer_select": transfer_select}


def launch_counts() -> dict[str, int]:
    return {name: mod.launches for name, mod in _kernel_modules().items()}


def reset_launch_counts() -> None:
    for mod in _kernel_modules().values():
        mod.launches = 0


# --------------------------------------------------------------------- #
def phase_build() -> float:
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    _build.build_all()
    secs = time.perf_counter() - t0
    print(f"[build] {', '.join(_build.SOURCES)} built in {secs:.2f} s")
    return secs


def phase_kernel_cluster_assign(device) -> dict:
    import numpy as np
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.cluster_assign import cluster_assign_cuda
    from repro_torch.netsim import sample_feature_logs

    X_np = sample_feature_logs(N_ROWS, seed=7).astype(np.float32)
    rng = np.random.default_rng(11)
    C_np = X_np[rng.choice(N_ROWS, M_RANGE[-1], replace=False)]
    X = torch.from_numpy(X_np).to(device)
    C = torch.from_numpy(np.ascontiguousarray(C_np)).to(device)
    n, d = X.shape
    m = C.shape[0]

    lab_k, d2_k = cluster_assign_cuda(X, C)
    torch.cuda.synchronize()
    lab_p, d2_p = ref.cluster_assign_ref(X, C)
    torch.cuda.synchronize()
    # distance: rtol 1e-5, plus an absolute floor at f32 resolution of the
    # expansion |x|^2 - 2x.c + |c|^2, which cancels for points near a centroid
    x2 = (X * X).sum(1)
    c2 = (C * C).sum(1)
    scale = x2 + c2.max()
    err = (d2_k - d2_p).abs()
    check(bool((err <= 1e-5 * d2_p.abs() + 1e-5 * scale).all()),
          f"cluster_assign d2 disagrees with its plain version "
          f"(max abs err {err.max().item():.3e})")
    # labels: equal wherever the best and second-best d2 are further apart
    # than 1e-4 (|x|^2 + |c|^2); nearer than that, f32 rounding may pick either
    full = torch.clamp(x2[:, None] - 2.0 * (X @ C.T) + c2[None, :], min=0.0)
    two = torch.topk(full, 2, dim=1, largest=False).values
    clear = (two[:, 1] - two[:, 0]) > 1e-4 * (x2 + c2[lab_p.long()])
    bad = int(((lab_k != lab_p) & clear).sum().item())
    check(bad == 0, f"cluster_assign labels differ on {bad} clear points")
    n_clear = int(clear.sum().item())

    ms, call_ms = cuda_ms(lambda: cluster_assign_cuda(X, C))
    plain_ms, plain_call_ms = cuda_ms(lambda: ref.cluster_assign_ref(X, C))
    n_bytes = 4 * (n * d + m * d) + 8 * n
    n_flops = n * (2 * d + m * (2 * d + 3))
    bound_ms, bound_by = bound(n_bytes, n_flops)
    print(f"[kernels] cluster_assign N={n} d={d} M={m}: max_abs_err(d2)="
          f"{err.max().item():.3e}, labels equal on all {n_clear} clear "
          f"points; kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} "
          f"bound_ms={bound_ms:.4f} ({bound_by}); per eager call "
          f"kernel {call_ms:.4f} ms, plain {plain_call_ms:.4f} ms; library_ms: "
          f"none (no one PyTorch call gives the nearest centroid and its "
          f"distance)")
    return {"name": "cluster_assign", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/cluster_assign.cu",
            "replaces": "src/repro/kernels/cluster_assign.py:51",
            "max_abs_err": err.max().item(), "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None}


def phase_kernel_spline_fit(device) -> dict:
    import numpy as np
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.spline_fit import nat_spline_fit_cuda

    rng = np.random.default_rng(12)
    x = torch.tensor(SPLINE_KNOTS, dtype=torch.float32, device=device)
    Y_np = rng.uniform(50.0, 10_000.0, (SPLINE_ROWS, len(SPLINE_KNOTS)))
    Y = torch.from_numpy(Y_np.astype(np.float32)).to(device)
    R, n = Y.shape

    out_k = nat_spline_fit_cuda(x, Y)
    torch.cuda.synchronize()
    out_p = ref.nat_spline_fit_ref(x, Y)
    torch.cuda.synchronize()
    # rtol 1e-5, plus an absolute floor at 1e-5 of the data scale: the b and
    # d coefficients are differences of f32 terms of that size
    err = (out_k - out_p).abs()
    tol = 1e-5 * out_p.abs() + 1e-5 * Y.abs().max()
    check(bool((err <= tol).all()),
          f"spline_fit disagrees with its plain version "
          f"(max abs err {err.max().item():.3e})")

    ms, call_ms = cuda_ms(lambda: nat_spline_fit_cuda(x, Y))
    plain_ms, plain_call_ms = cuda_ms(lambda: ref.nat_spline_fit_ref(x, Y))
    n_bytes = 4 * (n + R * n + R * (n - 1) * 4)
    n_flops = R * (11 * (n - 2) + 12 * (n - 1))
    bound_ms, bound_by = bound(n_bytes, n_flops)
    print(f"[kernels] spline_fit N={n} R={R}: max_abs_err={err.max().item():.3e}; "
          f"kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} bound_ms={bound_ms:.6f} "
          f"({bound_by}); per eager call kernel {call_ms:.4f} ms, plain "
          f"{plain_call_ms:.4f} ms; library_ms: none (no one PyTorch call "
          f"fits natural-spline coefficients)")
    return {"name": "spline_fit", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/spline_fit.cu",
            "replaces": "src/repro/kernels/spline_fit.py:83",
            "max_abs_err": err.max().item(), "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None}


def fleet_db(device):
    """The fleet benchmark's knowledge: ten days of xsede history at 180
    transfers a day, fit with the tuner's defaults on ``device``."""
    from repro_torch.core import TransferTuner, TunerConfig
    from repro_torch.netsim import generate_history, make_testbed
    hist = generate_history(make_testbed("xsede", seed=3), days=10,
                            transfers_per_day=180, seed=0)
    return TransferTuner(TunerConfig(seed=0, device=device)).fit(hist).db


def fleet_requests(n: int) -> list:
    """The fleet benchmark's requests: the three file classes in turn, all
    starting at 04:00 under a constant 15% external load."""
    from repro_torch.core import FleetRequest
    from repro_torch.netsim import make_dataset
    return [FleetRequest(dataset=make_dataset(("small", "medium", "large")[i % 3],
                                              30 + i),
                         env_seed=500 + i, start_clock_s=4 * 3600.0,
                         constant_load=0.15)
            for i in range(n)]


def _select_case(stack, pts, label: str) -> dict:
    """Hold ``transfer_select`` to its plain version on one cluster's stack
    and the lattice points ``pts`` (B, P, 3), and time both."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.transfer_select import batched_predict_argmax_cuda

    values = stack.flat_values
    idx = stack.flat_index(pts)
    S, G = values.shape
    B, P = idx.shape

    best_k, argk_k = batched_predict_argmax_cuda(values, idx)
    torch.cuda.synchronize()
    best_p, argk_p = ref.batched_predict_argmax_ref(values, idx)
    torch.cuda.synchronize()
    # a gather and a max with no arithmetic: the kernel must be bit-exact
    check(torch.equal(best_k, best_p) and torch.equal(argk_k, argk_p),
          f"transfer_select at {label} differs from its plain version")
    err = (best_k - best_p).abs().max().item()

    ms, call_ms = cuda_ms(lambda: batched_predict_argmax_cuda(values, idx))
    plain_ms, plain_call_ms = cuda_ms(
        lambda: ref.batched_predict_argmax_ref(values, idx))
    # bytes this run's data needs: the lattice values its distinct indices
    # select from every surface, the indices, and both outputs
    n_distinct = int(torch.unique(idx).numel())
    n_bytes = 4 * S * n_distinct + 4 * B * P + 8 * B * S
    n_ops = B * S * P                     # one comparison per candidate
    bound_ms, bound_by = bound(n_bytes, n_ops)
    print(f"[kernels] transfer_select {label} B={B} P={P} S={S} G={G}: "
          f"bit-exact (max_abs_err {err:.1e}); kernel_ms={ms:.4f} "
          f"plain_ms={plain_ms:.4f} bound_ms={bound_ms:.3e} ({bound_by}); "
          f"per eager call kernel {call_ms:.4f} ms, plain {plain_call_ms:.4f} "
          f"ms; library_ms: none (no one PyTorch call gathers candidates and "
          f"takes their first-index max)")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None}


def phase_kernel_transfer_select(db) -> dict:
    """At the admission path's shape (one batch row: the cluster's own argmax
    points, as ``predict_demands`` scores them) and at the fleet benchmark's
    batched-scoring shape (random lattice points)."""
    import numpy as np
    stack = max((ck.surface_stack(db.bounds) for ck in db.clusters),
                key=lambda st: st.n_surfaces)
    row = _select_case(stack, stack.argmax_pts[None], "admission shape")
    rng = np.random.default_rng(13)
    pts = np.stack([rng.integers(1, 17, (SCORE_B, SCORE_P)) for _ in range(3)],
                   -1)
    _select_case(stack, pts, "scoring shape")
    return {"name": "transfer_select", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/transfer_select.cu",
            "replaces": "src/repro/kernels/transfer_select.py:50", **row}


def phase_offline(device) -> dict[str, int]:
    import torch
    from repro_torch.core.clustering import fit_clusters, label_agreement
    from repro_torch.netsim import sample_feature_logs

    X = sample_feature_logs(N_ROWS, seed=7)

    def fit(dev, **kw):
        return fit_clusters(X, m_range=M_RANGE, seed=0, batched=True,
                            device=dev, **kw)

    fit(device)                                   # warm-up
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    card = fit(device)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    counts = launch_counts()
    check(counts["cluster_assign"] == len(M_RANGE),
          f"the 10^6-row fit launched cluster_assign "
          f"{counts['cluster_assign']} times, not once per order "
          f"({len(M_RANGE)})")
    t0 = time.perf_counter()
    host = fit("cpu", use_kernel=True)
    host_s = time.perf_counter() - t0
    agree = label_agreement(card.labels, host.labels)
    print(f"[offline] n={X.shape[0]} m_range={M_RANGE.start}..{M_RANGE.stop - 1}: "
          f"card m={card.m} in {card_s:.3f} s with {counts['cluster_assign']} "
          f"cluster_assign launches; cpu m={host.m} in {host_s:.3f} s; "
          f"label_agreement={agree:.6f}")
    check(card.m == host.m, f"card chose m={card.m}, cpu chose m={host.m}")
    check(agree >= 0.999, f"card/cpu label agreement {agree:.6f} < 0.999")
    busy = device_busy(lambda: fit(device))
    print(f"[offline] profiled card fit: {busy_text(*busy)}")
    return counts


def phase_tuner(device) -> dict[str, int]:
    import numpy as np
    import torch
    from repro_torch.core import (
        KnowledgeRefresher, RefreshConfig, TransferTuner, TunerConfig,
        fit_clusters, label_agreement, session_log_entries,
    )
    from repro_torch.netsim import (
        ParamBounds, generate_multi_network_history, make_dataset,
        make_testbed,
    )

    history = generate_multi_network_history()
    reset_launch_counts()
    t0 = time.perf_counter()
    tuner = TransferTuner(TunerConfig(seed=0, device=device)).fit(history)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    fit_counts = launch_counts()
    cm = tuner.db.cluster_model
    # the same clustering on the CPU must choose the same model order
    X = np.stack([e.features() for e in history])
    host = fit_clusters(X, seed=0, device="cpu", use_kernel=True)
    agree = label_agreement(cm.labels, host.labels)
    print(f"[tuner] fit on {len(history)} entries in {fit_s:.3f} s: m={cm.m} "
          f"(cpu m={host.m}, label_agreement={agree:.6f}), "
          f"{sum(len(c.surfaces) for c in tuner.db.clusters)} surfaces, "
          f"launches {fit_counts}")
    check(cm.m == host.m and agree >= 0.999,
          "tuner clustering on the card disagrees with the CPU")

    refresher = KnowledgeRefresher(
        tuner.db, config=RefreshConfig(every_completions=2, min_entries=4))
    accs, transfer_s, refit_s = [], 0.0, 0.0
    for i in range(6):
        name = TESTBED_NAMES[i % 3]
        env = make_testbed(name, seed=200 + i)
        env.clock_s = (3 + 4 * i) * 3600.0
        dataset = make_dataset(("small", "medium", "large")[i % 3], 30 + i)
        t0 = time.perf_counter()
        report = tuner.transfer(env, dataset)
        transfer_s += time.perf_counter() - t0
        _, opt_th = env.optimal(ParamBounds(), dataset.avg_file_mb,
                                dataset.n_files)
        check(np.isfinite(report.steady_mbps) and report.steady_mbps > 0,
              f"transfer {i} on {name} has steady rate {report.steady_mbps}")
        accs.append(100.0 * min(report.steady_mbps, opt_th) / opt_th)
        entries = session_log_entries(report, env.link, dataset,
                                      end_clock_s=env.clock_s,
                                      src=f"{name}/a", dst=f"{name}/b")
        t0 = time.perf_counter()
        refresher.ingest(entries, now_s=env.clock_s)
        torch.cuda.synchronize()
        refit_s += time.perf_counter() - t0
    fresh = generate_multi_network_history(days=1.0, transfers_per_day=220,
                                           seed=5)
    t0 = time.perf_counter()
    tuner.update(fresh)
    torch.cuda.synchronize()
    update_s = time.perf_counter() - t0
    counts = launch_counts()
    print(f"[tuner] {len(accs)} transfers in {transfer_s:.3f} s, steady-rate "
          f"accuracy vs env.optimal: mean {statistics.mean(accs):.1f}% "
          f"(min {min(accs):.1f}%); {refresher.refreshes} refreshes "
          f"({refresher.entries_folded} entries) in {refit_s:.3f} s; "
          f"update with {len(fresh)} fresh entries in {update_s:.3f} s; "
          f"launches {counts}")
    check(refresher.refreshes >= 1, "the refresher never refit")
    check(len(fresh) >= 512, "the fresh day has fewer than 512 entries")
    for name in ("cluster_assign", "spline_fit"):
        check(counts[name] > 0, f"the tuner phase launched {name} no time")
    busy = device_busy(lambda: TransferTuner(
        TunerConfig(seed=0, device=device)).fit(history))
    print(f"[tuner] profiled tuner fit: {busy_text(*busy)}")
    return counts


def phase_fleet(device, card_db) -> dict[str, int]:
    import torch
    from repro_torch.core import (
        EngineConfig, KnowledgeService, ServiceConfig, run_fleet,
    )

    reqs = fleet_requests(FLEET_N)
    reset_launch_counts()
    t0 = time.perf_counter()
    card = run_fleet(card_db, reqs, EngineConfig(engine="vectorized"))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n256 = launch_counts()
    check(n256["transfer_select"] > 0,
          "the N=256 fleet's admission never launched transfer_select")
    check(len(card.reports) == FLEET_N and card.goodput_mbps > 0
          and card.accuracy_vs_single > 0,
          f"the N={FLEET_N} fleet is degenerate: {len(card.reports)} reports, "
          f"goodput {card.goodput_mbps}, accuracy {card.accuracy_vs_single}")
    host = run_fleet(fleet_db("cpu"), fleet_requests(FLEET_N),
                     EngineConfig(engine="vectorized"))
    check(card == host, f"the N={FLEET_N} fleet on the card differs from the "
          "same fleet on knowledge fit on the CPU")
    print(f"[fleet] N={FLEET_N} vectorized, auto admission: wall {wall:.3f} s "
          f"({FLEET_N / wall:.1f} sessions/s; the first run of these requests "
          f"includes their single-tenant optima), goodput "
          f"{card.goodput_mbps:.3f} Mbit/s, accuracy_vs_single "
          f"{card.accuracy_vs_single:.3f}%, admitted_concurrency "
          f"{card.admitted_concurrency}, makespan {card.makespan_s:.3f} s, "
          f"launches {n256}; equal to the CPU-fit run")

    reports = {}
    for engine, kw in (("threaded", {}), ("vectorized", {}),
                       ("sharded", {"n_shards": 2, "shard_window_s": 0.0})):
        t0 = time.perf_counter()
        reports[engine] = run_fleet(card_db, fleet_requests(PARITY_N),
                                    EngineConfig(engine=engine, **kw))
        torch.cuda.synchronize()
        print(f"[fleet] N={PARITY_N} {engine}: {time.perf_counter() - t0:.3f} s, "
              f"admitted_concurrency {reports[engine].admitted_concurrency}")
    check(reports["threaded"] == reports["vectorized"] == reports["sharded"],
          f"the three engines disagree at N={PARITY_N}")

    svc_db = fleet_db(device)
    # the scenario harness's service bounds: the fleet benchmark's 600 s
    # staleness bound never fires inside an 8-request fleet's makespan
    svc = KnowledgeService(svc_db, ServiceConfig(max_staleness_s=120.0,
                                                 drift_threshold=0.1))
    t0 = time.perf_counter()
    served = run_fleet(svc_db, fleet_requests(PARITY_N),
                       EngineConfig(max_concurrent=4, knowledge=svc))
    torch.cuda.synchronize()
    stats = svc.stats()
    print(f"[fleet] N={PARITY_N} through a KnowledgeService: "
          f"{time.perf_counter() - t0:.3f} s, {stats.refits} refits, "
          f"{stats.entries_folded} entries folded, {stats.minibatch_updates} "
          f"mini-batch updates, goodput {served.goodput_mbps:.3f} Mbit/s")
    check(len(served.reports) == PARITY_N
          and (stats.refits >= 1 or stats.entries_folded >= 1),
          "the knowledge service fleet neither refit nor folded an entry")
    counts = launch_counts()
    print(f"[fleet] launches {counts}")
    busy = device_busy(lambda: run_fleet(card_db, fleet_requests(FLEET_N),
                                         EngineConfig(engine="vectorized")))
    print(f"[fleet] profiled N={FLEET_N} fleet (single-tenant optima cached): "
          f"{busy_text(*busy)}")
    return counts


# --------------------------------------------------------------------- #
def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this smoke "
              "run needs a CUDA card", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        print(f"chip_smoke: no port sources under {SRC}; run from a checkout "
              "of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    # Full float32 in every matmul and convolution on the card: TF32 would
    # round the clustering path's cross terms to ~3 digits.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    print(f"[device] {torch.cuda.get_device_name(0)}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, python {sys.version.split()[0]}")

    t_start = time.perf_counter()
    phase_build()
    card_db = fleet_db(device)
    rows = [phase_kernel_cluster_assign(device), phase_kernel_spline_fit(device),
            phase_kernel_transfer_select(card_db)]
    paths = [phase_offline(device), phase_tuner(device),
             phase_fleet(device, card_db)]
    for row in rows:
        row["launches"] = sum(path[row["name"]] for path in paths)
        check(row["launches"] > 0, f"the main path never launched {row['name']}")
    print(f"[done] all phases passed in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": rows}))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
