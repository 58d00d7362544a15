#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one card.

    python3 chip_smoke.py

Phases, each of which fails the run loudly (non-zero exit, no result line):

1. build   -- compile every CUDA kernel from ``src/repro_torch/kernels/csrc``
              with nvcc (one process per source, all at once);
2. kernels -- run each kernel and its plain-torch version on the card at the
              main path's shapes, hold them to each other, and time both
              (see ``cuda_ms``) beside the least time the card could take
              for the same work; ``decode_attention``, which has no TPU
              counterpart, at the serve paths' GQA decode shapes, held to
              float64 with bf16-rounded controls at minitron-4b's;
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
              ``KnowledgeService`` that refits on the card;
6. baselines -- the paper's comparison on xsede as ``benchmarks/common.py::
              build_world`` sets it up: the ASM tuner fitted on the card, the
              six baselines with ANN+OT trained on the card (held to the same
              training on the CPU), a miniature Fig. 5 and Fig. 6;
7. serve   -- zamba2-7b at full width and depth (81 Mamba2 layers, the
              shared attention block 13 times, d_model 3584), weights from
              a seeded generator on the card: 8 seeded prompts of 2048
              tokens, prefill, then 64 greedy decode steps through
              ``repro_torch.launch.serve``, held to the same weights and
              prompts on the plain route (``use_kernel=False``, teacher
              forced on the kernel run's tokens); one prefill launches
              exactly 81 ``ssd_scan`` and 13 ``flash_attention``, a decode
              step 13 ``decode_attention``;
8. serve   -- rwkv6-1.6b at full width and depth (24 RWKV6 layers,
              d_model 2048, 32 heads of 64) the same way; one prefill and
              every decode step each launch exactly 24 ``rwkv6``;
9. serve   -- minitron-4b, dense GQA, at full width and depth (32 layers,
              d_model 3072, 24 query heads over 8 kv heads of 128, vocab
              256,000) the same way; one prefill launches exactly 32
              ``flash_attention``, a decode step 32 ``decode_attention``;
10. serve  -- mixtral-8x22b, mixture of experts, at full width (d_model
              6144, 48 query heads over 8 kv heads of 128, 8 experts of
              16,384, top 2) and 8 of its 56 layers (the whole model is 281
              GB in bf16; its float32 check runs 2 layers) the same way; one
              prefill launches exactly 8 ``flash_attention``, a decode step
              8 ``decode_attention``;
11. serve  -- musicgen-large, audio, at full width and depth (48 layers,
              d_model 2048, 32 heads of 64, 4 EnCodec codebook streams of
              2048 ids: prompts (8, 2048, 4), logits (8, 1, 4, 2048)) the
              same way; one prefill launches exactly 48 ``flash_attention``
              on the kernel's KD = 4 instance, a decode step 48
              ``decode_attention``;
12. serve  -- qwen2-vl-2b, vision-language, at full width and depth (28
              layers, d_model 1536, 12 query heads over 2 kv heads of 128,
              M-RoPE, QKV bias, vocab 151,936) the same way, its prefill
              given 256 seeded patch embeddings in place of its first
              positions (the vision stub); one prefill launches exactly 28
              ``flash_attention`` on the KD = 8 instance, a decode step 28
              ``decode_attention``;
13. checkpoint -- a ``CheckpointTuner`` seeded with real probe saves of a
              tree on the card; rwkv6-1.6b's full weights saved to disk under
              its recommendation and under (1, 1, 1), restored to the card
              bit for bit, and one prefill through the restored model (24
              ``rwkv6``, logits equal to the original's); ``TokenPipeline``
              at the serve shape fed to the card;
14. serve  -- deepseek-v3-671b, MLA and the first_k_dense stack, at full
              width (d_model 7168, 128 heads of 128 + 64 RoPE for q and k
              and 128 for v, latents of 512 + 64, 256 routed experts of 2048
              and one shared, top 8 by a sigmoid gate) and 5 of its 61
              layers, its 3 dense ones and 2 MoE (the whole model is 671 B
              parameters; its float32 check runs the 3 dense and 1 MoE) the
              same way; one prefill launches exactly 5 ``flash_attention``,
              all on the kernel's KD = 12 instance (D = 192 unpadded),
              decode none (MLA's absorbed decode is plain torch);
15. train  -- qwen2-vl-2b whole (1.78 B parameters in bf16, float32
              master, bf16 moments) trained through
              ``repro_torch.train.loop.Trainer``: 12 steps of 8 x 1024
              tokens in 2 microbatches with remat, on 2 seeded batches
              repeated (256 seeded patch embeddings a row), warmup 3; each
              step launches exactly 112 ``flash_attention`` (2 microbatches
              x 28 layers, forward and recompute; the backward is the plain
              version's vjp), all on KD = 8, and the loss must fall; every
              launch of a microbatch's forward and backward held to its
              plain version; one float32 step at 4 layers on the kernel
              route, each launch held to its plain version, and its loss
              and gradients to the plain route's within the growth
              measured in the run times an a-priori launch difference,
              a gate that bf16-rounded kernel outputs must fail; then two
              bf16 steps each of rwkv6-1.6b whole (48 ``rwkv6`` a step)
              and zamba2-7b at full width and 6 of its 81 layers (12
              ``ssd_scan``, 2 ``flash_attention`` a step), with the same
              gates, their losses phase 17's unsplit ones;
16. dist   -- ``repro_torch.dist`` on a 1-rank NCCL group and
              ``make_host_mesh()``'s (1, 1) mesh: the paper's tuner fit on
              ``ici_environment``'s history (the card's NVLink modelled in
              its throughput law) tunes the gradient all-reduce's
              ``BucketPlan``; phase 15's first 4 steps of qwen2-vl-2b
              through the sharded step (gradients averaged over ``data``
              by ``bucketed_allreduce`` with that plan, the optimizer state
              at rest as DTensors) held bit for bit to the unsharded step
              from the same seed and batches (loss, gradient norm, every
              parameter), 112 ``flash_attention`` a step; the step's whole
              flat gradient (1.777 B float32) through ``flatten_grads``
              and both all-reduces, bucketed exact and int8 within half a
              step of each chunk's scale, each timed (a 1-rank figure)
              beside its bytes bound; ``make_pipeline_fn`` at S = 1 over
              the 28 layers, 4 microbatches of 2 x 2048, equal to the
              sequential stack, 112 launches; ``recover`` of the trained
              parameters from a checkpoint onto the (1, 1) mesh, every
              leaf equal and in its placements.  A failed NCCL start
              fails the run;
17. tp     -- ``repro_torch.dist.tensor_parallel``: qwen2-vl-2b whole split
              over a (1, 2) ``("data", "model")`` mesh on ``cuda``, two
              processes sharing the card on a gloo group (NCCL refuses two
              ranks on one device: "Duplicate GPU detected"; gloo takes
              the CUDA tensors, the kernels run on the card), 6 q heads
              over 1 kv head, half the MLP and half the vocabulary a rank:
              phase 16's 4 train steps (112 ``flash_attention`` a rank and
              step, as unsplit), their bf16 losses within
              ``TP_BF16_LOSS_RTOL`` of phase 16's unsharded ones; one
              microbatch's forward and backward and a prefill and decode
              step with every launch held to its plain version on the
              same activations (the local (8, 2048, 6/1, 128)); a prefill
              of 8 x 2048 (28 launches) and 8 greedy decode steps, equal
              on both ranks; a float32 control at 2 layers (its weights
              rescaled to std 1/sqrt(fan-in), ``_tp_f32_control``), split
              against unsplit on the card, within 1e-5 with equal tokens.
              Then the scan families on the same two ranks, each region
              split (``TP_SCAN_ARCHS``): zamba2-7b's Mamba2 layers (56 of
              112 SSD heads a rank, w_in cut by its [z | x | B | C | dt]
              index map), its shared block (16 of 32 q and kv heads) and
              vocabulary, and rwkv6-1.6b's time mix (16 of 32 heads),
              channel mix and vocabulary: phase 15's two bf16 steps
              (zamba2-7b at 6 layers, rwkv6-1.6b whole, 4 x 1024; exact
              launches a rank and step; losses within
              ``TP_BF16_LOSS_RTOL`` of phase 15's), a checked forward and
              backward, a prefill of 8 x 2048 and 8 decode steps
              (zamba2-7b at ``TP_SERVE_LAYERS``' 27 layers: 27
              ``ssd_scan`` and 4 ``flash_attention``; rwkv6-1.6b whole, 24
              ``rwkv6``, a prefill; 24 ``rwkv6`` a decode step) and a
              checked prefill and decode step, every launch at the local
              shapes held to its plain version, and the float32 control
              at 2 layers (zamba2-7b's shared block applied once).  Then
              the MoE family on the same two ranks (``TP_MOE_ARCHS``, no
              train step), each region split: mixtral-8x22b at 8 layers
              (4 of 8 experts, 24 of 48 q heads over 4 of 8 kv heads, half
              the vocabulary a rank) and deepseek-v3-671b at 4 layers, 3
              dense and 1 MoE (128 of 256 experts, 64 of 128 MLA heads,
              half the dense and shared FFNs and the vocabulary; 5 layers
              would leave the two ranks' weights and checks ~70 GB of the
              80), each seeded a rank at a time (``_init_in_turn``): a
              prefill of 8 x 2048 (8 or 4 ``flash_attention``) and 8
              decode steps, exact launches, a checked prefill and decode
              step with every launch at the local shapes held to its
              plain version (MLA's to float64, as phase 14 holds them),
              the first MoE layer's split bf16 output on that prefill's
              activations against the unsplit layer's on rank 0
              (``_moe_layer_check``), and the float32 control without
              train steps (mixtral-8x22b at 2 layers, its experts split;
              deepseek-v3-671b's 3 dense MLA layers).  Last, FSDP
              (``repro_torch.dist.fsdp``, ``_fsdp_model``): qwen2-vl-2b
              whole cut over the ``data`` axis of a (2, 1) mesh on the same
              two ranks (each weight's ``embed`` dim; a layer's weights
              gathered whole for its compute, its gradients
              reduce-scattered back): a rank's resting parameters at most
              half the whole model's plus the leaves left whole (and
              ``torch.cuda.memory_allocated`` across the build within the
              caching allocator's rounding of that); phase
              16's 4 steps, each rank its 2 rows of each microbatch, 112
              ``flash_attention`` a rank and step, bf16 losses within
              ``TP_BF16_LOSS_RTOL`` of phase 16's and equal on both
              ranks; a checked forward and backward; a prefill of the
              rank's 4 of the 8 x 2048 prompts and 8 decode steps, exact
              launches, a checked prefill and decode step; the float32
              control at 2 layers, its greedy tokens over both ranks'
              rows equal to the unsplit model's.  Each rank's step p50,
              peak memory and prefill time are printed beside the card's
              name and power limit; two processes share its SMs, so none
              is a speed figure for the split.  A rank's failure fails
              the run;
18. launch -- the launch tooling and the static analysis on the card's
              host, each in a process of its own (a default process group
              starts once a process, and phase 16's was in this one), all
              at once and beside phase 17 (host work on fake tensors; phase
              17's two ranks mostly wait on the card and on gloo, and give
              no speed figure): ``repro_torch.launch.dryrun`` for rwkv6-1.6b x
              decode_32k on the (16, 16) and (2, 16, 16) meshes of a fake
              256- and 512-rank group, for qwen2-vl-2b x train_4k on both
              and for llama3-405b, zamba2-7b, mixtral-8x22b and
              deepseek-v3-671b x decode_32k on the (16, 16) one (fake
              tensors on the card's device type: nothing allocated, no
              kernel launched; every family split over ``model``),
              its cost mode for rwkv6-1.6b x decode_32k, then
              ``repro_torch.launch.roofline`` over those rows; an error
              row, a wrong ``n_devices`` or zero FLOPs or peak fails the
              run (the CLI writes error rows with exit 0), and so does a
              qwen2-vl-2b x train_4k row past 4.0e14 FLOPs or 95 GB a rank
              at 16x16, or a 2x16x16 row whose FLOPs are not half of it,
              or the split decode rows at 16x16 past their gates
              (``SPLIT_DECODE_GATES``: zamba2-7b within 2.44e10 FLOPs and
              7 GiB, rwkv6-1.6b within 2.9e9 FLOPs, mixtral-8x22b within
              3.1e11 and 17 GiB, deepseek-v3-671b within 1.93e12 and 49
              GiB; zamba2-7b's, mixtral-8x22b's and deepseek-v3-671b's
              argument bytes the reference's; the two MoE rows' peaks at
              or below the reference's own device's,
              ``REFERENCE_DECODE_PEAK``), or without their split plan's
              line (every family also cut over ``data``);
              ``python -m repro_torch.analysis src/repro_torch`` must find
              nothing.  Each row is printed beside the card's name and
              power limit.

Phases 3 to 17 are the main path: every kernel's launch count is set to
0 just before each and read just after (phase 13: just around the restored
model's prefill; phase 15: around each timed train step; phase 16: around
each sharded step and the pipeline; phase 17: in each rank's process,
around each split step and the timed serve run, summed over the ranks),
and a kernel that the path did not launch fails the run.  Phases 3 to 6 end with one
more, profiled run of a fit, a fleet or a training, phases 7-12 and 14
profile decode steps and a prefill, and phase 15 a train step, to report
how much of the wall time the card spent running kernels.  Before phase 3 a
one-element ``add_`` is timed as the kernels are: the floor of one launch.
The last lines are a JSON ``kernels`` summary (``launches`` over the whole
main path, ``train_launches`` those of phase 15's timed steps,
``dist_launches`` phase 16's, ``tp_launches`` phase 17's), the
card's name and power limit, and ``{"ok": true, "device": {...}}``.  The
script needs a CUDA card and the checkout's ``src/`` beside it.
"""
from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# Published peaks of one H100 SXM at its full 700 W power limit (NVIDIA's
# data sheet), from the port's roofline, which holds the card's figures:
# HBM3 bandwidth, float32 outside the tensor cores, and bf16 on the tensor
# cores (dense).
sys.path.insert(0, str(SRC))
try:
    from repro_torch.launch.roofline import CHIP_F32_FLOPS as PEAK_F32_FLOP_PER_S
    from repro_torch.launch.roofline import CHIP_FLOPS as PEAK_BF16_FLOP_PER_S
    from repro_torch.launch.roofline import HBM_BPS as PEAK_BYTES_PER_S
except ImportError:         # no checkout beside the script: main() says so
    PEAK_BYTES_PER_S = PEAK_F32_FLOP_PER_S = PEAK_BF16_FLOP_PER_S = None

N_ROWS = 1_000_000          # the repo's stated clustering scale
M_RANGE = range(4, 13)      # its candidate model orders
SPLINE_KNOTS = (1.0, 2.0, 3.0, 4.0, 5.0, 6.0, 8.0, 12.0, 16.0)  # the pp grid
SPLINE_ROWS = 1024
TESTBED_NAMES = ("xsede", "didclab", "didclab-xsede")
FLEET_N = 256               # fleet_scale's largest admission-controller fleet
PARITY_N = 8                # its engine-parity and knowledge-service fleets
SCORE_B, SCORE_P = 64, 16   # its batched-scoring shape
# the port's LM families at full width: hybrid, RWKV6, dense GQA, MoE,
# audio and vision-language
SERVE_ARCHS = ("zamba2-7b", "rwkv6-1.6b", "minitron-4b", "mixtral-8x22b",
               "musicgen-large", "qwen2-vl-2b")
MLA_ARCH = "deepseek-v3-671b"   # served after the checkpoint phase (14)
SERVE_BATCH, SERVE_PROMPT = 8, 2048
SERVE_STEPS = 64            # greedy decode steps after the prefill
# depth cuts, where the whole model does not fit one 80 GB card: mixtral's
# 56 layers are 281 GB in bf16, 8 of them 41 GB; its float32 check, twice
# the bytes a layer, takes 2.  deepseek-v3-671b's first 5 layers are its 3
# dense ones (0.58 B parameters each) and 2 MoE (11.51 B each), with 1.85 B
# of embedding and head 26.6 B, 53.2 GB in bf16 (a third MoE layer: 76
# GB); its float32 check keeps the 3 dense and 1 MoE, 60 GB (a second MoE
# layer alone is 46 GB).  Each cut stack's init std follows its cut depth
# (1/sqrt(n) over the n layers of a stack, the reference's rule).
SERVE_LAYERS = {"mixtral-8x22b": 8, MLA_ARCH: 5}
F32_LAYERS = {"mixtral-8x22b": 2, MLA_ARCH: 4}
# Above this many bytes of float32 scores (B x Hq x Sq x Sk x 4: 17.2 GB at
# deepseek's 128 heads, beside 53 GB of weights) the plain attention runs
# one batch row at a time (``plain_attention_by_row``); below it, as it is.
PLAIN_SCORES_BYTES = 8e9


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


def device_profile(fn, top: int | None = 0):
    """(wall s, summed kernel s or None, the ``top`` kernels (None: all) by
    device time as (name, ms, calls)) of one call of ``fn`` under
    ``torch.profiler``; None when the profiler saw no device time.  Only
    device-side events count (kernels, copies, sets): an operator's own row
    repeats the time of the kernels it launched, and the profiler's
    "Command Buffer Full" marker is the host waiting, not the device
    working."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = [e for e in prof.key_averages()
              if getattr(e, "device_type", None) == DeviceType.CUDA
              and not e.key.startswith("Command Buffer")]
    us = sum(e.self_device_time_total for e in events)
    ranked = sorted(events, key=lambda e: e.self_device_time_total,
                    reverse=True)
    ops = [(e.key, e.self_device_time_total / 1e3, e.count)
           for e in ranked[:top]]
    return wall, (us * 1e-6 if us > 0 else None), ops


def device_busy(fn) -> tuple[float, float | None]:
    """(wall s, summed kernel s or None) of one call of ``fn`` under
    ``torch.profiler``; None when the profiler saw no device time."""
    wall, dev, _ = device_profile(fn)
    return wall, dev


def top_text(ops) -> str:
    return "; ".join(f"{name[:60]} {ms:.2f} ms x{n}" for name, ms, n in ops)


def busy_text(wall: float, dev: float | None) -> str:
    if dev is None:
        return "device busy share not measured (profiler saw no device time)"
    return (f"device busy {dev:.4f} s of {wall:.3f} s wall under the profiler "
            f"= {100 * dev / wall:.2f}%")


def bound(n_bytes: float, n_flops: float, peak_flops: float = PEAK_F32_FLOP_PER_S
          ) -> tuple[float, str]:
    """Least time the card could take, in ms, and what sets it."""
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = n_flops / peak_flops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _kernel_modules():
    from repro_torch.kernels import (
        cluster_assign, decode_attention, flash_attention, rwkv6, spline_fit,
        ssm_scan, transfer_select,
    )
    return {"cluster_assign": cluster_assign, "spline_fit": spline_fit,
            "transfer_select": transfer_select,
            "flash_attention": flash_attention, "ssd_scan": ssm_scan,
            "rwkv6": rwkv6, "decode_attention": decode_attention}


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


def _valid_pairs(Sq: int, Sk: int, causal: bool, window: int,
                 q_offset: int) -> int:
    """(query, key) pairs that the masks let through, per (batch, head)."""
    import numpy as np
    qpos = np.arange(Sq) + q_offset
    hi = np.minimum(qpos, Sk - 1) if causal else np.full(Sq, Sk - 1)
    lo = np.maximum(qpos - window + 1, 0) if window > 0 else np.zeros(Sq, int)
    return int(np.maximum(hi - lo + 1, 0).sum())


# The bf16 kernel against the plain route in float32 on the same bf16-valued
# inputs, element by element: |out - want| <= ATTN_BF16_C (2^-8 |want| +
# 2^-9 max |want| over the element's row).  Rounding p to bf16 before P V
# moves an element by about 2^-8 of the row's output scale, and rounding
# the output by 2^-8 of itself.  The kernel's order reads 1.35 units at
# 2048 keys, and with its accumulator or scores kept in bf16 6.05 or 4.86
# (tests/test_torch_lm_kernels.py, _tensor_core_order and its faults); the
# serve case below repeats that control on the card.
ATTN_BF16_C = 3.0


def attention_gap(out, want):
    """max |out - want| / (2^-8 |want| + 2^-9 max |want| of its row)."""
    want = want.float()
    unit = (2 ** -8 * want.abs()
            + 2 ** -9 * want.abs().amax(-1, keepdim=True))
    return ((out.float() - want).abs() / unit).max().item()


# Scores that float32 cannot resolve.  MLA at the reference's init (stacked
# leaves of std 1/sqrt(3) and 1/sqrt(2), two projections deep) gives scores
# of ~1e5-1e6 on the serve path: each row's softmax is all but one-hot, and
# the float32 rounding of one score, ~(D + 2) 2^-24 of sum_d |q_d k_d|, can
# exceed the gap between a row's two best keys, so two float32 orders pick
# different keys there however right each is.  ``attention_float64_bound``
# gives, per element, how far any attention whose scores carry that rounding
# can be from the float64 attention on the same inputs; the MLA launches
# are held to float64 within it (``conditioned_gap``).
SCORE_ULPS = 2   # float32 roundings a score term: the tensor cores' adds truncate


def conditioned_attention_gaps(q, k, v, out, want, unit, *,
                               causal: bool = True, window: int = 0,
                               q_offset: int = 0, heads: int = 16) -> dict:
    """Hold ``out`` (the kernel's attention of q (B, Sq, Hq, D), k and v
    (B, Sk, Hkv, D)) and ``want`` (the plain version's) to o, the attention
    in float64 on the same values, element by element, allowing each
    element b: the most that an attention whose every score s_j is off by
    at most Delta_j = SCORE_ULPS (D + 2) 2^-24 scale sum_d |q_d k_jd| (a
    float32 dot product of D terms, the scale and the exponent's rounding)
    can differ from o.  With Delta* the row's largest Delta, |p'_j - p_j|
    <= min(1, p_j expm1(Delta_j + Delta*)), and as the p's sum to 1,
    |o'_d - o_d| <= the sum over j != j* (the row's best key) of that times
    (|v_jd| + |v_j*d|).  Rounding p or the output is not in b: ``unit``
    covers it, "bf16" for ``attention_gap``'s unit of o, or a number.

    Returns {"kernel": max (|out - o| - b) / unit, "plain": the same of
    want, "pair": max (|out - want| - 2 b) / unit (the two held to each
    other directly), "score_max": the largest |score|, "near_rows": rows
    that b lets move by more than 1e-3 of max |v| (their best key has a
    rival within the rounding), "rows"}.  Evaluated a batch row and
    ``heads`` q heads at a time, in float64 on the inputs' device."""
    import math

    import torch
    from repro_torch.kernels import ref
    B, Sq, Hq, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    f64 = torch.float64
    scale = 1.0 / math.sqrt(D)
    gamma = SCORE_ULPS * (D + 2) * 2.0 ** -24
    qpos = torch.arange(Sq, device=q.device) + q_offset
    band = ref._band(qpos, torch.arange(Sk, device=q.device), causal, window)
    vmax = v.abs().max().double().item()
    res = {"kernel": -math.inf, "plain": -math.inf, "pair": -math.inf,
           "score_max": 0.0, "near_rows": 0, "rows": B * Sq * Hq}
    for b in range(B):
        for h0 in range(0, Hq, heads):
            hq = torch.arange(h0, min(h0 + heads, Hq), device=q.device)
            hk = hq // (Hq // Hkv)
            qh = q[b][:, hq].to(f64).transpose(0, 1)           # (h, Sq, D)
            kh = k[b][:, hk].to(f64).transpose(0, 1)           # (h, Sk, D)
            vh = v[b][:, hk].to(f64).transpose(0, 1)
            s = (qh @ kh.transpose(1, 2)) * scale
            res["score_max"] = max(res["score_max"],
                                   s.masked_fill(~band, 0).abs().max().item())
            s.masked_fill_(~band, ref.NEG_INF)
            logp = torch.log_softmax(s, dim=-1)
            best = s.argmax(-1, keepdim=True)
            del s
            x = (qh.abs() @ kh.abs().transpose(1, 2)) * (scale * gamma)
            x.masked_fill_(~band, 0.0)
            x += x.amax(-1, keepdim=True)                      # Delta + Delta*
            # p expm1(x) = exp(log p + x + log1p(-exp(-x))), 0 at x = 0
            w = torch.exp(logp + x + torch.log1p(-torch.exp(-x)))
            del x
            w.clamp_(max=1.0).scatter_(-1, best, 0.0)
            vabs = vh.abs()
            vbest = torch.gather(vabs, 1, best.expand(-1, -1, D))
            bnd = w @ vabs + w.sum(-1, keepdim=True) * vbest
            del w
            o = logp.exp_() @ vh
            del logp
            u = attention_unit(o) if unit == "bf16" else unit
            got = out[b][:, hq].to(f64).transpose(0, 1)
            ref_ = want[b][:, hq].to(f64).transpose(0, 1)
            for key, diff, n in (("kernel", got - o, 1), ("plain", ref_ - o, 1),
                                 ("pair", got - ref_, 2)):
                res[key] = max(res[key], ((diff.abs() - n * bnd) / u)
                               .max().item())
            res["near_rows"] += int((bnd.amax(-1) > 1e-3 * vmax).sum())
    return res


def attention_unit(want):
    """``attention_gap``'s unit: 2^-8 |want| + 2^-9 max |want| of its row."""
    want = want.abs().double()
    return 2 ** -8 * want + 2 ** -9 * want.amax(-1, keepdim=True)


def _attention_order(q, k, v, keep: str):
    """The bf16 kernel's order of operations, causal, over 64-key tiles, in
    plain torch (Hq = Hkv, Sk a multiple of 64: the serve shape), with one
    of its float32 values kept in bf16 instead (``keep``: "o" the
    accumulator, "s" the scores): a kernel the bound must reject."""
    import math

    import torch
    qh, kh, vh = (t.float().transpose(1, 2) for t in (q, k, v))
    S = qh.shape[2]
    scale_log2 = qh.shape[3] ** -0.5 * math.log2(math.e)
    m = torch.full(qh.shape[:3], -1e30, device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros_like(qh)
    qpos = torch.arange(S, device=q.device)[:, None]
    for k0 in range(0, kh.shape[2], 64):
        s = qh @ kh[:, :, k0:k0 + 64].transpose(-1, -2)
        if keep == "s":
            s = s.bfloat16().float()
        kpos = torch.arange(k0, k0 + 64, device=q.device)[None, :]
        s = torch.where(kpos <= qpos, s * scale_log2, -1e30)
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp2(s - m_new[..., None])
        alpha = torch.exp2(m - m_new)
        l = alpha * l + p.sum(-1)
        acc = alpha[..., None] * acc + p.bfloat16().float() @ vh[:, :, k0:k0 + 64]
        if keep == "o":
            acc = acc.bfloat16().float()
        m = m_new
    return (acc / l[..., None]).transpose(1, 2).bfloat16()


def _attention_case(device, dtype, shape, causal: bool, window: int,
                    q_offset: int, label: str, library: bool,
                    controls: bool = False, padded: int | None = None) -> dict:
    """Hold ``flash_attention`` to its plain version on random q, k, v of
    ``shape`` = (B, Sq, Sk, Hq, Hkv, D), and time both (and SDPA); with
    ``controls`` (bf16, the serve shape) show that the bf16 bound rejects
    the kernel's order with its accumulator or scores kept in bf16; with
    ``padded`` (bf16), hold the instance D picks to the wider instance
    ``padded`` on the same inputs (zero columns add exact zeros: equal bit
    for bit) and time it too.  The returned ``instance`` is the bf16
    kernel's instance that ran (None in float32)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa_mod
    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attention import flash_attention_cuda

    B, Sq, Sk, Hq, Hkv, D = shape
    g = torch.Generator(device=device).manual_seed(Sq + Sk + D)
    q = torch.randn((B, Sq, Hq, D), generator=g, device=device).to(dtype)
    k = torch.randn((B, Sk, Hkv, D), generator=g, device=device).to(dtype)
    v = torch.randn((B, Sk, Hkv, D), generator=g, device=device).to(dtype)
    kw = dict(causal=causal, window=window, q_offset=q_offset)

    out_k = flash_attention_cuda(q, k, v, **kw)
    torch.cuda.synchronize()
    instance = fa_mod.last_instance() if dtype == torch.bfloat16 else None
    pad_text = ""
    if padded is not None:
        out_w = flash_attention_cuda(q, k, v, instance=padded, **kw)
        torch.cuda.synchronize()
        check(fa_mod.last_instance() == padded and torch.equal(out_k, out_w),
              f"flash_attention {label}: the KD = {instance} instance differs "
              f"from the KD = {padded} instance on the same inputs by "
              f"{(out_k.float() - out_w.float()).abs().max().item():.3e}")
        del out_w
        padded_ms, _ = cuda_ms(lambda: flash_attention_cuda(
            q, k, v, instance=padded, **kw), iters=10, reps=5)
    out_p = ops.plain_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    # float32: the kernel keeps float32 p, and only the order of sums
    # differs from the plain version: 1e-4 of max |v|.  bf16: the kernel
    # rounds p to bf16 as the A operand of P V, as the plain version does
    # (the reference oracle's probs.astype(v.dtype)); what is left is the
    # order of sums, the exp2f with the scale folded in and the output's
    # rounding to bf16, within 2^-6 of max |v|, and element by element
    # within ATTN_BF16_C of attention_gap's unit against the plain route in
    # float32 on the same inputs.
    err = (out_k.float() - out_p.float()).abs().max().item()
    tol = (2 ** -6 if dtype == torch.bfloat16 else 1e-4) * v.abs().max().item()
    check(err <= tol, f"flash_attention {label} {dtype} disagrees with its "
          f"plain version: max abs err {err:.3e} > {tol:.3e}")
    gap_text = ""
    if dtype == torch.bfloat16:
        want = ops.plain_attention(q.float(), k.float(), v.float(), **kw)
        gap = attention_gap(out_k, want)
        check(gap <= ATTN_BF16_C, f"flash_attention {label} bf16 is "
              f"{gap:.3f} units from the float32 plain route (> {ATTN_BF16_C})")
        gap_text = f"; gap to float32 plain {gap:.3f} units (gate {ATTN_BF16_C})"
        if controls:   # the bound's power: the same order with a bf16 O or S
            for keep in ("o", "s"):
                c = attention_gap(_attention_order(q, k, v, keep), want)
                check(c > ATTN_BF16_C, f"the bf16 attention bound passes a "
                      f"kernel that keeps {keep} in bf16 ({c:.3f} units)")
                gap_text += f", with {keep.upper()} kept in bf16 {c:.3f}"
        del want
    del out_k, out_p

    ms, call_ms = cuda_ms(lambda: flash_attention_cuda(q, k, v, **kw),
                          iters=10, reps=5)
    plain_ms, _ = cuda_ms(lambda: ops.plain_attention(q, k, v, **kw),
                          iters=5, reps=2)
    library_ms = None
    if library:   # the same function as one PyTorch call, timed only here
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        gqa = {"enable_gqa": True} if Hq != Hkv else {}
        library_ms, _ = cuda_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, **gqa), iters=10, reps=5)
    n_bytes = q.element_size() * (2 * q.numel() + 2 * k.numel())
    n_flops = 4 * D * _valid_pairs(Sq, Sk, causal, window, q_offset) * B * Hq
    peak = PEAK_BF16_FLOP_PER_S if dtype == torch.bfloat16 else PEAK_F32_FLOP_PER_S
    bound_ms, bound_by = bound(n_bytes, n_flops, peak)
    lib = "none" if library_ms is None else f"{library_ms:.4f}"
    # the dtype picks the kernel (csrc/flash_attention.cu's dispatch)
    route = (f"tensor-core bf16 kernel, KD = {instance}"
             if dtype == torch.bfloat16 else "CUDA-core f32 kernel")
    if padded is not None:
        pad_text = (f" KD = {padded} instance on the same inputs: equal bit "
                    f"for bit, kernel_ms={padded_ms:.4f} "
                    f"({n_flops / padded_ms * 1e-9:.1f} TFLOP/s of the same "
                    f"useful work);")
    print(f"[kernels] flash_attention {label} {str(dtype)[6:]} ({route}) "
          f"B={B} Sq={Sq} "
          f"Sk={Sk} Hq={Hq} Hkv={Hkv} D={D} causal={causal} window={window} "
          f"q_offset={q_offset}: max_abs_err={err:.3e} (tol {tol:.3e})"
          f"{gap_text}; "
          f"kernel_ms={ms:.4f} ({n_flops / ms * 1e-9:.1f} TFLOP/s) "
          f"plain_ms={plain_ms:.4f} bound_ms={bound_ms:.4f} "
          f"({bound_by}, {n_flops:.3e} flop, {n_bytes:.3e} B) sdpa_ms={lib};"
          f"{pad_text} per eager call kernel {call_ms:.4f} ms")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms, "instance": instance}


def bf16_instance(D: int) -> int:
    """The bf16 ``flash_attention`` instance that head width D takes: the
    narrowest of the compiled widths that holds it."""
    from repro_torch.kernels.flash_attention import BF16_INSTANCES
    return min(kd for kd in BF16_INSTANCES if 16 * kd >= D)


def phase_kernel_flash_attention(device) -> dict:
    """At the serve path's shape (zamba2-7b prefill: causal, D = 112) and at
    a GQA + window + q_offset case with ragged Sq and Sk, in bf16 and f32;
    in bf16 also at the prefill shapes of the dense, MoE, audio and
    vision-language serve phases (minitron-4b's 24 heads over 8 kv heads of
    128, mixtral-8x22b's 48 over 8, musicgen-large's 32 heads of 64 on the
    KD = 4 instance, qwen2-vl-2b's 12 over 2 of 128 and a rank's 6 over 1
    of them at ``model`` = 2, phase 17's, causal) and of MLA
    (deepseek-v3-671b's 128 heads at q-k width 192, causal: the KD = 12
    instance, held to the padded KD = 16 one and timed beside it), and at
    phase 17's MoE shapes a rank (mixtral-8x22b's 24 over 4, MLA's 64
    heads), each gated to the instance its D takes, reported and not gated
    on time.  The row reported is the zamba2 serve shape in bf16, the
    path's dtype."""
    import torch
    serve_shape = (SERVE_BATCH, SERVE_PROMPT, SERVE_PROMPT, 32, 32, 112)
    row = None
    for dtype in (torch.bfloat16, torch.float32):
        r = _attention_case(device, dtype, serve_shape, True, 0, 0,
                            "serve shape", library=True,
                            controls=dtype == torch.bfloat16)
        row = row or r
        _attention_case(device, dtype, (2, 1000, 1500, 24, 8, 128), True,
                        256, 500, "GQA+window+offset, ragged", library=False)
    for (hq, hkv, d), label, padded in (
            ((24, 8, 128), "dense GQA shape (minitron-4b)", None),
            ((48, 8, 128), "MoE GQA shape (mixtral-8x22b)", None),
            ((32, 32, 64), "audio shape (musicgen-large)", None),
            ((12, 2, 128), "VLM GQA shape (qwen2-vl-2b)", None),
            ((6, 1, 128), "VLM GQA shape, a rank's heads at model = 2 "
             "(qwen2-vl-2b, phase 17)", None),
            ((16, 16, 112), "hybrid shared block, a rank's heads at "
             "model = 2 (zamba2-7b, phase 17)", None),
            ((24, 4, 128), "MoE GQA shape, a rank's heads at model = 2 "
             "(mixtral-8x22b, phase 17)", None),
            ((64, 64, 192), "MLA shape, a rank's heads at model = 2 "
             "(deepseek-v3-671b, phase 17)", None),
            ((128, 128, 192), "MLA shape (deepseek-v3-671b)", 16)):
        r = _attention_case(device, torch.bfloat16,
                            (SERVE_BATCH, SERVE_PROMPT, SERVE_PROMPT, hq, hkv,
                             d), True, 0, 0, label, library=True,
                            padded=padded)
        check(r["instance"] == bf16_instance(d), f"D = {d} ran the KD = "
              f"{r['instance']} instance of flash_attention, not KD = "
              f"{bf16_instance(d)}")
    torch.cuda.empty_cache()
    row.pop("instance")
    return {"name": "flash_attention", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention.py:96", **row}


# The split-KV decode kernel against the plain attention in float64 on the
# same inputs (``decode_gap``): element by element, |o - o64| beyond o's own
# rounding (half a unit in its last place, for a bf16 o) in units of 2^-24
# (T + U) (``decode_unit``): T = sum_j p_j |v_j| the size of the terms that
# P V sums, U = sum_j p_j A_j (|v_j| + |o|) what a float32 rounding of each
# score by 2^-24 A_j, A_j = sum_d |q_d k_jd| / sqrt(D), moves o by to first
# order.  Any float32 route errs by a fraction of such units: the plain
# route too, which the serve phases hold to the same gate.  On the serve
# paths' activations the scores are large and U is most of the unit: there
# the kernel read up to 1.3 units over phases 9-12's launches and the plain
# route 4.2, where a unit of 2^-24 T alone read up to 2,016 and 3,837 (on
# an H100).  p or s rounded to bf16 moves o by 2^-9 of its terms over
# sqrt(the keys that weigh): at minitron-4b's decode shape on random
# inputs the kernel reads 0.03 units on the card and its order 0.02-0.42
# on the CPU, with p in bf16 588 on the card and 458-919 on the CPU, with
# s in bf16 3,261 and 1,532-4,474 (``_decode_order``'s controls, which
# the kernel phase repeats on the card and which must fail the gate).
DECODE_GAP_C = 32.0
# (label, B, L, Hq, Hkv, D, valid slots): the serve paths' GQA decode
# shapes (phases 7 and 9-12 and the benchmark's decode pool)
DECODE_CASES = (
    ("minitron-4b's decode pool", 64, 3076, 24, 8, 128, 2150),
    ("zamba2-7b's shared block", 8, 4096, 32, 32, 112, 3000),
    ("qwen2-vl-2b", 8, 4096, 12, 2, 128, 3000),
    ("musicgen-large, every slot", 8, 2048, 32, 32, 64, 2048),
    ("mixtral-8x22b's sliding-window ring, full", 4, 4096, 48, 8, 128, 4096),
)


def decode_unit(q, k, v, n_valid: int, o):
    """``decode_gap``'s unit over 2^-24, T + U, (B, 1, Hq, D) in float64,
    for q (B, 1, Hq, D), caches (B, L, Hkv, D), the slots [0, n_valid) and
    o the float64 attention: T = sum_j p_j |v_j|, U = sum_j p_j A_j (|v_j|
    + |o|), A_j = sum_d |q_d k_jd| / sqrt(D)."""
    import torch
    from repro_torch.kernels import ref
    B, _, Hq, D = q.shape
    L, Hkv = k.shape[1], k.shape[2]
    f64 = torch.float64
    qh = q.to(f64).reshape(B, Hkv, Hq // Hkv, D)
    kh = k.to(f64).transpose(1, 2)                      # (B, Hkv, L, D)
    s = qh @ kh.transpose(-1, -2) / math.sqrt(D)        # (B, Hkv, g, L)
    valid = torch.arange(L, device=q.device) < n_valid
    p = torch.softmax(torch.where(valid, s, ref.NEG_INF), dim=-1)
    pa = p * (qh.abs() @ kh.abs().transpose(-1, -2)) / math.sqrt(D)
    del s, kh
    vabs = v.to(f64).abs().transpose(1, 2)
    oh = o.reshape(B, Hkv, Hq // Hkv, D).abs()
    unit = p @ vabs + pa @ vabs + oh * pa.sum(-1, keepdim=True)
    return unit.reshape(B, 1, Hq, D)


def decode_float64(q, k, v, n_valid: int):
    """The plain decode attention (``ref.decode_attention_ref``) in float64
    over the slots [0, n_valid), and ``decode_unit`` for it."""
    import torch
    from repro_torch.kernels import ref
    f64 = torch.float64
    valid = torch.arange(k.shape[1], device=q.device)[None, :] < n_valid
    o = ref.decode_attention_ref(q.to(f64), k.to(f64), v.to(f64), valid,
                                 dtype=f64)
    return o, decode_unit(q, k, v, n_valid, o)


def decode_gap(got, want, unit) -> float:
    """The largest |got - want| over the output, less half a unit in got's
    last place where got is bf16, in units of 2^-24 ``unit``: ``want`` and
    ``unit`` are ``decode_float64``'s on got's inputs."""
    import torch
    g = got.to(torch.float64)
    err = (g - want).abs()
    if got.dtype == torch.bfloat16:     # 8 significant bits
        _, e = torch.frexp(g)
        half_ulp = torch.where(g == 0, 0.0, torch.ldexp(torch.ones_like(g),
                                                        e - 9))
        err = (err - half_ulp).clamp_min(0)
    return (err / (2.0 ** -24 * unit).clamp_min(1e-300)).max().item()


def _decode_order(q, k, v, n_valid: int, chunk: int,
                  rounded: str | None = None):
    """The split-KV decode kernel's arithmetic in plain torch, float32:
    per chunk of ``chunk`` keys of [0, n_valid), s = q k / sqrt(D), the
    chunk's max m, p = exp(s - m), l = sum p, o = p v; the chunks merged by
    log-sum-exp.  ``rounded`` "p" rounds p to bf16 where it meets v, "s"
    rounds s to bf16: the controls that ``DECODE_GAP_C`` must reject."""
    import torch
    B, _, Hq, D = q.shape
    Hkv = k.shape[2]
    f32 = torch.float32
    qh = q.to(f32).reshape(B, Hkv, Hq // Hkv, D)
    sqrt_d = torch.sqrt(torch.tensor(D, dtype=f32))
    ms, ls, os_ = [], [], []
    for c0 in range(0, n_valid, chunk):
        kc = k[:, c0:min(c0 + chunk, n_valid)].to(f32).transpose(1, 2)
        vc = v[:, c0:min(c0 + chunk, n_valid)].to(f32).transpose(1, 2)
        s = qh @ kc.transpose(-1, -2) / sqrt_d            # (B, Hkv, g, n_c)
        if rounded == "s":
            s = s.bfloat16().float()
        m = s.amax(-1)
        p = torch.exp(s - m[..., None])
        ms.append(m)
        ls.append(p.sum(-1))
        os_.append((p.bfloat16().float() if rounded == "p" else p) @ vc)
    m = torch.stack(ms)
    w = torch.exp(m - m.amax(0))
    o = ((w[..., None] * torch.stack(os_)).sum(0)
         / (w * torch.stack(ls)).sum(0)[..., None])
    return o.reshape(B, 1, Hq, D).to(q.dtype)


def _decode_case(device, dtype, case, controls: bool = False,
                 narrow: int | None = None) -> dict:
    """The split-KV kernel on random q and caches of ``case`` (see
    ``DECODE_CASES``) held to float64 (``decode_gap``), the plain route's
    reading beside it, both timed beside the least time the card could
    take: the valid keys and values read once.  With ``narrow``, the
    caches hold ``narrow`` times the kv heads and the kernel reads the
    first of them through a ``narrow``ed view, as a split rank does.  With
    ``controls``, the kernel's order with p and with s rounded to bf16
    must fail the gate."""
    import torch
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import ops
    label, B, L, Hq, Hkv, D, n = case
    g = torch.Generator(device=device).manual_seed(B + L + Hq + D + n)
    q = torch.randn((B, 1, Hq, D), generator=g, device=device).to(dtype)
    kv = [torch.randn((B, L, Hkv * (narrow or 1), D), generator=g,
                      device=device).to(dtype) for _ in range(2)]
    k, v = (t.narrow(2, 0, Hkv) for t in kv)
    n_valid = torch.tensor([n], dtype=torch.int32, device=device)
    valid = torch.arange(L, device=device)[None, :] < n
    out = da.decode_attention_cuda(q, k, v, n_valid)
    want = decode_float64(q, k, v, n)
    gap = decode_gap(out, *want)
    plain_gap = decode_gap(ops.decode_attention(q, k, v, valid), *want)
    check(gap <= DECODE_GAP_C, f"decode_attention {label} {dtype} is "
          f"{gap:.2f} units from float64 (> {DECODE_GAP_C})")
    chunk = da.split_chunk(B, L, Hkv, da._n_sm(device.index))
    text = ""
    if controls:
        for rounded in (None, "p", "s"):
            c = decode_gap(_decode_order(q, k, v, n, chunk, rounded), *want)
            check((c > DECODE_GAP_C) == (rounded is not None),
                  f"the decode gate reads the kernel's order with "
                  f"{rounded or 'nothing'} rounded to bf16 at {c:.2f} units")
            text += (f", its order in plain torch {c:.2f}" if rounded is None
                     else f", with {rounded} in bf16 {c:.1f}")
    del out, want
    ms, call_ms = cuda_ms(lambda: da.decode_attention_cuda(q, k, v, n_valid))
    plain_ms, _ = cuda_ms(lambda: ops.decode_attention(q, k, v, valid),
                          iters=5, reps=2)
    n_bytes = q.element_size() * (2 * B * n * Hkv * D + 2 * q.numel())
    n_flops = 4 * D * Hq * B * n
    bound_ms, bound_by = bound(n_bytes, n_flops)
    print(f"[kernels] decode_attention {label}"
          + (f" (a rank's view: {Hkv} of {Hkv * narrow} kv heads)"
             if narrow else "")
          + f" {str(dtype)[6:]} B={B} L={L} Hq={Hq} Hkv={Hkv} D={D} "
          f"n_valid={n}, chunk {chunk}: {gap:.2f} units from float64 (gate "
          f"{DECODE_GAP_C}; the plain route {plain_gap:.2f}{text}); "
          f"kernel_ms={ms:.4f} ({100 * bound_ms / ms:.1f}% of the bound) "
          f"plain_ms={plain_ms:.4f} bound_ms={bound_ms:.4f} ({bound_by}, "
          f"{n_flops:.3e} flop, {n_bytes:.3e} B); per eager call kernel "
          f"{call_ms:.4f} ms")
    del q, k, v, kv
    torch.cuda.empty_cache()
    return {"max_abs_err": gap, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None}


def phase_kernel_decode_attention(device) -> dict:
    """At the GQA decode shapes of the serve paths (``DECODE_CASES``) in
    bf16, minitron-4b's also in float32 and through a rank's ``narrow``ed
    view of half its kv heads (phase 17's), with the bf16 controls at
    minitron-4b's.  The kernel has no TPU counterpart: the reference leaves
    decode attention to XLA.  The row reported is minitron-4b's in bf16,
    the path's dtype."""
    import torch
    row = _decode_case(device, torch.bfloat16, DECODE_CASES[0], controls=True)
    _decode_case(device, torch.float32, DECODE_CASES[0])
    label, B, L, Hq, Hkv, D, n = DECODE_CASES[0]
    _decode_case(device, torch.bfloat16, (label, B, L, Hq // 2, Hkv // 2, D,
                                          n), narrow=2)
    for case in DECODE_CASES[1:]:
        _decode_case(device, torch.bfloat16, case)
    return {"name": "decode_attention", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/decode_attention.cu",
            "replaces": None, **row}


# The bf16 SSD kernel against the plain route in float32 on the same
# bf16-valued inputs, element by element: |y - want| <= SSD_BF16_C (2^-8
# |want| + 2^-9 max |want| over the head's P outputs at that position +
# 2^-20 mag), mag the plain SSD of |x|, |B|, |C| (ssd_magnitude).  The
# first two terms cover y's own rounding to bf16 (<= 1 unit).  The mag
# term covers errors in proportion to the terms of a sum, not to its
# result, which show where the terms cancel and leave a row of y far below
# them, as on the serve path's activations: the kernel takes G, S and w x
# as two bf16 halves (~2^-17 of each term lost), and float32 rounds C.B^T
# and the sums (~2^-24 of them), in the plain route too
# (_check_on_activations holds the kernel, its order in plain torch and
# the float32 route to y in float64 where they are farthest apart).  The
# kernel's order read 0.44-0.66 units over the CPU cases, and with
# O kept in bf16 8.12 where many keys reach each output
# (tests/test_torch_lm_kernels.py, _ssd_tensor_core_order and its faults);
# the slow-decay case below repeats that control on the card.  Like the
# other SSD bounds, the gate adds the decays' float32 sensitivity
# (ssd_rel_tol), here in units of 2^-8 |want|.
SSD_BF16_C = 2.0
# dt's range in the random cases, and in the slow-decay case, where dt * A
# stays below 2e-3 and a whole chunk of keys reaches each output
SSD_DT = (0.01, 0.2)
SSD_SLOW_DT = (1e-4, 1e-3)


def ssd_magnitude(x, dt, A, B, C, **kw):
    """The plain SSD of |x|, |B|, |C| (and |initial_state|): at each output,
    the sum of the magnitudes of its terms."""
    from repro_torch.kernels import ref
    s0 = kw.get("initial_state")
    return ref.ssd_chunked_ref(x.float().abs(), dt, A, B.float().abs(),
                               C.float().abs(), chunk=kw["chunk"],
                               initial_state=None if s0 is None else s0.abs())


def ssd_gap_units(y, want, mag):
    """|y - want| / (2^-8 |want| + 2^-9 max |want| of its P outputs +
    2^-20 mag), element by element (mag None: without the last term)."""
    want = want.float()
    unit = 2 ** -8 * want.abs() + 2 ** -9 * want.abs().amax(-1, keepdim=True)
    if mag is not None:
        unit = unit + 2 ** -20 * mag
    return (y.float() - want).abs() / unit


def ssd_gap(y, want, mag):
    """The largest of ``ssd_gap_units``."""
    return ssd_gap_units(y, want, mag).max().item()


def ssd_gap_gate(dt, A, chunk: int) -> float:
    return SSD_BF16_C + 2 ** 8 * ssd_rel_tol(dt, A, chunk, 0.0)


def _ssd_inputs(device, dtype, shape, init: bool, dt_range=SSD_DT):
    """Random x, dt (uniform in ``dt_range``), A, B, C and an initial state
    (or None) for ``shape`` = (B, L, H, P, N), seeded by L + H; x, B and C
    in ``dtype``."""
    import torch
    B, L, H, P, N = shape
    g = torch.Generator(device=device).manual_seed(L + H)
    x = torch.randn((B, L, H, P), generator=g, device=device).to(dtype)
    Bm = torch.randn((B, L, N), generator=g, device=device).to(dtype)
    Cm = torch.randn((B, L, N), generator=g, device=device).to(dtype)
    lo, hi = dt_range
    dt = torch.rand((B, L, H), generator=g, device=device) * (hi - lo) + lo
    A = -(torch.rand((H,), generator=g, device=device) * 1.5 + 0.5)
    s0 = (torch.randn((B, H, P, N), generator=g, device=device) if init
          else None)
    return x, dt, A, Bm, Cm, s0


def _ssd_order(x, dt, A, Bm, Cm, *, chunk, initial_state=None,
               o_bf16: bool = False):
    """The bf16 kernel's order of operations in plain torch: 64-row query
    sub-blocks; C.B^T in float32; G, the entering state and each update
    term w x as two bf16 halves; y rounded to bf16.  With ``o_bf16`` its
    float32 accumulator O is kept in bf16 instead, rounded after the inter
    term and after every 16 keys (an mma's depth): a kernel that
    ``ssd_gap`` must reject.  Returns y."""
    import torch
    Bsz, L, H, P = x.shape
    dev = x.device
    xh = x.float().permute(0, 2, 1, 3)                  # (B, H, L, P)
    dth = dt.float().permute(0, 2, 1)                   # (B, H, L)
    Bf, Cf = Bm.float()[:, None], Cm.float()[:, None]   # (B, 1, L, N)
    S = (torch.zeros((Bsz, H, P, Bm.shape[-1]), device=dev)
         if initial_state is None else initial_state.float().clone())
    y = torch.empty((Bsz, H, L, P), device=dev)
    bk = 16 if o_bf16 else 64

    def halves(v):
        hi = v.bfloat16().float()
        return hi, (v - hi).bfloat16().float()

    def o_round(v):
        return v.bfloat16().float() if o_bf16 else v
    for t0 in range(0, L, chunk):
        Lc = min(chunk, L - t0)
        d = dth[..., t0:t0 + Lc]
        cum = torch.cumsum(d * A.float()[None, :, None], -1)
        s_hi, s_lo = halves(S)
        for q0 in range(0, Lc, 64):
            q1 = min(q0 + 64, Lc)
            Cq = Cf[:, :, t0 + q0:t0 + q1]
            acc = o_round((Cq @ s_hi.transpose(-1, -2)
                           + Cq @ s_lo.transpose(-1, -2))
                          * torch.exp(cum[..., q0:q1])[..., None])
            qpos = torch.arange(q0, q1, device=dev)[:, None]
            for k0 in range(0, q1, bk):
                k1 = min(k0 + bk, Lc)
                s = Cq @ Bf[:, :, t0 + k0:t0 + k1].transpose(-1, -2)
                seen = torch.arange(k0, k1, device=dev)[None, :] <= qpos
                dec = cum[..., q0:q1, None] - cum[..., None, k0:k1]
                G = torch.where(seen, s * torch.exp(torch.where(seen, dec, 0.0))
                                * d[..., None, k0:k1], 0.0)
                g_hi, g_lo = halves(G)
                xk = xh[..., t0 + k0:t0 + k1, :]
                acc = o_round(acc + (g_hi @ xk + g_lo @ xk))
            y[..., t0 + q0:t0 + q1, :] = acc
        w = torch.exp(cum[..., -1:] - cum) * d
        hi, lo = halves(w[..., None] * xh[..., t0:t0 + Lc, :])
        Bk = Bf[:, :, t0:t0 + Lc]
        S = (S * torch.exp(cum[..., -1])[..., None, None]
             + (hi.transpose(-1, -2) @ Bk + lo.transpose(-1, -2) @ Bk))
    return y.permute(0, 2, 1, 3).bfloat16()


def _ssd_float64(x, dt, A, Bm, Cm, chunk: int):
    """y of one batch row and one head in float64, from zero state: x
    (L, P), dt (L,), A a number, B and C (L, N); each chunk's weights in
    full, exp only where k <= q."""
    import torch
    x, dt, Bm, Cm = (t.double() for t in (x, dt, Bm, Cm))
    L, P = x.shape
    S = torch.zeros((P, Bm.shape[-1]), dtype=torch.float64, device=x.device)
    y = torch.empty_like(x)
    for t0 in range(0, L, chunk):
        sl = slice(t0, min(t0 + chunk, L))
        d = dt[sl]
        cum = torch.cumsum(d * float(A), 0)
        seen = torch.ones((len(d), len(d)), dtype=torch.bool,
                          device=x.device).tril()
        dec = torch.where(seen, cum[:, None] - cum[None, :], float("-inf"))
        G = (Cm[sl] @ Bm[sl].T) * dec.exp() * d[None, :]
        y[sl] = G @ x[sl] + cum.exp()[:, None] * (Cm[sl] @ S.T)
        w = (cum[-1] - cum).exp() * d
        S = cum[-1].exp() * S + (w[:, None] * x[sl]).T @ Bm[sl]
    return y


def _ssd_held(label: str, y, s, inputs, kw) -> tuple[float, str]:
    """Hold one ``ssd_scan`` result (y and the final state s) to the plain
    version on the same inputs and, in bf16, to the plain route in float32
    element by element (``ssd_gap``); fails the run on a miss.  Returns y's
    max abs error and a text of the errors and their bounds."""
    import torch
    from repro_torch.kernels import ref
    x, dt, A, Bm, Cm, _ = inputs
    chunk = kw["chunk"]
    y_p, s_p = ref.ssd_chunked_ref(x, dt, A, Bm, Cm, **kw)
    # Both accumulate in float32, in another order; the output is rounded to
    # x's dtype (bf16: 2^-9 relative, bounded here at 2^-6 of the scale;
    # float32: 1e-4).  The final state is float32 in both: 1e-4 of its
    # scale.  Each bound adds the decays' float32 sensitivity (ssd_rel_tol).
    err = (y.float() - y_p.float()).abs().max().item()
    base = 2 ** -6 if x.dtype == torch.bfloat16 else 1e-4
    tol = ssd_rel_tol(dt, A, chunk, base) * y_p.float().abs().max().item()
    err_s = (s - s_p).abs().max().item()
    tol_s = ssd_rel_tol(dt, A, chunk, 1e-4) * s_p.abs().max().item()
    del y_p, s_p
    check(err <= tol and err_s <= tol_s,
          f"ssd_scan {label} {x.dtype} disagrees with its plain version: y err "
          f"{err:.3e} (tol {tol:.3e}), state err {err_s:.3e} (tol {tol_s:.3e})")
    text = (f"max_abs_err(y)={err:.3e} (tol {tol:.3e}) max_abs_err(state)="
            f"{err_s:.3e} (tol {tol_s:.3e})")
    if x.dtype == torch.bfloat16:
        want = ref.ssd_chunked_ref(x.float(), dt, A, Bm.float(), Cm.float(),
                                   **kw)[0]
        gap = ssd_gap(y, want, ssd_magnitude(x, dt, A, Bm, Cm, **kw))
        gate = ssd_gap_gate(dt, A, chunk)
        del want
        check(gap <= gate, f"ssd_scan {label} bf16 is {gap:.3f} units "
              f"from the float32 plain route (> {gate:.3f})")
        text += f"; gap to float32 plain {gap:.3f} units (gate {gate:.3f})"
    return err, text


def _ssd_case(device, dtype, shape, chunk: int, init: bool, label: str,
              dt_range=SSD_DT, control: bool = False) -> dict:
    """Hold ``ssd_scan`` to its plain version on random inputs of
    ``shape`` = (B, L, H, P, N) (final state included; ``_ssd_held``), and
    time both; in bf16 also time the float32 kernel on the same bf16-valued
    inputs.  With ``control`` (bf16) show that ``ssd_gap``'s gate rejects
    the kernel's order with its accumulator kept in bf16."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.ssm_scan import ssd_scan_cuda

    B, L, H, P, N = shape
    inputs = _ssd_inputs(device, dtype, shape, init, dt_range)
    x, dt, A, Bm, Cm, s0 = inputs
    kw = dict(chunk=chunk, initial_state=s0, return_state=True)

    y_k, s_k = ssd_scan_cuda(x, dt, A, Bm, Cm, **kw)
    torch.cuda.synchronize()
    err, err_text = _ssd_held(label, y_k, s_k, inputs, kw)
    del y_k, s_k
    if control:   # the gate's power: the same order with a bf16 O
        kw2 = dict(chunk=chunk, initial_state=s0)
        want = ref.ssd_chunked_ref(x.float(), dt, A, Bm.float(), Cm.float(),
                                   **kw2)
        c = ssd_gap(_ssd_order(x, dt, A, Bm, Cm, o_bf16=True, **kw2), want,
                    ssd_magnitude(x, dt, A, Bm, Cm, **kw2))
        gate = ssd_gap_gate(dt, A, chunk)
        del want
        check(c > gate, f"ssd_scan {label}: the bf16 SSD gate passes a "
              f"kernel that keeps O in bf16 ({c:.3f} units, gate {gate:.3f})")
        err_text += f", with O kept in bf16 {c:.3f}"
    if dtype == torch.bfloat16:
        x32, B32, C32 = x.float(), Bm.float(), Cm.float()
        f32_ms, _ = cuda_ms(lambda: ssd_scan_cuda(x32, dt, A, B32, C32, **kw),
                            iters=10, reps=5)
        del x32, B32, C32
        err_text += (f"; the float32 kernel on the same bf16-valued inputs "
                     f"{f32_ms:.4f} ms")

    ms, call_ms = cuda_ms(lambda: ssd_scan_cuda(x, dt, A, Bm, Cm, **kw),
                          iters=10, reps=5)
    plain_ms, _ = cuda_ms(lambda: ref.ssd_chunked_ref(x, dt, A, Bm, Cm, **kw),
                          iters=5, reps=2)
    lens = [min(chunk, L - t0) for t0 in range(0, L, chunk)]
    n_flops = B * sum(2 * q * q * N // 2 + H * (2 * q * q * P // 2
                                                + 4 * q * P * N)
                      for q in lens)
    n_bytes = (x.element_size() * 2 * x.numel()
               + Bm.element_size() * 2 * Bm.numel() + 4 * dt.numel()
               + 4 * A.numel() + 4 * B * H * P * N * (2 if init else 1))
    peak = PEAK_BF16_FLOP_PER_S if dtype == torch.bfloat16 else PEAK_F32_FLOP_PER_S
    bound_ms, bound_by = bound(n_bytes, n_flops, peak)
    # the dtype picks the kernel (csrc/ssd_scan.cu's dispatch)
    route = "tensor-core bf16" if dtype == torch.bfloat16 else "CUDA-core f32"
    print(f"[kernels] ssd_scan {label} {str(dtype)[6:]} ({route} kernel) "
          f"B={B} L={L} H={H} "
          f"P={P} N={N} chunk={chunk} initial_state={init} dt in "
          f"[{dt_range[0]:g}, {dt_range[1]:g}]: "
          f"{err_text}; kernel_ms={ms:.4f} "
          f"({n_flops / ms * 1e-9:.1f} TFLOP/s) "
          f"plain_ms={plain_ms:.4f} bound_ms={bound_ms:.4f} ({bound_by}, "
          f"{n_flops:.3e} flop, {n_bytes:.3e} B); per eager call kernel "
          f"{call_ms:.4f} ms; library_ms: none (no one PyTorch call runs the "
          f"SSD scan)")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None}


def ssd_rel_tol(dt, A, chunk: int, base: float) -> float:
    """Relative tolerance of the SSD scan: ``base`` for the order of sums,
    plus the float32 sensitivity of its decays.  Both versions take exp of
    differences of within-chunk cumsums of dt * A; a cumsum of 256 terms
    carries an absolute rounding of ~16 ulps of its magnitude, so a decay
    exp(cum_q - cum_k) is known to ~2^-18 |cum| relative (the serve path's
    dt reaches ~20, so |cum| reaches hundreds; random test inputs stay
    below 100)."""
    import torch
    import torch.nn.functional as F
    B, L, H = dt.shape
    pad = (-L) % chunk
    dA = F.pad(dt.float() * A.float(), (0, 0, 0, pad))
    cum = torch.cumsum(dA.reshape(B, -1, chunk, H), dim=2)
    return base + 2.0 ** -18 * cum.abs().max().item()


def phase_kernel_ssd_scan(device) -> dict:
    """At the serve path's shape (zamba2-7b prefill: H = 112, P = N = 64,
    chunk 256, final state) and at a ragged L = 2000 with a non-zero initial
    state, in bf16 and f32; in bf16 also at slow decays, with the bf16-O
    control, the serve shape over the batch, and a rank's 56 heads at
    ``model`` = 2 (phase 17's).  The row reported is the serve shape in
    bf16."""
    import torch
    from repro_torch.kernels.ssm_scan import ssd_scan_cuda
    serve_shape = (SERVE_BATCH, SERVE_PROMPT, 112, 64, 64)
    row = None
    for dtype in (torch.bfloat16, torch.float32):
        r = _ssd_case(device, dtype, serve_shape, 256, False, "serve shape")
        row = row or r
        _ssd_case(device, dtype, (2, 2000, 112, 64, 64), 256, True,
                  "ragged L, initial state")
    _ssd_case(device, torch.bfloat16, (2, SERVE_PROMPT, 112, 64, 64), 256,
              True, "slow decays, initial state", SSD_SLOW_DT, control=True)
    _ssd_case(device, torch.bfloat16,
              (SERVE_BATCH, SERVE_PROMPT, 112 // TP_RANKS, 64, 64), 256,
              False, f"a rank's heads at model = {TP_RANKS} (zamba2-7b, "
              f"phase 17)")
    # B = 1 puts one block on each of 112 SMs, so its time is one block's
    # chain of steps; B = 3 fills the card's 3 x 132 block slots once, and
    # B = 8 needs 2.26 such waves
    x, dt, A, Bm, Cm, _ = _ssd_inputs(device, torch.bfloat16, serve_shape,
                                      False)
    sweep = []
    for b in (1, 2, 3, 4):
        xb, dtb, Bb, Cb = (t[:b].contiguous() for t in (x, dt, Bm, Cm))
        ms, _ = cuda_ms(lambda: ssd_scan_cuda(xb, dtb, A, Bb, Cb, chunk=256,
                                              return_state=True),
                        iters=10, reps=5)
        sweep.append(f"B={b} {ms:.4f} ms")
    print(f"[kernels] ssd_scan serve shape bfloat16 over the batch: "
          f"{', '.join(sweep)} (B={SERVE_BATCH}: above)")
    del x, dt, Bm, Cm
    torch.cuda.empty_cache()
    return {"name": "ssd_scan", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/ssd_scan.cu",
            "replaces": "src/repro/kernels/ssm_scan.py:86", **row}


def rwkv6_rel_tol(w, chunk: int, base: float) -> float:
    """Relative tolerance of the WKV scan: ``base`` for the order of sums,
    plus the float32 sensitivity of its decays.  Both versions take exp of
    differences of within-chunk cumsums of w (|w| <= 4: |wcum| <= 64 at
    chunk 16), each cumsum known to ~8 ulps of its magnitude: 2^-20 |wcum|
    relative on a decay."""
    import torch
    import torch.nn.functional as F
    B, L, H, K = w.shape
    wp = F.pad(w.float(), (0, 0, 0, 0, 0, (-L) % chunk))
    cum = torch.cumsum(wp.reshape(B, -1, chunk, H, K), dim=2)
    return base + 2.0 ** -20 * cum.abs().max().item()


def _rwkv6_inputs(device, dtype, shape, chunk: int, init: bool):
    """r, k, v (B, L, H, K) in ``dtype`` (V = K), w float32 with the model's
    range of decays, u and, with ``init``, an initial state; seeded by the
    shape and the chunk."""
    import torch
    B, L, H, K = shape
    g = torch.Generator(device=device).manual_seed(L + H + chunk)
    r, k, v = (torch.randn((B, L, H, K), generator=g, device=device).to(dtype)
               for _ in range(3))
    # the model's decays: -exp(lora) clamped to [-rwkv_w_clamp, -1e-4]
    w = torch.clamp(-torch.exp(1.5 * torch.randn((B, L, H, K), generator=g,
                                                 device=device)), -4.0, -1e-4)
    u = (0.5 * torch.randn((H, K), generator=g, device=device)).to(dtype)
    s0 = (torch.randn((B, H, K, K), generator=g, device=device) if init
          else None)
    return r, k, v, w, u, s0


def _rwkv6_case(device, dtype, shape, chunk: int, init: bool, label: str
                ) -> dict:
    """Hold ``rwkv6`` to its plain version on random inputs of ``shape`` =
    (B, L, H, K) (V = K; final state included), with the model's range of
    decays, and time both."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.rwkv6 import rwkv6_cuda

    B, L, H, K = shape
    r, k, v, w, u, s0 = _rwkv6_inputs(device, dtype, shape, chunk, init)
    kw = dict(chunk=chunk, initial_state=s0, return_state=True)

    y_k, s_k = rwkv6_cuda(r, k, v, w, u, **kw)
    torch.cuda.synchronize()
    y_p, s_p = ref.rwkv6_chunked_ref(r, k, v, w, u, **kw)
    torch.cuda.synchronize()
    # Both accumulate in float32, in another order, the kernel with each
    # pair's decay taken directly and the plain version with it split
    # across the operands; y is rounded to r's dtype (bf16: 2^-9 relative,
    # bounded here at 2^-6 of the scale; float32: 1e-4).  The final state
    # is float32 in both: 1e-4 of its scale.  Each bound adds the decays'
    # float32 sensitivity (rwkv6_rel_tol).
    err = (y_k.float() - y_p.float()).abs().max().item()
    base = 2 ** -6 if dtype == torch.bfloat16 else 1e-4
    tol = rwkv6_rel_tol(w, chunk, base) * y_p.float().abs().max().item()
    err_s = (s_k - s_p).abs().max().item()
    tol_s = rwkv6_rel_tol(w, chunk, 1e-4) * s_p.abs().max().item()
    check(err <= tol and err_s <= tol_s,
          f"rwkv6 {label} {dtype} disagrees with its plain version: y err "
          f"{err:.3e} (tol {tol:.3e}), state err {err_s:.3e} (tol {tol_s:.3e})")
    del y_k, s_k, y_p, s_p

    ms, call_ms = cuda_ms(lambda: rwkv6_cuda(r, k, v, w, u, **kw),
                          iters=10, reps=5)
    plain_ms, _ = cuda_ms(lambda: ref.rwkv6_chunked_ref(r, k, v, w, u, **kw),
                          iters=5, reps=2)
    # what the kernel's arithmetic needs: per chunk of q live rows, the
    # q(q-1)/2 pairs' weights (2K, plus K exps) and their product with v
    # (2V); per row the bonus (3K + 2V), the inter product (2KV) and the
    # state update (2KV); per chunk the state's decay (KV)
    lens = [min(chunk, L - t0) for t0 in range(0, L, chunk)]
    n_flops = B * H * sum(q * (q - 1) // 2 * (3 * K + 2 * K)
                          + q * (3 * K + 2 * K + 4 * K * K) + K * K
                          for q in lens)
    n_bytes = (r.element_size() * 4 * r.numel() + 4 * w.numel()
               + u.element_size() * u.numel()
               + 4 * B * H * K * K * (2 if init else 1))
    bound_ms, bound_by = bound(n_bytes, n_flops)
    print(f"[kernels] rwkv6 {label} {str(dtype)[6:]} B={B} L={L} H={H} K=V={K} "
          f"chunk={chunk} initial_state={init}: max_abs_err(y)={err:.3e} "
          f"(tol {tol:.3e}) max_abs_err(state)={err_s:.3e} (tol {tol_s:.3e}); "
          f"kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} bound_ms={bound_ms:.4f} "
          f"({bound_by}, {n_flops:.3e} f32 flop, {n_bytes:.3e} B); per eager "
          f"call kernel {call_ms:.4f} ms; library_ms: none (no one PyTorch "
          f"call runs the WKV scan)")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None}


def phase_kernel_rwkv6(device) -> dict:
    """At the serve path's prefill shape (rwkv6-1.6b: B = 8, L = 2048,
    H = 32, K = V = 64, chunk 16, from a zero state), at its decode shape
    (L = 1, chunk 1, from a carried state) and at a ragged L = 2000 with an
    initial state, final state held in each, in bf16 and f32, and a rank's
    16 heads of the prefill at ``model`` = 2 (phase 17's) in bf16; the row
    reported is the prefill shape in bf16, the path's dtype; then the
    prefill shape in bf16 over B = 1, 2, 4, 8.  The WKV arithmetic is
    float32 whatever the inputs' dtype, so the bound takes the float32
    peak."""
    import torch
    row = None
    for dtype in (torch.bfloat16, torch.float32):
        r = _rwkv6_case(device, dtype, (SERVE_BATCH, SERVE_PROMPT, 32, 64), 16,
                        False, "prefill shape")
        row = row or r
        _rwkv6_case(device, dtype, (SERVE_BATCH, 1, 32, 64), 1, True,
                    "decode shape")
        _rwkv6_case(device, dtype, (2, 2000, 32, 64), 16, True,
                    "ragged L, initial state")
    _rwkv6_case(device, torch.bfloat16,
                (SERVE_BATCH, SERVE_PROMPT, 32 // TP_RANKS, 64), 16, False,
                f"a rank's heads at model = {TP_RANKS} (rwkv6-1.6b, phase 17)")
    # One block walks one (batch, head)'s 128 chunks in order: B = 1-4 put
    # one block on each of 32-128 SMs, so their time is one block's chain;
    # B = 8 puts two blocks on most SMs
    from repro_torch.kernels.rwkv6 import rwkv6_cuda
    serve_shape = (SERVE_BATCH, SERVE_PROMPT, 32, 64)
    r, k, v, w, u, _ = _rwkv6_inputs(device, torch.bfloat16, serve_shape, 16,
                                     False)
    sweep = []
    for b in (1, 2, 4, 8):
        rb, kb, vb, wb = (t[:b].contiguous() for t in (r, k, v, w))
        ms, _ = cuda_ms(lambda: rwkv6_cuda(rb, kb, vb, wb, u, chunk=16,
                                           return_state=True),
                        iters=10, reps=5)
        sweep.append(f"B={b} {ms:.4f} ms")
    print(f"[kernels] rwkv6 prefill shape bfloat16 over the batch: "
          f"{', '.join(sweep)}")
    del r, k, v, w
    torch.cuda.empty_cache()
    return {"name": "rwkv6", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/rwkv6.cu",
            "replaces": "src/repro/kernels/rwkv6.py:79", **row}


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


def _swapped_ops(flash_attention, ssd_scan, rwkv6_scan,
                 decode_attention_prefix=None):
    """Context: ``ops.flash_attention``, ``ops.ssd_scan``,
    ``ops.rwkv6_scan`` and (unless None) ``ops.decode_attention_prefix``
    replaced by the given functions.  The models look them up in ``ops``
    at each call."""
    import contextlib
    from repro_torch.kernels import ops
    names = ("flash_attention", "ssd_scan", "rwkv6_scan",
             "decode_attention_prefix")
    new = dict(zip(names, (flash_attention, ssd_scan, rwkv6_scan,
                           decode_attention_prefix)))
    new = {name: fn for name, fn in new.items() if fn is not None}

    @contextlib.contextmanager
    def swapped():
        saved = {name: getattr(ops, name) for name in new}
        for name, fn in new.items():
            setattr(ops, name, fn)
        try:
            yield
        finally:
            for name, fn in saved.items():
                setattr(ops, name, fn)
    return swapped()


def _ssd_f64(x, dt, A, B, C):
    """The SSD recurrence token by token in float64 from zero state
    (``ref.ssd_sequential_ref``'s steps): a witness of the exact result,
    against which a float32 order's error is measured."""
    import torch
    x, dt, A, B, C = (t.double() for t in (x, dt, A, B, C))
    s = x.new_zeros(x.shape[:1] + x.shape[2:] + B.shape[-1:])  # (B,H,P,N)
    ys = []
    for t in range(x.shape[1]):
        s = (s * torch.exp(dt[:, t] * A)[..., None, None]
             + (dt[:, t, :, None] * x[:, t])[..., None] * B[:, t, None, None])
        ys.append(torch.einsum("bhpn,bn->bhp", s, C[:, t]))
    return torch.stack(ys, dim=1)


def _checked_kernels(errors: list, worst_ssd: dict, conditioned: dict | None
                     = None, witness: list | None = None):
    """Context: ``ops.flash_attention``, ``ops.ssd_scan``,
    ``ops.rwkv6_scan`` and ``ops.decode_attention_prefix`` replaced by
    versions that launch the kernel, run its plain version on the same
    inputs, and append (name, max abs err, tolerance) to ``errors``.  Each
    ``decode_attention`` launch and the plain route on its inputs are both
    held to float64 (``decode_gap``, ``DECODE_GAP_C``).  For the bf16 ``ssd_scan`` launch farthest
    from the float32 plain route (``ssd_gap``), ``worst_ssd`` keeps that
    (batch, head): its inputs, the kernel's y and the float32 plain y.
    With ``conditioned`` (MLA), each ``flash_attention`` launch and its
    plain version are instead held to float64 within what float32 scores
    can reach (``conditioned_attention_gaps``), and to each other; the
    plain-version gate of the other families is then reported in
    ``conditioned`` with the bound's statistics, not gated.  The checks
    run without autograd, so a training step's launches (the forward's and
    the remat recompute's) are held the same way.  With ``witness``, each
    float32 ``ssd_scan`` launch from zero state also appends the relative
    L2 distances of the kernel's y and of the plain version's from the
    float64 recurrence (``_ssd_f64``) on the same inputs."""
    import torch
    from repro_torch.kernels import ops, ref

    fa, ssd, wkv = ops.flash_attention, ops.ssd_scan, ops.rwkv6_scan
    dap = ops.decode_attention_prefix

    def flash_attention(q, k, v, **kw):
        out = fa(q, k, v, **kw)
        with torch.no_grad():       # a training step's launches record
            check_attention(q, k, v, out, kw)
        return out

    def check_attention(q, k, v, out, kw):
        want = ops.plain_attention(q, k, v, **kw)
        tol = (2 ** -6 if q.dtype == torch.bfloat16 else 1e-4) \
            * v.abs().max().item()
        err = (out.float() - want.float()).abs().max().item()
        if conditioned is not None:
            bf16 = q.dtype == torch.bfloat16
            r = conditioned_attention_gaps(
                q, k, v, out, want, "bf16" if bf16 else tol, **kw)
            c = ATTN_BF16_C if bf16 else 1.0
            errors.extend([("flash_attention vs float64", r["kernel"], c),
                           ("flash_attention plain vs float64", r["plain"], c),
                           ("flash_attention vs plain", r["pair"], 2 * c)])
            conditioned["score_max"] = max(conditioned.get("score_max", 0),
                                           r["score_max"])
            for key in ("near_rows", "rows"):
                conditioned[key] = conditioned.get(key, 0) + r[key]
            conditioned["plain gate"] = max(conditioned.get("plain gate", 0),
                                            err / tol)
            if bf16 and "control" not in conditioned:
                # the bound's power on these activations: the kernel's
                # order with its scores kept in bf16 must fail it
                conditioned["control"] = conditioned_attention_gaps(
                    q, k, v, _attention_order(q, k, v, "s"), want, "bf16",
                    **kw)["kernel"]
            return
        errors.append(("flash_attention", err, tol))
        if q.dtype == torch.bfloat16:   # and element by element (_attention_case)
            want = ops.plain_attention(q.float(), k.float(), v.float(), **kw)
            errors.append(("flash_attention vs float32",
                           attention_gap(out, want), ATTN_BF16_C))

    def ssd_scan(x, dt, A, B, C, **kw):
        out = ssd(x, dt, A, B, C, **kw)
        with torch.no_grad():
            check_ssd(x, dt, A, B, C, out, kw)
        return out

    def check_ssd(x, dt, A, B, C, out, kw):
        want = ref.ssd_chunked_ref(x, dt, A, B, C, **kw)
        y, y_p = (out[0], want[0]) if kw.get("return_state") else (out, want)
        base = 2 ** -6 if x.dtype == torch.bfloat16 else 1e-4
        chunk = kw["chunk"]
        tol = ssd_rel_tol(dt, A, chunk, base) * y_p.float().abs().max().item()
        errors.append(("ssd_scan",
                       (y.float() - y_p.float()).abs().max().item(), tol))
        if witness is not None and x.dtype == torch.float32 \
                and kw.get("initial_state") is None:
            exact = _ssd_f64(x, dt, A, B, C)
            witness.append((_rel_l2(y, exact), _rel_l2(y_p, exact)))
            del exact
        if kw.get("return_state"):
            errors.append(("ssd_scan state",
                           (out[1] - want[1]).abs().max().item(),
                           ssd_rel_tol(dt, A, chunk, 1e-4)
                           * want[1].abs().max().item()))
        if x.dtype == torch.bfloat16:   # and element by element (_ssd_case)
            want = ref.ssd_chunked_ref(x.float(), dt, A, B.float(),
                                       C.float(), **kw)
            want = want[0] if kw.get("return_state") else want
            units = ssd_gap_units(y, want, ssd_magnitude(x, dt, A, B, C, **kw))
            gap = units.max().item()
            errors.append(("ssd_scan vs float32", gap,
                           ssd_gap_gate(dt, A, chunk)))
            if gap > worst_ssd.get("gap", -1.0):   # prefill: no initial state
                b, _, h, _ = (int(i) for i in torch.unravel_index(
                    units.argmax(), units.shape))
                worst_ssd.update(
                    gap=gap, gate=errors[-1][2], b=b, h=h, chunk=chunk,
                    launch=sum(e[0] == "ssd_scan vs float32" for e in errors),
                    x=x[b, :, h].clone(), dt=dt[b, :, h].clone(),
                    A=A[h].item(), B=B[b].clone(), C=C[b].clone(),
                    y=y[b, :, h].clone(), want=want[b, :, h].clone())

    def rwkv6_scan(r, k, v, w, u, **kw):
        out = wkv(r, k, v, w, u, **kw)
        with torch.no_grad():
            check_rwkv6(r, k, v, w, u, out, kw)
        return out

    def check_rwkv6(r, k, v, w, u, out, kw):
        want = ref.rwkv6_chunked_ref(r, k, v, w, u, **kw)
        y, y_p = (out[0], want[0]) if kw.get("return_state") else (out, want)
        base = 2 ** -6 if r.dtype == torch.bfloat16 else 1e-4
        chunk = kw["chunk"]
        errors.append(("rwkv6", (y.float() - y_p.float()).abs().max().item(),
                       rwkv6_rel_tol(w, chunk, base)
                       * y_p.float().abs().max().item()))
        if kw.get("return_state"):
            errors.append(("rwkv6 state",
                           (out[1] - want[1]).abs().max().item(),
                           rwkv6_rel_tol(w, chunk, 1e-4)
                           * want[1].abs().max().item()))

    def decode_attention_prefix(q, k, v, n_valid, *, use_kernel):
        out = dap(q, k, v, n_valid, use_kernel=use_kernel)
        if use_kernel and q.is_cuda:
            with torch.no_grad():
                check_decode(q, k, v, n_valid, out)
        return out

    def check_decode(q, k, v, n_valid, out):
        n = int(n_valid)
        valid = torch.arange(k.shape[1], device=q.device)[None, :] < n
        want = decode_float64(q, k, v, n)
        errors.append(("decode_attention vs float64",
                       decode_gap(out, *want), DECODE_GAP_C))
        errors.append(("decode_attention plain vs float64",
                       decode_gap(ops.decode_attention(q, k, v, valid),
                                  *want), DECODE_GAP_C))

    return _swapped_ops(flash_attention, ssd_scan, rwkv6_scan,
                        decode_attention_prefix)


LM_KERNELS = ("flash_attention", "ssd_scan", "rwkv6", "decode_attention")


def lm_launches(cfg, n_prefill: int, n_decode: int) -> dict[str, int]:
    """Launches of each LM kernel that ``n_prefill`` prefills and
    ``n_decode`` decode steps of ``cfg``'s model make: an RWKV6 layer runs
    ``rwkv6`` in both; a hybrid runs ``ssd_scan`` in each Mamba2 layer's
    prefill, ``flash_attention`` in each shared block's prefill and
    ``decode_attention`` in its decode; a layer of the dense stack (the
    dense, MoE, audio and vision-language families, either of DeepSeek's
    stacks) runs ``flash_attention`` in its prefill and, with GQA,
    ``decode_attention`` in its decode (MLA's absorbed decode is plain
    torch, as in the reference)."""
    n = dict.fromkeys(LM_KERNELS, 0)
    if cfg.rwkv:
        n["rwkv6"] = cfg.n_layers * (n_prefill + n_decode)
    elif cfg.family not in ("ssm", "hybrid"):
        n["flash_attention"] = cfg.n_layers * n_prefill
        if cfg.attn_type != "mla":
            n["decode_attention"] = cfg.n_layers * n_decode
    else:
        n["ssd_scan"] = cfg.n_layers * n_prefill
        n_attn = cfg.n_layers // cfg.hybrid_attn_every
        n["flash_attention"] = n_attn * n_prefill
        n["decode_attention"] = n_attn * n_decode
    return n


def _lm_counts(counts: dict[str, int]) -> dict[str, int]:
    return {name: counts[name] for name in LM_KERNELS}


def _logit_gap(run, plain) -> tuple[list[float], float, float, float]:
    """Max |logit difference| per position (the prefill's, then each decode
    step's), the logits' scale, and greedy agreement (all tokens, the
    prefill's picks)."""
    pairs = [(run.prefill_logits, plain.prefill_logits)] + list(
        zip(run.decode_logits, plain.decode_logits))
    errs = [(a.float() - b.float()).abs().max().item() for a, b in pairs]
    scale = max(b.float().abs().max().item() for _, b in pairs)
    agree = (run.tokens == plain.tokens).float().mean().item()
    agree0 = (run.tokens[:, 0] == plain.tokens[:, 0]).float().mean().item()
    return errs, scale, agree, agree0


def _check_on_activations(model, prompts, label: str,
                          patch_embeds=None) -> None:
    """One prefill (given ``patch_embeds``) and one decode step with every
    kernel result held to its plain version on the same inputs
    (``_checked_kernels``); fails on any miss, and unless each launched
    exactly its ``lm_launches``."""
    import torch
    cfg = model.cfg
    errors: list = []
    worst_ssd: dict = {}
    mla = {} if cfg.attn_type == "mla" else None
    bf16 = cfg.dtype == torch.bfloat16
    cache = model.init_cache(prompts.shape[0], prompts.shape[1] + 2)
    with _checked_kernels(errors, worst_ssd, mla):
        c0 = _lm_counts(launch_counts())
        model.prefill(prompts, cache, patch_embeds)
        c1 = _lm_counts(launch_counts())
        model.decode(prompts[:, -1:], cache)
        c2 = _lm_counts(launch_counts())
    torch.cuda.synchronize()
    in_prefill = {n: c1[n] - c0[n] for n in LM_KERNELS}
    in_decode = {n: c2[n] - c1[n] for n in LM_KERNELS}
    check(in_prefill == lm_launches(cfg, 1, 0)
          and in_decode == lm_launches(cfg, 0, 1),
          f"{label}: a prefill launched {in_prefill} and a decode step "
          f"{in_decode}, not {lm_launches(cfg, 1, 0)} and "
          f"{lm_launches(cfg, 0, 1)}")
    bad = [e for e in errors if not e[1] <= e[2]]
    worst = {name: max(e[1] / e[2] for e in errors if e[0] == name)
             for name in {e[0] for e in errors}}
    print(f"[serve {cfg.name}] a {label} prefill's and decode step's "
          f"{len(errors)} kernel results held to the plain versions on the "
          f"same activations "
          f"(launches: prefill {in_prefill}, decode {in_decode}): worst "
          f"err/tol " + ", ".join(f"{k} {v:.3f}" for k, v in sorted(worst.items())))
    if mla:
        print(f"[serve {cfg.name}] {label} MLA attention held to float64: "
              f"scores up to {mla['score_max']:.4g} in magnitude; "
              f"{mla['near_rows']} of {mla['rows']} query rows have a rival "
              f"key within float32's rounding of the best (the bound lets "
              f"them move by more than 1e-3 of max |v|); the plain-version "
              f"gate of the GQA families (2^-6 or 1e-4 of max |v|) would "
              f"read {mla['plain gate']:.3f} of its tolerance (reported, "
              f"not gated: float32 orders differ where scores tie within "
              f"their rounding)" + (f"; the kernel's order with bf16 scores "
              f"reads {mla['control']:.1f} units beyond the bound (must "
              f"exceed {ATTN_BF16_C})" if "control" in mla else ""))
        check(not bf16 or mla.get("control", 0) > ATTN_BF16_C,
              f"{label}: the float64 attention bound passes the kernel's "
              f"order with bf16 scores ({mla.get('control')} units)")
    if worst_ssd:
        # ssd_gap's gate on these activations, and a third witness at the
        # (batch, head) farthest from the float32 plain route: the kernel's
        # y, the float32 plain y and the kernel's order in plain torch
        # (_ssd_order), each against y in float64 on the same inputs, in
        # ssd_gap's unit without its 2^-20 mag term
        gates = [e[2] for e in errors if e[0] == "ssd_scan vs float32"]
        w = worst_ssd
        y64 = _ssd_float64(w["x"], w["dt"], w["A"], w["B"], w["C"], w["chunk"])
        order = _ssd_order(w["x"][None, :, None], w["dt"][None, :, None],
                           torch.tensor([w["A"]], device=y64.device),
                           w["B"][None], w["C"][None], chunk=w["chunk"])
        print(f"[serve {cfg.name}] ssd_scan vs float32: gates "
              f"{min(gates):.4f}-{max(gates):.4f} units over the launches; "
              f"the farthest, launch {w['launch']} (batch {w['b']}, head "
              f"{w['h']}), {w['gap']:.3f} units (gate {w['gate']:.4f}); there, "
              f"against float64 without the mag term: the kernel "
              f"{ssd_gap(w['y'], y64, None):.3f} units, its order in plain "
              f"torch {ssd_gap(order[0, :, 0], y64, None):.3f}, the float32 "
              f"plain route {ssd_gap(w['want'], y64, None):.3f}, float64 "
              f"rounded to bf16 {ssd_gap(y64.bfloat16(), y64, None):.3f}")
    # two results a launch: every ssd_scan and rwkv6 launch of the serve path
    # returns its final state, a bf16 flash_attention or ssd_scan is also
    # held to the float32 plain route, and a decode_attention launch and
    # the plain route on its inputs are each held to float64
    per_launch = {"flash_attention": 3 if mla is not None else
                  (2 if bf16 else 1),
                  "ssd_scan": 3 if bf16 else 2, "rwkv6": 2,
                  "decode_attention": 2}
    n_results = sum(per_launch[name] * (c2[name] - c0[name])
                    for name in LM_KERNELS)
    check(len(errors) == n_results and not bad,
          f"{label} kernel results on the serve path's activations disagree "
          f"with their plain versions: {bad[:4]}")


def plain_attention_by_row(fn):
    """The plain attention ``fn`` evaluated one batch row at a time and
    concatenated: the same function of every element, with one row's
    scores live instead of the batch's."""
    import torch

    def by_row(q, k, v, **kw):
        return torch.cat([fn(q[b:b + 1], k[b:b + 1], v[b:b + 1], **kw)
                          for b in range(q.shape[0])])
    return by_row


def phase_serve(device, arch: str) -> dict[str, int]:
    """``_serve`` of ``arch``, with ``ops.plain_attention`` evaluated by
    batch row (``plain_attention_by_row``) where the serve shape's float32
    scores pass ``PLAIN_SCORES_BYTES``: in the plain route's runs and in
    every check that holds a kernel launch to it."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    torch.cuda.empty_cache()
    full = get_config(arch, "full")
    scores = SERVE_BATCH * full.n_heads * SERVE_PROMPT ** 2 * 4
    plain = ops.plain_attention
    if scores > PLAIN_SCORES_BYTES:
        print(f"[serve {full.name}] the plain attention's float32 scores "
              f"would take {scores / 1e9:.1f} GB at once: evaluated one "
              f"batch row ({scores / SERVE_BATCH / 1e9:.2f} GB) at a time")
        ops.plain_attention = plain_attention_by_row(plain)
    try:
        return _serve(device, arch)
    finally:
        ops.plain_attention = plain


def serve_patch_embeds(cfg, device):
    """With the vision stub, ``cfg.n_patches`` seeded patch embeddings a
    prompt, (8, n_patches, d_model) bf16 at the embedding table's scale
    (0.02): the vision tower's output that ``src/repro/launch/shapes.py``
    gives the reference's prefill.  None without the stub."""
    import torch
    if not cfg.vision_stub:
        return None
    g = torch.Generator(device=device).manual_seed(2)
    return (0.02 * torch.randn((SERVE_BATCH, cfg.n_patches, cfg.d_model),
                               generator=g, device=device)).bfloat16()


def _serve(device, arch: str) -> dict[str, int]:
    """``arch`` at full width, and at full depth unless ``SERVE_LAYERS``
    cuts it, on the card: 8 prompts of 2048 tokens (with the vision stub,
    each prefill given ``serve_patch_embeds``), prefill, then 64 greedy
    decode steps through the kernels, timed and counted (exactly
    ``lm_launches``).  Then three checks against the plain route
    (``use_kernel=False``) on the same weights and prompts:

    - every kernel launch of one bf16 prefill and one decode step against
      its plain version on the same activations (gated, the kernels' own
      tolerances);
    - the bf16 logits of the two routes, teacher forced on the kernel run's
      tokens (reported, not gated: see the comment there);
    - the same model in float32 (at ``F32_LAYERS`` where given): every
      kernel launch of a prefill and a decode step against its plain
      version (gated), and prefill and 8 teacher-forced decode steps
      through both routes, against a bound made of the growth over depth
      measured in the same run (gated).
    """
    import dataclasses

    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import make_prompts, serve
    from repro_torch.models.model import build_model

    full = get_config(arch, "full")
    cfg = dataclasses.replace(full, n_layers=SERVE_LAYERS.get(
        arch, full.n_layers))
    cut = (f" (cut: {cfg.n_layers} of its {full.n_layers} layers, full "
           f"width)" if cfg.n_layers < full.n_layers else "")
    if cfg.n_experts and cfg.first_k_dense:
        cut += (f", {cfg.first_k_dense} dense and "
                f"{cfg.n_layers - cfg.first_k_dense} MoE")
    tag = f"[serve {cfg.name}]"
    t0 = time.perf_counter()
    model = build_model(cfg, device, seed=0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    check(model.cfg.use_kernel is True, "the model on the card does not use "
          "the kernels by default")
    prompts = make_prompts(cfg, SERVE_BATCH, SERVE_PROMPT, seed=0,
                           device=device)
    pe = serve_patch_embeds(cfg, device)
    n_tokens = SERVE_STEPS + 1          # the prefill's pick and 64 steps
    t0 = time.perf_counter()
    warm = serve(model, prompts, 3, patch_embeds=pe)  # first use of each path
    warm_s = time.perf_counter() - t0
    del warm

    torch.cuda.reset_peak_memory_stats(device)
    reset_launch_counts()
    run = serve(model, prompts, n_tokens, patch_embeds=pe, keep_logits=True)
    counts = launch_counts()
    peak_gb = torch.cuda.max_memory_allocated(device) / 1e9
    want = lm_launches(cfg, 1, SERVE_STEPS)
    check(_lm_counts(counts) == want,
          f"a prefill and {SERVE_STEPS} decode steps launched "
          f"{_lm_counts(counts)}, not {want}")
    if want["flash_attention"] and cfg.dtype == torch.bfloat16:
        # the instance of the bf16 kernel that the run's last launch took
        from repro_torch.kernels import flash_attention as fa_mod
        inst = fa_mod.last_instance()
        d = (cfg.qk_nope_head_dim + cfg.qk_rope_head_dim
             if cfg.attn_type == "mla" else cfg.head_dim)
        print(f"{tag} the bf16 flash_attention launches at D = {d} ran the "
              f"kernel's KD = {inst} instance (16 x {inst} columns)")
        check(inst == bf16_instance(d), f"D = {d} ran the KD = {inst} "
              f"instance of flash_attention, not KD = {bf16_instance(d)}")
    logits = [run.prefill_logits] + run.decode_logits
    cb = (cfg.n_codebooks,) if cfg.n_codebooks else ()
    check(all(bool(torch.isfinite(lg).all()) for lg in logits)
          and run.prefill_logits.shape == (SERVE_BATCH, 1) + cb
          + (cfg.vocab_size,)
          and run.tokens.shape == (SERVE_BATCH, n_tokens) + cb,
          "the serve run's logits are not finite or not of the served shape")
    p50 = run.decode_p50_ms()
    print(f"{tag} {cfg.n_layers} layers{cut}, d_model {cfg.d_model}, "
          f"{n_params / 1e9:.3f} B parameters in {str(cfg.dtype)[6:]}, seeded "
          f"on the card in {init_s:.3f} s; warm-up serve (3 tokens) "
          f"{warm_s:.3f} s")
    print(f"{tag} batch {SERVE_BATCH} x {SERVE_PROMPT} prompt tokens: "
          f"prefill {run.prefill_ms:.3f} ms, decode p50 {p50:.3f} ms over "
          f"{len(run.decode_ms) - 1} steps (first left out; mean "
          f"{statistics.mean(run.decode_ms[1:]):.3f} ms, max "
          f"{max(run.decode_ms[1:]):.3f} ms), {SERVE_BATCH * 1e3 / p50:.1f} "
          f"tok/s; peak memory {peak_gb:.3f} GB; launches {counts}")

    # where the time goes: 4 more decode steps on the run's cache (its room
    # holds prompt + tokens + 4 positions), then one prefill
    tok = run.tokens[:, -1:]

    def more_steps():
        t, c = tok, run.cache
        for _ in range(4):
            lg, c = model.decode(t, c)
            t = torch.argmax(lg, dim=-1)

    wall, dev, ops_ = device_profile(more_steps, top=8)
    print(f"{tag} profiled 4 decode steps: {busy_text(wall, dev)}; top "
          f"device ops: {top_text(ops_)}")
    wall, dev, ops_ = device_profile(lambda: model.prefill(
        prompts, model.init_cache(SERVE_BATCH, n_tokens + SERVE_PROMPT + 4),
        pe), top=None)
    ours = [op for op in ops_ if any(name in op[0] for name in LM_KERNELS)]
    print(f"{tag} profiled prefill: {busy_text(wall, dev)}; top device "
          f"ops: {top_text(ops_[:8])}; the port's kernels: {top_text(ours)}")

    # 1. every launch of one prefill and one decode step against its plain
    #    version on the same activations (the serve path's real inputs, not
    #    random ones)
    _check_on_activations(model, prompts, "bf16", pe)

    # 2. the bf16 routes end to end.  The reference's init gives stacked
    #    layer weights std 1/sqrt(n_layers) (zamba2-7b: 1/9), a high-gain
    #    stack: check 3 measures how much a small relative perturbation of
    #    the embeddings grows by the logits.  bf16 rounds at 2^-9, so two
    #    bf16 routes that round at different places (the plain route rounds
    #    attention probabilities to bf16, as the reference oracle does; the
    #    kernels keep them and the scans' sums in float32) can decorrelate by
    #    the last layer.  The gap is reported; checks 1 and 3 gate.
    model.cfg = dataclasses.replace(model.cfg, use_kernel=False)
    before = launch_counts()
    t0 = time.perf_counter()
    plain = serve(model, prompts, n_tokens, force=run.tokens,
                  patch_embeds=pe, keep_logits=True)
    plain_s = time.perf_counter() - t0
    check(launch_counts() == before, "the plain route launched a kernel")
    errs, scale, agree, agree0 = _logit_gap(run, plain)
    print(f"{tag} bf16 plain route (teacher forced): {plain_s:.3f} s, "
          f"prefill {plain.prefill_ms:.3f} ms, decode p50 "
          f"{plain.decode_p50_ms():.3f} ms; max |logit diff| prefill "
          f"{errs[0]:.4f}, decode {max(errs[1:]):.4f} (step mean "
          f"{statistics.mean(errs[1:]):.4f}), logit scale {scale:.4f}; greedy "
          f"agreement {100 * agree:.2f}% of tokens ({100 * agree0:.1f}% of "
          f"the prefill's picks); reported, not gated")
    del model, run, plain
    torch.cuda.empty_cache()

    # 3. float32, where the kernels and the plain versions differ only in
    #    the order of sums: ~1e-6 of their outputs' scale (phase 2 and check
    #    1 here in float32).  The depth multiplies such a difference: the
    #    growth is measured here, as the plain prefill's logits move when
    #    the embedding table is perturbed by 1e-6 (relative).  The routes'
    #    gap is bounded by that growth of a 1e-6 difference, times
    #    sqrt(launches) for the places such differences enter: the prefill's
    #    and the decode steps' launches (rwkv6-1.6b: 24 in each of the 9
    #    calls; zamba2-7b: 94 in the prefill and 13 a step; minitron-4b: 32
    #    and 32, mixtral-8x22b's 2 float32 layers: 2 and 2, musicgen-large:
    #    48 and 48, qwen2-vl-2b: 28 and 28; deepseek-v3-671b's 4: 4, all in
    #    the prefill, its MLA decode being the plain route's).  With
    #    codebooks, the perturbed tables are the streams'.
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32, n_layers=F32_LAYERS
                                .get(arch, cfg.n_layers))
    if cfg32.n_layers < cfg.n_layers:
        split = (f", {cfg32.first_k_dense} dense and "
                 f"{cfg32.n_layers - cfg32.first_k_dense} MoE"
                 if cfg32.n_experts and cfg32.first_k_dense else "")
        print(f"{tag} the float32 check runs {cfg32.n_layers} of the "
              f"{cfg.n_layers} layers{split} (float32 doubles a layer's "
              f"bytes)")
    model = build_model(cfg32, device, seed=0)
    _check_on_activations(model, prompts, "float32", pe)
    steps32 = 8
    t0 = time.perf_counter()
    run = serve(model, prompts, steps32 + 1, patch_embeds=pe,
                keep_logits=True)
    k_s = time.perf_counter() - t0
    model.cfg = dataclasses.replace(model.cfg, use_kernel=False)
    plain = serve(model, prompts, steps32 + 1, force=run.tokens,
                  patch_embeds=pe, keep_logits=True)
    errs, scale, agree, agree0 = _logit_gap(run, plain)
    # the model's last use: the table the prompts read (with codebooks, the
    # streams' tables) is perturbed in place, not restored
    table = model.embed_cb if cfg.n_codebooks else model.embedding
    g = torch.Generator(device=device).manual_seed(1)
    with torch.no_grad():
        table.mul_(1 + 1e-6 * torch.randn(table.shape, generator=g,
                                          device=device))
    nudged, _ = model.prefill(prompts, model.init_cache(SERVE_BATCH,
                                                        SERVE_PROMPT + 1), pe)
    growth = ((nudged - plain.prefill_logits).abs().max().item()
              / plain.prefill_logits.abs().max().item() / 1e-6)
    print(f"{tag} float32 plain prefill with the embeddings perturbed by "
          f"1e-6 (relative): the last logits move by {growth * 1e-6:.3e} "
          f"of their scale, a growth over depth of {growth:.1f}x")
    print(f"{tag} float32, kernel route ({k_s:.3f} s; prefill "
          f"{run.prefill_ms:.3f} ms) against the plain route (prefill "
          f"{plain.prefill_ms:.3f} ms), {steps32} teacher-forced decode steps: "
          f"max |logit diff| prefill {errs[0]:.3e}, decode {max(errs[1:]):.3e}, "
          f"logit scale {scale:.4f} ({100 * max(errs) / scale:.2f}%); greedy "
          f"agreement {100 * agree:.2f}%")
    n_launch = sum(lm_launches(cfg32, 1, steps32).values())
    tol = n_launch ** 0.5 * growth * 1e-6 * scale
    check(max(errs) <= tol,
          f"in float32 the kernel route's logits differ from the plain "
          f"route's by {max(errs):.3e} > {tol:.3e} (sqrt({n_launch}) x growth "
          f"{growth:.1f} x 1e-6 x scale {scale:.3f})")
    del model, run, plain
    torch.cuda.empty_cache()
    return counts


WORLD_DAYS, WORLD_PER_DAY = 14.0, 200     # benchmarks/common.py::build_world
FIG5_RUNS = 4               # examples/transfer_tuning.py's transfers a model
FIG6_SMOKE_SEEDS = range(3)  # benchmarks/fig6_accuracy.py's smoke seeds
FIG6_SEEDS = range(9)       # and its full ones
ANNOT_MSE_RTOL = 1e-3       # ANN+OT's train_mse, card against the CPU


def _annot_init(dtype):
    """ANN+OT's initial parameters, drawn once on the CPU: the card's and
    the CPU's generators give different streams from one seed, so both runs
    take these."""
    import torch
    from repro_torch.core.baselines.ann_ot import init_mlp
    return init_mlp(torch.Generator().manual_seed(0), dtype=dtype)


def _fig6_transfer(s: int):
    """``benchmarks/fig6_accuracy.py``'s transfer ``s`` on xsede."""
    from repro_torch.netsim import make_dataset, make_testbed
    env = make_testbed("xsede", seed=200 + s)
    env.clock_s = 5 * 3600 + s * 997
    return env, make_dataset(["small", "medium", "large"][s % 3], 60 + s)


def _forecast_accuracy(achieved: float, predicted: float) -> float:
    """Eq. 25, as ``fig6_accuracy.py`` scores HARP and ANN+OT."""
    pred = max(predicted, 1e-6)
    return max(0.0, 100 * (1 - abs(achieved - pred) / max(pred, achieved)))


def phase_baselines(device) -> dict[str, int]:
    """The paper's comparison on xsede, as ``benchmarks/common.py::
    build_world("xsede", seed=0)`` sets it up (2,800 log entries, the ASM
    tuner fitted on the card, the six baselines, ANN+OT trained on the
    card): a miniature Fig. 5 (mean % of optimal steady throughput over
    ``examples/transfer_tuning.py``'s four medium transfers) and Fig. 6
    (prediction accuracy at 1 and 3 samples over ``fig6_accuracy.py``'s
    smoke seeds).  Gates: every report finite and positive and every
    sample within ``ParamBounds``; ANN+OT's training error on the card
    within 1e-3 relative of the CPU's from the same initial parameters;
    in float64, the same (cc, p, pp) on the card and the CPU on Fig. 6's
    nine transfers."""
    import numpy as np
    import torch
    from repro_torch.core import TransferTuner, TunerConfig
    from repro_torch.core.baselines import (
        ALL_BASELINES, ANNOT, HARP, run_transfer,
    )
    from repro_torch.netsim import (
        ParamBounds, generate_history, make_dataset, make_testbed,
    )

    tag = "[baselines]"
    bounds = ParamBounds()
    hist = generate_history(make_testbed("xsede", seed=3), days=WORLD_DAYS,
                            transfers_per_day=WORLD_PER_DAY, seed=0)
    reset_launch_counts()
    t0 = time.perf_counter()
    asm = TransferTuner(TunerConfig(seed=0, device=device)).fit(hist)
    torch.cuda.synchronize()
    asm_s = time.perf_counter() - t0

    # ANN+OT on the card, and on the CPU from the same initial parameters
    init = _annot_init(torch.float32)
    t0 = time.perf_counter()
    annot = ANNOT(hist, device=device, params=init)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    host = ANNOT(hist, device="cpu", params=init)
    host_s = time.perf_counter() - t0
    busy = device_busy(lambda: ANNOT(hist, device=device, params=init))
    rel = abs(annot.train_mse - host.train_mse) / host.train_mse
    print(f"{tag} {len(hist)} xsede entries; ASM fit on the card in "
          f"{asm_s:.3f} s; ANN+OT (300 Adam epochs, float32) trained on the "
          f"card in {card_s:.3f} s (train_mse {annot.train_mse:.7f}), on the "
          f"CPU in {host_s:.3f} s (train_mse {host.train_mse:.7f}, relative "
          f"gap {rel:.2e}, gate {ANNOT_MSE_RTOL:g}); profiled card training: "
          f"{busy_text(*busy)}")
    check(rel <= ANNOT_MSE_RTOL,
          f"ANN+OT's train_mse on the card {annot.train_mse} is {rel:.2e} "
          f"(relative) from the CPU's {host.train_mse}")

    tuners = {name: annot if name == "ANN+OT"
              else cls(hist) if name in ("SP", "HARP") else cls()
              for name, cls in ALL_BASELINES.items()}

    def held(rep, label: str):
        check(all(np.isfinite(v) and v > 0 for v in
                  (rep.steady_mbps, rep.achieved_mbps, rep.total_s)),
              f"{label}: report not finite and positive ({rep.steady_mbps}, "
              f"{rep.achieved_mbps}, {rep.total_s})")
        for r in rep.samples:
            check(1 <= r.params.cc <= bounds.max_cc
                  and 1 <= r.params.p <= bounds.max_p
                  and 1 <= r.params.pp <= bounds.max_pp,
                  f"{label}: sample {r.params} outside {bounds}")
        return rep

    pct = {}
    for name in list(tuners) + ["ASM"]:
        accs = []
        for r in range(FIG5_RUNS):
            env = make_testbed("xsede", seed=100 + r)
            env.clock_s = 4 * 3600 + 907 * r
            ds = make_dataset("medium", 30 + r)
            rep = held(asm.transfer(env, ds) if name == "ASM"
                       else run_transfer(tuners[name], env, ds),
                       f"{name} transfer {r}")
            _, opt = env.optimal(bounds, ds.avg_file_mb, ds.n_files)
            accs.append(100 * min(rep.steady_mbps, opt) / opt)
        pct[name] = statistics.mean(accs)
    print(f"{tag} Fig. 5 miniature, % of optimal steady throughput over "
          f"{FIG5_RUNS} medium transfers: "
          + ", ".join(f"{n} {v:.1f}" for n, v in pct.items()))

    acc6 = {"ASM": {}, "HARP": {}, "ANN+OT": {}}
    for n in (1, 3):
        tuner = TransferTuner(TunerConfig(seed=0, max_samples=n,
                                          device=device)).fit(hist)
        asm_acc, harp_acc = [], []
        for s in FIG6_SMOKE_SEEDS:
            rep = held(tuner.transfer(*_fig6_transfer(s)), f"ASM fig6 {s}")
            asm_acc.append(rep.prediction_accuracy)
            harp = HARP(hist, n_probes=max(n, 1))
            rep = held(run_transfer(harp, *_fig6_transfer(s)),
                       f"HARP fig6 {s}")
            harp_acc.append(_forecast_accuracy(rep.steady_mbps,
                                               harp.predicted_mbps))
        acc6["ASM"][n] = statistics.mean(asm_acc)
        acc6["HARP"][n] = statistics.mean(harp_acc)
    ann_acc = []
    for s in FIG6_SMOKE_SEEDS:
        rep = held(run_transfer(annot, *_fig6_transfer(s)), f"ANN+OT fig6 {s}")
        ann_acc.append(_forecast_accuracy(rep.steady_mbps, annot._best_pred))
    acc6["ANN+OT"] = dict.fromkeys((1, 3), statistics.mean(ann_acc))
    print(f"{tag} Fig. 6 prediction accuracy at 1 / 3 samples over seeds "
          f"{list(FIG6_SMOKE_SEEDS)}: "
          + ", ".join(f"{m} {c[1]:.1f} / {c[3]:.1f}" for m, c in acc6.items()))
    ahead = pct["ASM"] > max(pct["GO"], pct["SP"])
    print(f"{tag} the paper's ordering: ASM {pct['ASM']:.1f}% against GO "
          f"{pct['GO']:.1f}% and SP {pct['SP']:.1f}%: ASM "
          f"{'ahead of both' if ahead else 'NOT ahead of both'} (reported, "
          f"not gated: the port's ANN+OT starts from torch's draws)")

    # float64: the card and the CPU choose alike on every Fig. 6 transfer
    init64 = _annot_init(torch.float64)
    card64 = ANNOT(hist, device=device, params=init64)
    host64 = ANNOT(hist, device="cpu", params=init64)
    for s in FIG6_SEEDS:
        got = card64.start(*_fig6_transfer(s)).as_tuple()
        want = host64.start(*_fig6_transfer(s)).as_tuple()
        check(got == want, f"float64 ANN+OT chose {got} on the card and "
              f"{want} on the CPU at Fig. 6 transfer {s}")
    print(f"{tag} float64 ANN+OT: train_mse card {card64.train_mse:.15f}, "
          f"cpu {host64.train_mse:.15f}; the same (cc, p, pp) on all "
          f"{len(FIG6_SEEDS)} Fig. 6 transfers")
    counts = launch_counts()
    print(f"{tag} launches {counts}")
    return counts


CKPT_FREE_BYTES = 8e9        # two saves of rwkv6-1.6b's 3.16 GB, and probes
PROBE_LEAVES, PROBE_SIZE = 16, 250_000   # examples/transfer_tuning.py's tree
PROBE_SAVES = 12             # and its probe count
PIPE_BATCHES = 8


def _filesystem(path: str) -> str:
    """The type of the filesystem ``path`` lies on (from /proc/mounts), so
    a save's rate can be read as a disk's or as memory's (tmpfs)."""
    try:
        with open("/proc/mounts") as fh:
            mounts = [line.split()[1:3] for line in fh]
    except OSError:
        return "a filesystem of unknown type"
    point, kind = max(((m, k) for m, k in mounts
                       if path == m or path.startswith(m.rstrip("/") + "/")),
                      key=lambda mk: len(mk[0]), default=("?", "unknown"))
    return f"{kind} mounted at {point}"


def phase_checkpoint(device) -> dict[str, int]:
    """The paper's knobs on real disk with a model on the card: a
    ``CheckpointTuner`` seeded with real probe saves of a tree on the card,
    fitted on the card; rwkv6-1.6b's full bf16 weights saved under its
    recommendation and under (1, 1, 1), the newest restored to the card;
    gates: every leaf ``torch.equal`` in dtype and shape, and one prefill
    (batch 1, 2048 tokens) through a model filled from the restored tree
    gives the original's logits exactly, through exactly 24 ``rwkv6``
    launches.  Then ``TokenPipeline`` at rwkv6's serve shape fed to the
    card; gate: the card's copies of the one-worker batches equal the
    batches the CPU makes for the same indices."""
    import os
    import shutil
    import tempfile

    import torch
    from repro_torch.checkpoint.ckpt import (
        CkptParams, restore_checkpoint, save_checkpoint,
    )
    from repro_torch.checkpoint.tuning import CheckpointTuner
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, PipelineParams, TokenPipeline
    from repro_torch.launch.serve import make_prompts
    from repro_torch.models.model import build_model
    from repro_torch.models.params import paths_from_tree

    tag = "[checkpoint]"
    cfg = get_config("rwkv6-1.6b", "full")
    model = build_model(cfg, device, seed=0)
    tree = dict(model.named_parameters())
    n_bytes = sum(p.numel() * p.element_size() for p in tree.values())
    g = torch.Generator(device=device).manual_seed(0)
    probe = {f"l{i}": torch.randn(PROBE_SIZE, generator=g, device=device)
             for i in range(PROBE_LEAVES)}
    torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as d:
        free = shutil.disk_usage(d).free
        print(f"{tag} {cfg.name}: {len(tree)} leaves, {n_bytes / 1e9:.3f} GB "
              f"in {str(cfg.dtype)[6:]} on the card; {free / 1e9:.1f} GB free "
              f"under the temporary directory, on {_filesystem(d)}")
        check(free >= CKPT_FREE_BYTES,
              f"only {free / 1e9:.1f} GB free under {d}: two checkpoints of "
              f"{n_bytes / 1e9:.2f} GB need {CKPT_FREE_BYTES / 1e9:.0f} GB")
        log = os.path.join(d, "transfers.jsonl")
        tuner = CheckpointTuner(log, device=device)
        t0 = time.perf_counter()
        probes = tuner.seed_history(probe, os.path.join(d, "probe"),
                                    n_probes=PROBE_SAVES)
        seed_s = time.perf_counter() - t0
        shutil.rmtree(os.path.join(d, "probe"))
        t0 = time.perf_counter()
        rec = tuner.fit().recommend()
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        rates = sorted(s["throughput_mbps"] for s in probes)
        print(f"{tag} {PROBE_SAVES} probe saves of {PROBE_LEAVES} x "
              f"{PROBE_SIZE} f32 on the card in {seed_s:.3f} s ("
              f"{rates[0]:.0f}-{rates[-1]:.0f} Mbit/s); tuner fit on the card "
              f"in {fit_s:.3f} s; recommended (cc, p, pp) = "
              f"({rec.cc}, {rec.p}, {rec.pp})")
        rec_t = (rec.cc, rec.p, rec.pp)

        # the device-to-host half of a save alone: every leaf copied to
        # pageable host memory one at a time, as the writer copies them
        t0 = time.perf_counter()
        host = [p.detach().cpu() for p in tree.values()]
        d2h_s = time.perf_counter() - t0
        del host
        ck = os.path.join(d, "model")
        saves = {}
        for step, prm in ((1, rec), (2, CkptParams(1, 1, 1))):
            torch.cuda.synchronize()
            saves[(prm.cc, prm.p, prm.pp)] = save_checkpoint(ck, step, tree,
                                                             params=prm)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        back = restore_checkpoint(ck, params=rec, device=device)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
    print(f"{tag} device-to-host copies of every leaf alone: {d2h_s:.3f} s, "
          f"{n_bytes / d2h_s / 1e9:.2f} GB/s")
    for prm, s in saves.items():
        print(f"{tag} save of {s['bytes'] / 1e9:.3f} GB at (cc, p, pp) = "
              f"{prm}: {s['elapsed_s']:.3f} s, {s['throughput_mbps']:.0f} "
              f"Mbit/s")
    print(f"{tag} restore of the newest step to the card at (cc, p, pp) = "
          f"{rec_t}: "
          f"{restore_s:.3f} s, {n_bytes * 8e-6 / restore_s:.0f} Mbit/s")

    flat = paths_from_tree(back)
    check(set(flat) == set(tree), "the restored tree's leaves are not the "
          "model's")
    for name, p in tree.items():
        got = flat[name]
        check(got.device == p.device and got.dtype == p.dtype
              and got.shape == p.shape and torch.equal(got, p),
              f"restored {name} differs from the saved leaf")
    twin = build_model(cfg, device, seed=None)
    with torch.no_grad():
        for name, p in twin.named_parameters():
            p.copy_(flat[name])
    del back, flat
    prompt = make_prompts(cfg, SERVE_BATCH, SERVE_PROMPT, seed=0,
                          device=device)[:1]
    want, _ = model.prefill(prompt, model.init_cache(1, SERVE_PROMPT + 1))
    torch.cuda.synchronize()
    reset_launch_counts()
    got, _ = twin.prefill(prompt, twin.init_cache(1, SERVE_PROMPT + 1))
    torch.cuda.synchronize()
    counts = launch_counts()
    check(_lm_counts(counts) == lm_launches(cfg, 1, 0),
          f"the restored model's prefill launched {_lm_counts(counts)}, not "
          f"{lm_launches(cfg, 1, 0)}")
    check(torch.equal(got, want), "the restored model's prefill logits "
          "differ from the original's")
    print(f"{tag} every leaf restored equal in dtype and shape; a prefill of "
          f"1 x {SERVE_PROMPT} tokens through the restored model: logits "
          f"equal to the original's, launches {counts}")
    del model, twin, tree, probe
    torch.cuda.empty_cache()

    dcfg = DataConfig(vocab_size=cfg.vocab_size, global_batch=SERVE_BATCH,
                      seq_len=SERVE_PROMPT, seed=0)
    for prm in (PipelineParams(1, 1, 1), PipelineParams(4, 2, 4)):
        pipe = TokenPipeline(dcfg, prm)
        try:
            t0 = time.perf_counter()
            copies = [torch.from_numpy(pipe.next_batch()["tokens"]).to(device)
                      for _ in range(PIPE_BATCHES)]
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            pipe.close()
        n_tok = PIPE_BATCHES * SERVE_BATCH * SERVE_PROMPT
        print(f"{tag} TokenPipeline (cc, p, pp) = ({prm.cc}, {prm.p}, "
              f"{prm.pp}), vocab {cfg.vocab_size}, {SERVE_BATCH} x "
              f"{SERVE_PROMPT}: {PIPE_BATCHES} batches to the card in "
              f"{wall:.4f} s, {n_tok / wall:.0f} tokens/s")
        if prm.cc == 1:
            for i, c in enumerate(copies):
                cpu = torch.from_numpy(pipe._gen_shard(i, 0, SERVE_BATCH))
                check(torch.equal(c.cpu(), cpu),
                      f"one-worker batch {i} on the card differs from the "
                      f"CPU's batch {i}")
    return counts


# --------------------------------------------------------------------- #
# phase 15: training
# --------------------------------------------------------------------- #
TRAIN_ARCH = "qwen2-vl-2b"      # the dense model whose training state fits
TRAIN_BATCH, TRAIN_SEQ = 8, 1024    # the reference launcher's global batch
TRAIN_MICRO = 2                 # as examples/train_lm.py trains
TRAIN_STEPS, TRAIN_WARMUP = 12, 3   # on 2 fixed batches, repeated
# bf16 steps of the two scan kernels' families, batch 4 x 1024: rwkv6-1.6b
# whole; zamba2-7b at full width and 6 of its 81 layers, one application
# of the shared block (its whole training state would be ~81 GB); None:
# whole.  Their losses are phase 17's unsplit ones
TRAIN_ONE_STEP = {"rwkv6-1.6b": None, "zamba2-7b": 6}
TRAIN_ONE_BATCH = 4
TRAIN_ONE_STEPS = 2             # on batches of seeds 0 and 1
# the float32 kernel-against-plain step's depth
TRAIN_F32_LAYERS = {TRAIN_ARCH: 4, "rwkv6-1.6b": 4, "zamba2-7b": 6}


def train_launches(cfg, n_micro: int) -> dict[str, int]:
    """Launches of each LM kernel in one train step of ``n_micro``
    microbatches: a microbatch's forward launches what a prefill does
    (``lm_launches``), and under ``cfg.remat`` the backward recomputes each
    layer's forward, launching it again; the backward's own products are
    the plain version's vjp and launch none."""
    per = lm_launches(cfg, 1, 0)
    return {n: c * n_micro * (2 if cfg.remat else 1) for n, c in per.items()}


def train_batch(cfg, device, batch: int, seed: int) -> dict:
    """Seeded tokens (labels = tokens, as ``TokenPipeline`` makes them)
    and, with the vision stub, ``cfg.n_patches`` patch embeddings a row at
    the embedding table's scale, as ``serve_patch_embeds`` gives them."""
    import torch
    from repro_torch.launch.serve import make_prompts
    tok = make_prompts(cfg, batch, TRAIN_SEQ, seed=seed, device=device)
    out = {"tokens": tok, "labels": tok}
    if cfg.vision_stub:
        g = torch.Generator(device=device).manual_seed(100 + seed)
        out["patch_embeds"] = (0.02 * torch.randn(
            (batch, cfg.n_patches, cfg.d_model), generator=g,
            device=device)).to(cfg.dtype)
    return out


def _train_cfg(arch: str, n_layers: int | None = None, dtype=None):
    import dataclasses
    from repro_torch.configs import get_config
    full = get_config(arch, "full")
    return dataclasses.replace(full, n_layers=n_layers or full.n_layers,
                               dtype=dtype or full.dtype)


def _loss_and_grads(model, batch) -> tuple[float, dict]:
    """One forward and backward (``train.loop.grads_of``): (loss,
    {name: gradient})."""
    from repro_torch.train.loop import grads_of
    loss, _, grads = grads_of(model, batch)
    return loss.item(), grads


def _rel_l2(a, b) -> float:
    """Relative L2 distance of ``a`` from ``b``, in float64."""
    a, b = a.double(), b.double()
    return ((a - b).norm() / b.norm().clamp_min(1e-300)).item()


def _checked_train_grads(model, batch, label: str) -> dict[str, int]:
    """One forward and backward of a microbatch with every kernel launch
    (the forward's and the remat recompute's) held to its plain version on
    the same activations (``_checked_kernels``, the serve gates); fails on
    any miss and unless each kernel launched exactly ``train_launches``."""
    import torch
    cfg = model.cfg
    tag = f"[train {cfg.name}]"
    errors: list = []
    worst_ssd: dict = {}
    with _checked_kernels(errors, worst_ssd):
        c0 = _lm_counts(launch_counts())
        loss, grads = _loss_and_grads(model, batch)
        c1 = _lm_counts(launch_counts())
    torch.cuda.synchronize()
    got = {n: c1[n] - c0[n] for n in LM_KERNELS}
    want = train_launches(cfg, 1)
    check(got == want, f"{label}: a checked forward and backward launched "
          f"{got}, not {want}")
    check(all(bool(torch.isfinite(g).all()) for g in grads.values())
          and loss == loss, f"{label}: a non-finite loss or gradient")
    bf16 = cfg.dtype == torch.bfloat16
    per_launch = {"flash_attention": 2 if bf16 else 1,
                  "ssd_scan": 2 if bf16 else 1, "rwkv6": 1,
                  "decode_attention": 2}
    n_results = sum(per_launch[n] * got[n] for n in LM_KERNELS)
    bad = [e for e in errors if not e[1] <= e[2]]
    worst = {name: max(e[1] / e[2] for e in errors if e[0] == name)
             for name in {e[0] for e in errors}}
    print(f"{tag} a {label} forward and backward: {len(errors)} kernel "
          f"results (launches {got}, the forward's and the remat "
          f"recompute's) held to the plain versions on the same activations:"
          f" worst err/tol " + ", ".join(f"{k} {v:.3f}"
                                         for k, v in sorted(worst.items())))
    check(len(errors) == n_results and not bad,
          f"{label}: kernel results on the train step's activations disagree "
          f"with their plain versions: {bad[:4]}")
    return got


# a float32 launch's difference from its plain version on the same inputs,
# as the float32 gradient gate takes it a priori: 1e-6 of its output, the
# serve gates' figure (phase 2's float32 cases sit below it)
F32_LAUNCH_DELTA = 1e-6


def _bf16_outputs():
    """Context: each LM kernel's output rounded to bfloat16, a kernel
    wrong by ~2^-9 of its output: the control that the float32 gradient
    gate must fail."""
    from repro_torch.kernels import ops

    def rounded(fn):
        return lambda *args, **kw: fn(*args, **kw).bfloat16().float()
    return _swapped_ops(rounded(ops.flash_attention), rounded(ops.ssd_scan),
                        rounded(ops.rwkv6_scan))


def _train_f32_gate(device, arch: str, batch_rows: int) -> None:
    """One float32 forward and backward from the same seeded weights and
    batch on the kernel route and on the plain route (``use_kernel=
    False``), at ``TRAIN_F32_LAYERS``, gated as the serve gates gate the
    logits.

    In float32 the routes differ only where a kernel launch's output
    differs from its plain version's, in the order of the sums.  Each
    launch is held to its plain version on the same inputs
    (``_checked_kernels``).  The gradient gate takes each launch's
    difference a priori, never from the kernel's output: delta =
    ``F32_LAUNCH_DELTA`` (relative), or for ``ssd_scan`` twice the plain
    version's own distance (relative L2) from the float64 recurrence on
    the launch's inputs (``_ssd_f64``) where that is larger: a kernel may
    sit as far from the exact result as the plain version does.  The depth
    multiplies such differences by a growth measured here: how far the
    plain route's loss and each parameter's gradient move (relative L2)
    when the embedding table is perturbed by 1e-6 (relative), less the
    noise floor, how far a repeat of the unperturbed plain step moves
    them.  With S = sqrt(sum over the step's launches of delta^2) (the
    forward's and the remat recompute's):

    - |loss difference| <= the loss's growth (at least 1) x S x |loss|
      + the loss's noise floor;
    - each gradient's relative L2 difference <= its growth x S + its noise
      floor.

    Control: the kernel route with every launch's output rounded to
    bfloat16 (``_bf16_outputs``) must fail the same gate."""
    import contextlib
    import dataclasses

    import torch
    from repro_torch.models.model import build_model
    cfg = _train_cfg(arch, TRAIN_F32_LAYERS[arch], torch.float32)
    tag = f"[train {cfg.name}]"
    model = build_model(cfg, device, seed=0).requires_grad_(True)
    batch = train_batch(cfg, device, batch_rows, seed=0)
    want = train_launches(cfg, 1)

    def route(use_kernel: bool, swap=None):
        model.cfg = dataclasses.replace(model.cfg, use_kernel=use_kernel)
        c0 = _lm_counts(launch_counts())
        with swap or contextlib.nullcontext():
            loss, grads = _loss_and_grads(model, batch)
        got = {n: launch_counts()[n] - c0[n] for n in LM_KERNELS}
        expect = want if use_kernel else dict.fromkeys(LM_KERNELS, 0)
        check(got == expect, f"float32 {cfg.name}: a step on the "
              f"{'kernel' if use_kernel else 'plain'} route launched {got}, "
              f"not {expect}")
        return loss, grads

    p_loss, p_grads = route(False)
    names = [n for n, g in p_grads.items() if g.norm() > 0]
    r_loss, r_grads = route(False)
    noise = {n: _rel_l2(r_grads[n], p_grads[n]) for n in names}
    del r_grads
    errors: list = []
    witness: list = []
    k_loss, k_grads = route(True, _checked_kernels(errors, {},
                                                   witness=witness))
    for name, g in k_grads.items():
        check(name in names or g.norm() == 0, f"{name}: a gradient on the "
              f"kernel route where the plain route has none")
    diff = {n: _rel_l2(k_grads[n], p_grads[n]) for n in names}
    del k_grads
    c_loss, c_grads = route(True, _bf16_outputs())
    ctrl = {n: _rel_l2(c_grads[n], p_grads[n]) for n in names}
    del c_grads
    table = model.embed_cb if cfg.n_codebooks else model.embedding
    g = torch.Generator(device=device).manual_seed(1)
    with torch.no_grad():
        table.mul_(1 + 1e-6 * torch.randn(table.shape, generator=g,
                                          device=device))
    n_loss, n_grads = route(False)
    moved = {n: _rel_l2(n_grads[n], p_grads[n]) for n in names}
    del n_grads, p_grads, model
    torch.cuda.empty_cache()

    bad = [e for e in errors if not e[1] <= e[2]]
    worst = {nm: max(e[1] / e[2] for e in errors if e[0] == nm)
             for nm in {e[0] for e in errors}}
    print(f"{tag} float32, {cfg.n_layers} layers, batch {batch_rows} x "
          f"{TRAIN_SEQ}: {len(errors)} kernel results (launches {want}) held "
          f"to their plain versions on the step's activations: worst err/tol "
          + ", ".join(f"{k} {v:.3f}" for k, v in sorted(worst.items())))
    check(len(errors) == sum(want.values()) and not bad,
          f"float32 {cfg.name}: kernel results on the step's activations "
          f"disagree with their plain versions: {bad[:4]}")
    delta = dict.fromkeys(LM_KERNELS, F32_LAUNCH_DELTA)
    if witness:
        k_exact, p_exact = zip(*witness)
        delta["ssd_scan"] = max(F32_LAUNCH_DELTA, 2 * max(p_exact))
        print(f"{tag} float32 ssd_scan against the float64 recurrence on "
              f"the step's {len(witness)} launches' inputs: relative L2 of "
              f"the kernel {min(k_exact):.3e}-{max(k_exact):.3e}, of the "
              f"plain version {min(p_exact):.3e}-{max(p_exact):.3e}; the "
              f"gate's delta for ssd_scan {delta['ssd_scan']:.3e}")
    spread = sum(want[k] * delta[k] ** 2 for k in LM_KERNELS) ** 0.5
    growth = {n: max(moved[n] - noise[n], 0.0) / 1e-6 for n in names}
    gate = {n: growth[n] * spread + noise[n] for n in names}
    loss_noise = abs(r_loss - p_loss)
    loss_growth = max((abs(n_loss - p_loss) - loss_noise) / abs(p_loss)
                      / 1e-6, 1.0)
    loss_tol = loss_growth * spread * abs(p_loss) + loss_noise

    def ratios(d: dict, loss: float) -> list:
        rows = [(d[n] / gate[n] if gate[n] > 0 else
                 (float("inf") if d[n] > 0 else 0.0), n, d[n]) for n in names]
        rows.append((abs(loss - p_loss) / loss_tol, "the loss",
                     abs(loss - p_loss)))
        return sorted(rows, reverse=True)
    rows, c_rows = ratios(diff, k_loss), ratios(ctrl, c_loss)
    growths = sorted(growth.values())
    n_noisy = sum(v > 0 for v in noise.values())
    loudest = max(names, key=noise.get)
    print(f"{tag} float32 plain route: loss {p_loss:.7f}; a repeat moves "
          f"the loss by {loss_noise:.3e} and {n_noisy} of {len(names)} "
          f"gradients (at most {noise[loudest]:.3e}, {loudest}); the "
          f"embeddings perturbed by 1e-6 move the loss by "
          f"{abs(n_loss - p_loss):.3e}; gradient growth over that noise "
          f"{growths[0]:.2f}-{growths[-1]:.1f}x (median "
          f"{growths[len(growths) // 2]:.2f}x); S = {spread:.3e}")
    print(f"{tag} float32 kernel route: loss {k_loss:.7f} (|diff| "
          f"{abs(k_loss - p_loss):.3e}, gate {loss_tol:.3e}: growth "
          f"{loss_growth:.2f} x S x |loss| + noise); the closest to their "
          f"gate: " + "; ".join(f"{nm} {d:.2e} ({r:.3f} of its gate)"
                                for r, nm, d in rows[:3]))
    print(f"{tag} float32 control, every launch's output rounded to "
          f"bfloat16: loss {c_loss:.7f}; the farthest past their gate: "
          + "; ".join(f"{nm} {d:.2e} ({r:.1f} times its gate)"
                      for r, nm, d in c_rows[:3])
          + f"; {sum(r > 1 for r, _, _ in c_rows)} of {len(c_rows)} fail it")
    check(rows[0][0] <= 1.0, f"float32 {cfg.name}: {rows[0][1]} differs "
          f"between the routes by {rows[0][2]:.3e}, {rows[0][0]:.2f} times "
          f"its gate")
    check(c_rows[0][0] > 1.0, f"float32 {cfg.name}: the gate passed the "
          f"control (every launch's output in bfloat16)")


def _backward_split(device, cfg, rows: int) -> None:
    """Each LM kernel of ``cfg`` at its train shape (``rows`` x
    ``TRAIN_SEQ``, random inputs): the forward through its
    ``autograd.Function`` (the kernel) and the backward (the plain
    version's vjp, recomputed), medians of 10 calls between CUDA events,
    and the backward's time in one step of ``rows`` rows (a layer's
    launches of one microbatch's forward)."""
    import torch
    from repro_torch.kernels import ops
    S, bf16 = TRAIN_SEQ, torch.bfloat16
    g = torch.Generator(device=device).manual_seed(5)
    cases = []
    per = lm_launches(cfg, 1, 0)
    if per["flash_attention"]:
        q = torch.randn((rows, S, cfg.n_heads, cfg.head_dim), generator=g,
                        device=device).to(bf16)
        k, v = (torch.randn((rows, S, cfg.n_kv_heads, cfg.head_dim),
                            generator=g, device=device).to(bf16)
                for _ in range(2))
        cases.append(("flash_attention", ops.flash_attention, (q, k, v),
                      dict(causal=True, window=cfg.sliding_window)))
    if per["ssd_scan"]:
        x, dt, A, Bm, Cm, _ = _ssd_inputs(
            device, bf16, (rows, S, cfg.ssm_heads, cfg.ssm_head_dim,
                           cfg.ssm_state), False)
        cases.append(("ssd_scan", ops.ssd_scan, (x, dt, A, Bm, Cm),
                      dict(chunk=min(cfg.ssm_chunk, S))))
    if per["rwkv6"]:
        r, k, v, w, u, _ = _rwkv6_inputs(
            device, bf16, (rows, S, cfg.n_heads, cfg.head_dim),
            cfg.rwkv_chunk, False)
        cases.append(("rwkv6", ops.rwkv6_scan, (r, k, v, w, u),
                      dict(chunk=cfg.rwkv_chunk)))
    for name, fn, inputs, kw in cases:
        xs = [t.detach().requires_grad_(True) for t in inputs]
        cot = torch.randn_like(fn(*xs, **kw))

        def both():
            torch.autograd.grad(fn(*xs, **kw), xs, cot)
        for _ in range(2):
            both()
        fwd = statistics.median(_event_ms(lambda: fn(*xs, **kw), 10))
        bwd = statistics.median(_event_ms(both, 10)) - fwd
        print(f"[train {cfg.name}] {name} at the train shape "
              f"{tuple(inputs[0].shape)}: forward (the kernel) {fwd:.3f} ms, "
              f"backward (the plain version's vjp) {bwd:.3f} ms a launch; "
              f"{per[name]} a microbatch of {rows} rows: {per[name] * bwd:.1f}"
              f" ms of backward")
        del xs, cot
    torch.cuda.empty_cache()


def _train_whole(device) -> dict[str, int]:
    """qwen2-vl-2b whole, trained 12 steps in bf16 (f32 master, bf16
    moments) through the kernels; see ``phase_train``."""
    import torch
    from repro_torch.kernels import flash_attention as fa_mod
    from repro_torch.models.model import build_model, loss_fn
    from repro_torch.optim import (adamw_update, clip_by_global_norm,
                                   cosine_schedule)
    from repro_torch.train.loop import TrainConfig, Trainer

    cfg = _train_cfg(TRAIN_ARCH)
    tag = f"[train {cfg.name}]"
    t0 = time.perf_counter()
    model = build_model(cfg, device, seed=None)
    tcfg = TrainConfig(microbatches=TRAIN_MICRO, warmup_steps=TRAIN_WARMUP,
                       total_steps=TRAIN_STEPS)
    trainer = Trainer(model, tcfg, seed=0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    check(model.cfg.use_kernel is True and cfg.remat,
          "the model on the card does not train through the kernels, or "
          "without remat")
    n_params = sum(p.numel() for p in trainer.params.values())
    batches = [train_batch(cfg, device, TRAIN_BATCH, seed=s) for s in (0, 1)]
    want = train_launches(cfg, TRAIN_MICRO)
    per_step = []

    def on_step(step, m):
        per_step.append(_lm_counts(launch_counts()))
        reset_launch_counts()

    torch.cuda.reset_peak_memory_stats(device)
    reset_launch_counts()
    log = trainer.run([batches[i % 2] for i in range(TRAIN_STEPS)],
                      on_step=on_step)
    counts = {n: sum(c[n] for c in per_step) for n in LM_KERNELS}
    peak_gb = torch.cuda.max_memory_allocated(device) / 1e9
    inst = fa_mod.last_instance()
    check(all(c == want for c in per_step),
          f"train steps launched {per_step}, not {want} each")
    check(inst == bf16_instance(cfg.head_dim), f"D = {cfg.head_dim} ran "
          f"the KD = {inst} instance of flash_attention, not "
          f"{bf16_instance(cfg.head_dim)}")
    losses = [m["loss"] for m in log]
    times = [m["step_time_s"] for m in log]
    p50 = statistics.median(times)
    tokens = TRAIN_BATCH * TRAIN_SEQ
    print(f"{tag} {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"{n_params / 1e9:.3f} B parameters in bf16 (f32 master, bf16 "
          f"moments), seeded on the card in {init_s:.3f} s; batch "
          f"{TRAIN_BATCH} x {TRAIN_SEQ} ({cfg.n_patches} patch embeddings a "
          f"row), {TRAIN_MICRO} microbatches, remat")
    print(f"{tag} {TRAIN_STEPS} steps: losses "
          + " ".join(f"{x:.4f}" for x in losses)
          + f"; grad norms " + " ".join(f"{m['grad_norm']:.3f}" for m in log))
    print(f"{tag} step time p50 {p50 * 1e3:.3f} ms (first {times[0] * 1e3:.1f}"
          f" ms, min {min(times) * 1e3:.3f}, max {max(times[1:]) * 1e3:.3f} "
          f"after it), {tokens / p50:.1f} tokens/s; peak memory "
          f"{peak_gb:.3f} GB; flash_attention {want['flash_attention']} "
          f"launches a step ({TRAIN_MICRO} microbatches x 2 x "
          f"{cfg.n_layers}, KD = {inst})")
    check(all(x == x and abs(x) < float("inf") for x in losses),
          f"a non-finite loss: {losses}")
    first, last = statistics.mean(losses[:3]), statistics.mean(losses[-3:])
    check(last < first, f"the loss did not fall: the first 3 steps' mean "
          f"{first:.4f}, the last 3's {last:.4f}")

    # the step split: each microbatch's forward and backward, then the
    # optimizer (clip, schedule, AdamW), each between synchronises
    params = trainer.params
    batch = batches[0]
    half = {k: v[:TRAIN_BATCH // TRAIN_MICRO] for k, v in batch.items()}
    fwd = bwd = 0.0
    for _ in range(TRAIN_MICRO):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, _ = loss_fn(model, half)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        loss.backward()
        torch.cuda.synchronize()
        fwd, bwd = fwd + t1 - t0, bwd + time.perf_counter() - t1
    grads = {n: p.grad for n, p in params.items()}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    grads, _ = clip_by_global_norm(grads, tcfg.max_grad_norm)
    scale = cosine_schedule(trainer.opt_state["step"], warmup=TRAIN_WARMUP,
                            total=TRAIN_STEPS)
    _, trainer.opt_state = adamw_update(grads, trainer.opt_state, params,
                                        tcfg.opt, scale)
    torch.cuda.synchronize()
    opt_s = time.perf_counter() - t0
    for p in params.values():
        p.grad = None
    del grads, loss
    # the least time the card could take: the step's products (8 x the
    # matmul parameters x tokens: forward, recompute and two in the
    # backward; every parameter but the embedding table's gather) at the
    # bf16 peak; the optimizer's bytes (26 a parameter: the gradient read
    # by the norm and the clip and written by the clip, m, v and the
    # master read and written, the bf16 parameter written) at HBM's rate
    n_mm = n_params - model.embedding.numel()
    gemm_ms = 8 * n_mm * tokens / PEAK_BF16_FLOP_PER_S * 1e3
    opt_ms = 26 * n_params / PEAK_BYTES_PER_S * 1e3
    print(f"{tag} one step split: forward {fwd * 1e3:.3f} ms, backward "
          f"(the remat recompute included) {bwd * 1e3:.3f} ms over "
          f"{TRAIN_MICRO} microbatches, optimizer (clip, schedule, AdamW "
          f"over {n_params / 1e9:.3f} B) {opt_s * 1e3:.3f} ms; bounds: the "
          f"step's products {gemm_ms:.1f} ms ({8 * n_mm * tokens:.3e} FLOP), "
          f"the optimizer's bytes {opt_ms:.1f} ms")
    reset_launch_counts()
    wall, dev, ops_ = device_profile(lambda: trainer.run([batch]), top=None)
    ours = [op for op in ops_ if "flash" in op[0]]
    print(f"{tag} profiled step, busy share: {busy_text(wall, dev)}"
          + (f"; an estimate across runs, not a busy share: its device "
             f"time over the unprofiled steps' p50 is {100 * dev / p50:.2f}%"
             if dev else "")
          + f"; top device ops: {top_text(ops_[:10])}"
          + (f"; flash_attention: {top_text(ours)}" if ours else ""))
    reset_launch_counts()

    # every launch of one microbatch's forward and backward against its
    # plain version on the step's activations
    _checked_train_grads(model, half, "bf16")
    _backward_split(device, cfg, TRAIN_BATCH // TRAIN_MICRO)
    del trainer, model, batches, batch, half
    torch.cuda.empty_cache()
    _train_f32_gate(device, TRAIN_ARCH, TRAIN_BATCH // TRAIN_MICRO)
    return counts


def _train_one_step(device, arch: str) -> tuple[dict[str, int], list]:
    """``TRAIN_ONE_STEPS`` bf16 train steps of ``arch`` (cut to
    ``TRAIN_ONE_STEP``'s depth) at batch 4 x 1024 through the kernels:
    exact launch counts, finite losses and gradient norms, every launch of
    a forward and backward held to its plain version, and the float32
    kernel-against-plain gate.  -> (the steps' launches, their losses)."""
    import torch
    from repro_torch.models.model import build_model
    from repro_torch.train.loop import Trainer

    full = _train_cfg(arch)
    cfg = _train_cfg(arch, TRAIN_ONE_STEP[arch])
    tag = f"[train {cfg.name}]"
    cut = (f" (cut: {cfg.n_layers} of its {full.n_layers} layers, full "
           f"width)" if cfg.n_layers < full.n_layers else "")
    model = build_model(cfg, device, seed=None)
    trainer = Trainer(model, one_step_train_config(), seed=0)
    n_params = sum(p.numel() for p in trainer.params.values())
    batches = [train_batch(cfg, device, TRAIN_ONE_BATCH, seed=s)
               for s in range(TRAIN_ONE_STEPS)]
    torch.cuda.reset_peak_memory_stats(device)
    reset_launch_counts()
    mets = trainer.run(batches)
    counts = _lm_counts(launch_counts())
    peak_gb = torch.cuda.max_memory_allocated(device) / 1e9
    want = {n: c * TRAIN_ONE_STEPS
            for n, c in train_launches(cfg, 1).items()}
    print(f"{tag} {cfg.n_layers} layers{cut}, {n_params / 1e9:.3f} B "
          f"parameters in bf16: {TRAIN_ONE_STEPS} steps at batch "
          f"{TRAIN_ONE_BATCH} x {TRAIN_SEQ} in " + " / ".join(
              f"{m['step_time_s'] * 1e3:.1f}" for m in mets)
          + " ms, losses " + " ".join(f"{m['loss']:.6f}" for m in mets)
          + ", grad norms " + " ".join(f"{m['grad_norm']:.4f}" for m in mets)
          + f", peak memory {peak_gb:.3f} GB; launches {counts}")
    check(counts == want, f"{TRAIN_ONE_STEPS} train steps launched {counts}, "
          f"not {want}")
    check(all(abs(m[k]) < float("inf") and m[k] == m[k]
              for m in mets for k in ("loss", "grad_norm")),
          f"a non-finite loss or gradient norm: {mets}")
    _checked_train_grads(model, batches[0], "bf16")
    del trainer, model, batches
    torch.cuda.empty_cache()
    _backward_split(device, cfg, TRAIN_ONE_BATCH)
    _train_f32_gate(device, arch, TRAIN_ONE_BATCH)
    return ({n: counts.get(n, 0) for n in _kernel_modules()},
            [m["loss"] for m in mets])


def one_step_train_config():
    """The schedule of phase 15's scan-family steps and of phase 17's
    split ones: no warmup over 10 steps (the first step's rate is 0)."""
    from repro_torch.train.loop import TrainConfig
    return TrainConfig(total_steps=10, warmup_steps=0)


def phase_train(device) -> tuple[dict[str, int], dict[str, list]]:
    """Phase 15 (see the module's docstring): (the counts of the three
    models' timed train steps, ``reset_launch_counts`` just before each
    and read just after; {arch: the bf16 losses} of the scan families'
    steps, which phase 17 holds its split steps to)."""
    import torch
    torch.cuda.empty_cache()
    counts = dict.fromkeys(_kernel_modules(), 0)
    losses = {}
    parts = [_train_whole(device)]
    for arch in TRAIN_ONE_STEP:
        part, losses[arch] = _train_one_step(device, arch)
        parts.append(part)
    for part in parts:
        for n, c in part.items():
            counts[n] += c
    return counts, losses


# --------------------------------------------------------------------- #
# phase 16: dist
# --------------------------------------------------------------------- #
# the schedule's first step has rate 0; the steps after the first are
# timed (host walls), their median compared
DIST_STEPS = 4
DIST_HISTORY = {"days": 2, "transfers_per_day": 150, "seed": 1}
DIST_GRADS = {"avg_file_mb": 1600.0, "n_files": 64}  # 64 x 1600 MB
DIST_PIPE_MICRO, DIST_PIPE_ROWS, DIST_PIPE_SEQ = 4, 2, 2048
DIST_TIMED = 5                  # CUDA-event runs of each collective
# an int8 round trip's worst error, in units of its chunk's scale s: half a
# step, plus float32 rounding of x / s (|x / s| <= 127) and of q * s
INT8_HALF_STEP = 0.5 + 2 * 127 * 2.0 ** -24


def _stacked_layers(model) -> dict:
    """The model's ``layers`` stack in the reference's layout: {leaf: (L,
    ...)} (one copy)."""
    from repro_torch.models.params import reference_paths
    flat = reference_paths(dict(model.named_parameters()))
    return {path[len("layers."):]: t for path, t in flat.items()
            if path.startswith("layers.")}


def _layer_slice(model, positions):
    """``layer_slice(params, x)`` of ``make_pipeline_fn`` for a dense stack:
    each layer of the sub-stack {leaf: (n, ...)} applied in order, by
    ``torch.func.functional_call`` over the model's first layer."""
    import torch
    from torch import nn
    from repro_torch.models.model import _dense_layer_fwd
    cfg = model.cfg

    class Layer(nn.Module):
        def __init__(self, layer):
            super().__init__()
            self.layer = layer

        def forward(self, x):
            return _dense_layer_fwd(self.layer, x, cfg, positions, "train")[0]

    one = Layer(model.layers[0])

    def layer_slice(params, x):
        n = next(iter(params.values())).shape[0]
        for i in range(n):
            x = torch.func.functional_call(
                one, {f"layer.{k}": v[i] for k, v in params.items()}, (x,))
        return x
    return layer_slice


def _dist_bridge(device):
    """The paper's tuner on the card's interconnect model; -> (tuned
    params, BucketPlan)."""
    from repro_torch.core import TransferTuner, TunerConfig
    from repro_torch.dist.collectives import (ici_environment,
                                              plan_from_tuner_params)
    from repro_torch.netsim import Dataset, generate_history
    env = ici_environment(seed=0)
    t0 = time.perf_counter()
    hist = generate_history(env, **DIST_HISTORY)
    tuner = TransferTuner(TunerConfig(seed=0, device=device)).fit(hist)
    fit_s = time.perf_counter() - t0
    grads = Dataset("gradients", "large", **DIST_GRADS)
    rep = tuner.transfer(ici_environment(seed=9), grads)
    plan = plan_from_tuner_params(rep.params)
    print(f"[dist] paper bridge: {len(hist)} history entries on "
          f"{env.link.name} ({env.link.bandwidth_mbps / 8000:.0f} GB/s a "
          f"direction, the tuner's model of the card's NVLink), fit in "
          f"{fit_s:.3f} s; {DIST_GRADS['n_files']} x "
          f"{DIST_GRADS['avg_file_mb']:.0f} MB gradient dataset: tuned "
          f"(cc, p, pp) = {rep.params.as_tuple()}, {rep.steady_mbps / 8000:.1f}"
          f" GB/s modelled -> {plan}")
    check(rep.achieved_mbps > 0 and plan.n_buckets >= 1
          and plan.chunks_per_bucket >= 1 and plan.pipeline_depth >= 1,
          f"the bridge gave no valid plan: {rep.params}, {plan}")
    return plan


def _dist_steps(device, mesh, plan, flat_out: list):
    """Phase 15's first ``DIST_STEPS`` steps of qwen2-vl-2b unsharded, then
    the same from the same seed and batches through the sharded step on
    ``mesh``: loss, gradient norm and every updated parameter equal bit for
    bit; the optimizer state rests as DTensors in the step's placements.
    ``flat_out`` receives the last step's flat float32 gradient (the input
    of its ``bucketed_allreduce``) and its spec.  Returns (the sharded
    model, its steps' launches, the unsharded steps' losses)."""
    import torch
    from torch.distributed.tensor import DTensor
    import repro_torch.train.loop as loop
    from repro_torch.models.model import build_model
    from repro_torch.models.params import paths_from_tree

    cfg = _train_cfg(TRAIN_ARCH)
    tag = f"[dist {cfg.name}]"
    tcfg = loop.TrainConfig(microbatches=TRAIN_MICRO,
                            warmup_steps=TRAIN_WARMUP,
                            total_steps=TRAIN_STEPS)
    batches = [train_batch(cfg, device, TRAIN_BATCH, seed=s) for s in (0, 1)]
    want_launches = train_launches(cfg, TRAIN_MICRO)
    runs = []
    for sharded in (False, True):
        model = build_model(cfg, device, seed=None)
        _, opt = loop.init_train_state(model, 0, tcfg)
        step = loop.make_train_step(model, tcfg, mesh=mesh if sharded
                                    else None, plan=plan)
        seen = []
        original = loop.bucketed_allreduce

        def spy(v, plan_, group=None):
            seen[:] = [v]
            return original(v, plan_, group)
        loop.bucketed_allreduce = spy
        mets, counts, times = [], [], []
        torch.cuda.reset_peak_memory_stats(device)
        try:
            for i in range(DIST_STEPS):
                reset_launch_counts()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                opt, m = step(opt, batches[i % 2])
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
                counts.append(_lm_counts(launch_counts()))
                mets.append(m)
        finally:
            loop.bucketed_allreduce = original
        peak = torch.cuda.max_memory_allocated(device) / 1e9
        print(f"{tag} {'sharded on ' + str(tuple(mesh.shape)) if sharded else 'unsharded'}"
              f": {DIST_STEPS} steps of {TRAIN_BATCH} x {TRAIN_SEQ}, "
              f"{TRAIN_MICRO} microbatches, remat; losses "
              + " ".join(f"{float(m['loss']):.6f}" for m in mets)
              + "; grad norms " + " ".join(f"{float(m['grad_norm']):.6f}"
                                          for m in mets)
              + "; step times " + " ".join(f"{t * 1e3:.1f}" for t in times)
              + f" ms; peak memory {peak:.3f} GB; launches {counts}")
        check(bool(seen) == sharded, "the sharded step did not reduce its "
              "gradients through bucketed_allreduce" if sharded else
              "the unsharded step reduced its gradients")
        if not sharded:
            want = ([(m["loss"], m["grad_norm"]) for m in mets],
                    {n: p.detach().clone() for n, p in model.named_parameters()})
            base_s = statistics.median(times[1:])
            del model, opt, step
            torch.cuda.empty_cache()
            continue
        check(all(c == want_launches for c in counts),
              f"the sharded steps launched {counts}, not {want_launches} each")
        for (lw, gw), m in zip(want[0], mets):
            check(torch.equal(m["loss"], lw) and torch.equal(m["grad_norm"], gw),
                  f"the sharded step's loss {float(m['loss'])!r} or gradient "
                  f"norm {float(m['grad_norm'])!r} differs from the unsharded "
                  f"step's {float(lw)!r}, {float(gw)!r}")
        differ = [n for n, p in model.named_parameters()
                  if not torch.equal(p, want[1][n])]
        check(not differ, f"{len(differ)} parameters differ from the "
              f"unsharded step's, first {differ[:3]}")
        placed = paths_from_tree(opt)
        rest = step.shardings["opt_state"]
        wrong = [p for p, leaf in placed.items()
                 if not isinstance(leaf, DTensor)
                 or leaf.placements != rest[p].placements]
        check(not wrong, f"optimizer state not at rest in its placements: "
              f"{wrong[:3]}")
        print(f"{tag} sharded = unsharded bit for bit: {DIST_STEPS} losses "
              f"and gradient norms, {len(want[1])} parameters; "
              f"{len(placed)} optimizer leaves at rest as DTensors in "
              f"their placements; the sharded steps after the first took "
              f"{(statistics.median(times[1:]) - base_s) * 1e3:.1f} ms more "
              f"than the unsharded ones (medians of {DIST_STEPS - 1} host "
              f"walls each)")
        spec = [((n,), tuple(p.shape), p.dtype)
                for n, p in model.named_parameters()]
        flat_out[:] = [seen[0], spec]
        total = {n: sum(c[n] for c in counts) for n in LM_KERNELS}
        losses = [float(lw) for lw, _ in want[0]]
        del want, opt, step, seen
        torch.cuda.empty_cache()
        return model, total, losses


def _dist_collectives(device, mesh, plan, flat, spec) -> None:
    """Flatten and both all-reduces of the step's whole gradient on the
    1-rank group: exact, and int8 within half a step of each chunk's
    scale; each timed by CUDA events beside its bytes bound."""
    import torch
    from repro_torch.dist.collectives import (flatten_grads,
                                              bucketed_allreduce,
                                              quantized_allreduce,
                                              unflatten_grads)
    group = (mesh, "data")
    n = flat.numel()
    tree = unflatten_grads(flat, spec)
    again, _ = flatten_grads(tree)
    check(torch.equal(again, flat), "flatten(unflatten(g)) != g")
    del again
    out = bucketed_allreduce(flat, plan, group)
    check(torch.equal(out, flat), "the 1-rank bucketed all-reduce is not "
          "exact")
    del out
    q = quantized_allreduce(flat, plan, group)
    per = -(-n // plan.n_chunks)
    worst = 0.0
    for c in range(plan.n_chunks):
        x, y = flat[c * per:(c + 1) * per], q[c * per:(c + 1) * per]
        if x.numel() == 0:
            continue
        s = (x.abs().amax() / 127.0 + 1e-12).item()
        worst = max(worst, (y - x).abs().amax().item() / s)
    del q
    check(worst <= INT8_HALF_STEP, f"the int8 all-reduce is {worst} of a "
          f"chunk's scale away, past {INT8_HALF_STEP}")
    # bytes the passes move: flatten reads each bf16 gradient and writes
    # float32; both all-reduces read the float32 vector and write their
    # float32 result (the input read once, the output written once)
    src_bytes = sum(torch.empty((), dtype=dt).element_size() * math.prod(sh)
                    for _, sh, dt in spec)
    cases = [("flatten_grads", lambda: flatten_grads(tree),
              src_bytes + 4 * n),
             ("bucketed_allreduce", lambda: bucketed_allreduce(
                 flat, plan, group), 8 * n),
             ("quantized_allreduce", lambda: quantized_allreduce(
                 flat, plan, group), 8 * n)]
    for name, run, n_bytes in cases:
        run()
        torch.cuda.synchronize()
        ms = statistics.median(_event_ms(run, DIST_TIMED))
        b_ms = n_bytes / PEAK_BYTES_PER_S * 1e3
        print(f"[dist] {name} of the step's {n / 1e9:.3f} B-element "
              f"gradient ({4 * n / 1e9:.2f} GB in float32), plan {plan}: "
              f"{ms:.3f} ms (median of {DIST_TIMED}, CUDA events; a 1-rank "
              f"figure, no NCCL bandwidth in it), bytes bound {b_ms:.3f} ms "
              f"({n_bytes / 1e9:.2f} GB at 3.35 TB/s), "
              f"{100 * b_ms / ms:.1f}% of it")
    print(f"[dist] the 1-rank bucketed all-reduce returns the gradient bit "
          f"for bit; the int8 one is within {worst:.6f} of a chunk's scale "
          f"(gate {INT8_HALF_STEP:.6f}); peak memory "
          f"{torch.cuda.max_memory_allocated(device) / 1e9:.3f} GB")


def _dist_pipeline(device, model) -> dict[str, int]:
    """``make_pipeline_fn`` at S = 1 over qwen2-vl-2b's 28 layers, M = 4
    microbatches of 2 x 2048, against the sequential stack; -> its
    launches."""
    import torch
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.dist.pipeline_par import (PipelineConfig,
                                               make_pipeline_fn,
                                               split_stages)
    from repro_torch.launch.serve import make_prompts
    cfg = model.cfg
    M, B, S = DIST_PIPE_MICRO, DIST_PIPE_ROWS, DIST_PIPE_SEQ
    tokens = make_prompts(cfg, M * B, S, seed=7, device=device)
    with torch.no_grad():
        xs = model.embed(tokens).reshape(M, B, S, cfg.d_model)
        stacked = _stacked_layers(model)
        layer_slice = _layer_slice(model, model._positions(tokens[:B]))
        mesh = init_device_mesh("cuda", (1,), mesh_dim_names=("stage",))
        pcfg = PipelineConfig(1, M)
        fn = make_pipeline_fn(layer_slice, mesh, pcfg)
        stages = split_stages(stacked, 1)
        reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = fn(stages, xs)
        torch.cuda.synchronize()
        pipe_s = time.perf_counter() - t0
        counts = _lm_counts(launch_counts())
        t0 = time.perf_counter()
        want = torch.stack([layer_slice(stacked, x) for x in xs])
        torch.cuda.synchronize()
        seq_s = time.perf_counter() - t0
    reset_launch_counts()
    n_launch = cfg.n_layers * (M + pcfg.n_stages - 1)
    print(f"[dist] pipeline: S = 1, M = {M} microbatches of {B} x {S} over "
          f"{cfg.name}'s {cfg.n_layers} layers ({M + pcfg.n_stages - 1} "
          f"ticks, bubble {pcfg.bubble_fraction:.2f}) in {pipe_s * 1e3:.1f} "
          f"ms, the sequential stack in {seq_s * 1e3:.1f} ms; launches "
          f"{counts}")
    check(torch.equal(got, want), "the pipeline's output differs from the "
          "sequential stack's")
    check(counts["flash_attention"] == n_launch and counts["ssd_scan"] == 0
          and counts["rwkv6"] == 0 and counts["decode_attention"] == 0,
          f"the pipeline launched {counts}, not {n_launch} flash_attention")
    return counts


def _dist_recover(device, model) -> None:
    """``recover`` of a checkpoint of the trained parameters onto the
    (1, 1) mesh: every leaf ``torch.equal`` and in its placements."""
    import tempfile
    import torch
    from repro_torch.checkpoint.ckpt import save_checkpoint
    from repro_torch.dist.sharding import default_rules, tree_shardings
    from repro_torch.train import elastic
    params = dict(model.named_parameters())
    axes = model.param_axes()
    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        save_checkpoint(d, 1, params)
        save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        plan, mesh, state = elastic.recover(d, axes, [0])
        torch.cuda.synchronize()
        rec_s = time.perf_counter() - t0
    want = tree_shardings(params, axes, mesh, default_rules(False))
    bad = [p for p, t in params.items()
           if not torch.equal(state[p].to_local(), t)
           or state[p].placements != want[p].placements
           or state[p].device_mesh.device_type != "cuda"]
    print(f"[dist] recover: {len(params)} leaves ({sum(t.numel() for t in params.values()) / 1e9:.3f} B parameters) "
          f"saved in {save_s:.2f} s, planned {plan.shape}, carved, restored "
          f"and resharded onto the card in {rec_s:.2f} s")
    check(plan.shape == (1, 1) and tuple(mesh.shape) == (1, 1),
          f"recovery planned {plan.shape}, not (1, 1)")
    check(not bad, f"{len(bad)} recovered leaves differ or are misplaced, "
          f"first {bad[:3]}")


def phase_dist(device) -> tuple[dict[str, int], list[float]]:
    """Phase 16 (see the module's docstring): the launches of the sharded
    train steps and of the pipeline (``reset_launch_counts`` just before
    each, read just after), and the unsharded steps' losses (phase 17's
    bf16 band)."""
    import torch
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_host_mesh
    torch.cuda.empty_cache()
    t_start = time.perf_counter()
    # one rank on the card; a failed NCCL start fails the run
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        mesh = make_host_mesh()
        check(tuple(mesh.shape) == (1, 1) and mesh.device_type == "cuda"
              and dist.get_backend() == "nccl",
              f"the host mesh is {mesh}, backend {dist.get_backend()}")
        plan = _dist_bridge(device)
        flat = []
        model, counts, losses = _dist_steps(device, mesh, plan, flat)
        torch.cuda.reset_peak_memory_stats(device)
        _dist_collectives(device, mesh, plan, *flat)
        del flat
        torch.cuda.empty_cache()
        for name, c in _dist_pipeline(device, model).items():
            counts[name] += c
        _dist_recover(device, model)
        del model
        torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    print(f"[dist] phase done in {time.perf_counter() - t_start:.1f} s")
    return {n: counts.get(n, 0) for n in _kernel_modules()}, losses


# --------------------------------------------------------------------- #
# phase 17: tp
# --------------------------------------------------------------------- #
TP_RANKS = 2                    # processes sharing the one card
TP_SERVE_STEPS = 8              # greedy decode steps after the prefill
TP_F32_LAYERS = 2               # the float32 control's depth
TP_F32_RTOL = 1e-5
# the split bf16 steps' losses against phase 16's unsharded steps' from
# the same seed and batches, relative: one bf16 rounding of the loss, the
# band tests/test_torch_tensor_parallel.py holds the CPU to
# (BF16_LOSS_RTOL)
TP_BF16_LOSS_RTOL = 2.0 ** -8
# the most a caching-allocator block holds past the storage it was asked
# for: the request rounded up to 512 B, plus an unsplit remainder of its
# segment, which the allocator splits off only past 1 MiB
ALLOC_OVERHANG = 2 ** 20 + 511
# the scan families split over the same (1, 2) mesh after qwen2-vl-2b:
# phase 15's bf16 steps (zamba2-7b at 6 layers, rwkv6-1.6b whole, batch
# 4 x 1024, their losses held to phase 15's), then each at full width
# through a prefill of 8 x 2048 and 8 decode steps, rwkv6-1.6b whole and
# zamba2-7b at TP_SERVE_LAYERS: its 81-layer split prefill took 22.6 s a
# rank through gloo, and the run must make room for the FSDP part
TP_SCAN_ARCHS = ("zamba2-7b", "rwkv6-1.6b")
TP_SERVE_LAYERS = {"zamba2-7b": 27}         # 4 shared-block applications
# the MoE family split over the same mesh after them, without a train step
# (a rank's share of either's training state does not fit beside the
# other's): full width at these depths (mixtral-8x22b at phase 12's 8;
# deepseek-v3-671b's 3 dense and 1 MoE layers: at phase 14's 5 the two
# ranks' weights, 26.7 GB each, and their checked prefills would take
# ~70 GB of the card's 80), a prefill of 8 x 2048 and TP_SERVE_STEPS
# decode steps
TP_MOE_ARCHS = ("mixtral-8x22b", MLA_ARCH)
TP_MOE_LAYERS = {"mixtral-8x22b": 8, MLA_ARCH: 4}
# the float32 control's depth: mixtral-8x22b's 2 MoE layers (9.7 GB each
# in float32, split by experts), deepseek-v3-671b's 3 dense MLA layers (a
# float32 MoE layer is 45 GB; its split experts are held in bf16 by
# ``_moe_layer_check``)
TP_F32_MOE_LAYERS = {"mixtral-8x22b": 2, MLA_ARCH: 3}
# the split MoE layer's bf16 output against the unsplit layer's on the same
# activations.  A token's output sums its experts' and the shared
# expert's outputs in bf16 in another order split (each rank's partial
# sum rounded, then the two): a few roundings of 2^-9 of the partial sums.
# Over the whole output, relative L2, within MOE_BF16_L2 (two roundings);
# a token's largest gap over its largest output element, the worst of
# 16,384 tokens, within MOE_BF16_TOKEN: where a token's terms cancel its
# partial sums exceed its output (deepseek-v3-671b's worst token read
# 1.18e-2 and 1.41e-2 of its scale at 4 and 5 layers), and a pair dropped
# or sent to another expert moves a token by its gate's share, ~1/k of its
# scale (1/8 for deepseek, 1/2 for mixtral)
MOE_BF16_L2 = 2.0 ** -7
MOE_BF16_TOKEN = 2.0 ** -4
TP_TIMEOUT_S = 800              # both ranks; a passing phase takes < 500 s
TP_COLLECTIVE_TIMEOUT_S = 120   # a rank waiting past this raises


def tp_worker(rank: int, directory: str) -> int:
    """One rank of phase 17, in a process of its own: joins the gloo group
    on a ``FileStore`` in ``directory``, runs ``_tp_model`` of qwen2-vl-2b
    and of each of ``TP_SCAN_ARCHS``, then ``_tp_moe`` of each of
    ``TP_MOE_ARCHS``, then ``_fsdp_model``, and writes their results to
    ``rank<r>.json`` there.  A failure raises (exit 1)."""
    import datetime
    import torch
    import torch.distributed as dist
    sys.path.insert(0, str(SRC))
    torch.backends.cuda.matmul.allow_tf32 = False     # as main() sets it
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    dist.init_process_group(
        "gloo", store=dist.FileStore(f"{directory}/store", TP_RANKS),
        rank=rank, world_size=TP_RANKS,
        timeout=datetime.timedelta(seconds=TP_COLLECTIVE_TIMEOUT_S))
    try:
        out = {arch: _tp_model(rank, device, arch)
               for arch in (TRAIN_ARCH,) + TP_SCAN_ARCHS}
        out.update({arch: _tp_moe(rank, device, arch)
                    for arch in TP_MOE_ARCHS})
        out["fsdp"] = _fsdp_model(rank, device)
    finally:
        dist.destroy_process_group()
    with open(f"{directory}/rank{rank}.json", "w") as f:
        json.dump(out, f)
    return 0


def _tp_model(rank: int, device, arch: str) -> dict:
    """Phase 17 for ``arch`` on one rank (see ``phase_tp``), split over the
    (1, 2) mesh: its train steps (qwen2-vl-2b: phase 16's 4 steps of 8 x
    1024 in 2 microbatches; a scan family: phase 15's ``TRAIN_ONE_STEPS``
    at its depth and batch), exact launches a step, a microbatch's forward
    and backward with every launch held to its plain version; then at full
    depth, or ``TP_SERVE_LAYERS`` (the trained model, or one from the seed
    where training cut the depth), a prefill of 8 x 2048 and
    ``TP_SERVE_STEPS`` decode steps after a first-use run, exact launches, a prefill and a decode step with
    every launch held to its plain version; and the float32 control.  ->
    its losses, launches, times and peaks."""
    import torch
    import repro_torch.train.loop as loop
    from repro_torch.launch.serve import make_prompts, serve
    from repro_torch.models.model import build_model

    device = torch.device(device)
    tag = f"[tp rank {rank} {arch}]"
    mesh = _tp_mesh(device)
    whole = arch == TRAIN_ARCH
    cfg = _train_cfg(arch, None if whole else TRAIN_ONE_STEP[arch])
    tcfg = (loop.TrainConfig(microbatches=TRAIN_MICRO,
                             warmup_steps=TRAIN_WARMUP,
                             total_steps=TRAIN_STEPS) if whole
            else one_step_train_config())
    rows = TRAIN_BATCH if whole else TRAIN_ONE_BATCH
    n_steps = DIST_STEPS if whole else TRAIN_ONE_STEPS
    t0 = time.perf_counter()
    model = build_model(cfg, device, seed=None, mesh=mesh)
    _, opt = loop.init_train_state(model, 0, tcfg)
    torch.cuda.synchronize()
    plan = model.split_plan
    check(model.cfg.use_kernel is True and all(plan.split.values()),
          f"{tag} at model = {TP_RANKS} does not split every region on the "
          f"kernel route: {plan.describe()}")
    n_local = sum(p.numel() for p in model.parameters())
    print(f"{tag} {plan.describe()}; {cfg.n_layers} layers, "
          f"{n_local / 1e9:.3f} B parameters on this rank, built whole from "
          f"the seed and cut in {time.perf_counter() - t0:.2f} s")
    step = loop.make_train_step(model, tcfg, mesh=mesh)
    batches = [train_batch(cfg, device, rows, seed=s) for s in (0, 1)]
    want = train_launches(cfg, tcfg.microbatches)
    counts = dict.fromkeys(_kernel_modules(), 0)
    mets, times = [], []
    torch.cuda.reset_peak_memory_stats(device)
    for i in range(n_steps):
        reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        opt, m = step(opt, batches[i % 2])
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        got = _lm_counts(launch_counts())
        check(got == want, f"{tag} split step {i} launched {got}, not {want}")
        for n, c in got.items():
            counts[n] += c
        mets.append({k: float(v) for k, v in m.items()})
    train_peak = torch.cuda.max_memory_allocated(device) / 1e9
    p50 = statistics.median(times[1:])
    print(f"{tag} {n_steps} split steps of {rows} x {TRAIN_SEQ}, "
          f"{tcfg.microbatches} microbatch(es), remat: losses "
          + " ".join(f"{m['loss']:.6f}" for m in mets) + "; grad norms "
          + " ".join(f"{m['grad_norm']:.6f}" for m in mets) + "; step times "
          + " ".join(f"{t * 1e3:.1f}" for t in times) + f" ms (p50 of steps "
          f"2-{n_steps}: {p50 * 1e3:.1f} ms); peak memory {train_peak:.3f} "
          f"GB; launches a step {want}")
    micro = {k: v[:rows // tcfg.microbatches] for k, v in batches[0].items()}
    reset_launch_counts()
    _checked_train_grads(model, micro, f"bf16 split, rank {rank}")
    reset_launch_counts()
    del opt, step, batches, micro
    model.requires_grad_(False)
    if cfg.n_layers != _train_cfg(arch, TP_SERVE_LAYERS.get(arch)).n_layers:
        del model
        torch.cuda.empty_cache()
        cfg = _train_cfg(arch, TP_SERVE_LAYERS.get(arch))
        model = build_model(cfg, device, seed=0, mesh=mesh)
    torch.cuda.empty_cache()

    prompts = make_prompts(cfg, SERVE_BATCH, SERVE_PROMPT, seed=0,
                           device=device)
    pe = serve_patch_embeds(cfg, device)
    # first use of each path, on one prompt: a rank's prefill of 8 moves
    # its partial sums through gloo's host copies for tens of seconds
    serve(model, prompts[:1], 2, patch_embeds=None if pe is None else pe[:1])
    torch.cuda.reset_peak_memory_stats(device)
    reset_launch_counts()
    res = serve(model, prompts, TP_SERVE_STEPS + 1, patch_embeds=pe)
    got = _lm_counts(launch_counts())
    serve_peak = torch.cuda.max_memory_allocated(device) / 1e9
    want_serve = lm_launches(cfg, 1, TP_SERVE_STEPS)
    check(got == want_serve, f"{tag} a split prefill and {TP_SERVE_STEPS} "
          f"decode steps launched {got}, not {want_serve}")
    for n, c in got.items():
        counts[n] += c
    print(f"{tag} {cfg.n_layers} layers: split prefill of {SERVE_BATCH} x "
          f"{SERVE_PROMPT}" + (f" ({cfg.n_patches} patch embeddings a row)"
                               if pe is not None else "")
          + f" in {res.prefill_ms:.3f} ms, {TP_SERVE_STEPS} greedy decode "
          f"steps p50 {res.decode_p50_ms():.3f} ms; peak memory "
          f"{serve_peak:.3f} GB; launches {got}")
    check(res.tokens.shape == (SERVE_BATCH, TP_SERVE_STEPS + 1)
          and bool((res.tokens >= 0).all()
                   and (res.tokens < cfg.vocab_size).all()),
          f"{tag} greedy tokens {tuple(res.tokens.shape)} out of range")
    reset_launch_counts()
    _check_on_activations(model, prompts, f"bf16 split, rank {rank}", pe)
    reset_launch_counts()
    out = {"losses": [m["loss"] for m in mets],
           "grad_norms": [m["grad_norm"] for m in mets],
           "step_p50_ms": p50 * 1e3, "train_peak_gb": train_peak,
           "serve_peak_gb": serve_peak, "prefill_ms": res.prefill_ms,
           "decode_p50_ms": res.decode_p50_ms(), "tokens": res.tokens.tolist(),
           "counts": counts}
    del model, res, prompts, pe
    torch.cuda.empty_cache()
    out["control"], _, _ = _tp_f32_control(device, mesh, tag, arch)
    return out


def _init_in_turn(model, seed: int) -> None:
    """``model.init(seed)`` on each rank of the default group in turn, the
    cache emptied after: a split leaf is drawn whole in float32 before its
    block is kept (deepseek-v3-671b's expert stacks: 15 GB a leaf), and two
    ranks drawing at once on one card would hold two such draws."""
    import torch
    import torch.distributed as dist
    for r in range(dist.get_world_size()):
        if dist.get_rank() == r:
            model.init(seed)
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
        dist.barrier()


def _tp_moe(rank: int, device, arch: str) -> dict:
    """Phase 17 for the MoE family's ``arch`` on one rank (see the
    module's docstring), split over the (1, 2) mesh at full width and
    ``TP_MOE_LAYERS`` layers, seeded a rank at a time: a prefill of 8 x
    2048 and ``TP_SERVE_STEPS`` decode steps after a first-use run, exact
    launches; a prefill and a decode step with every launch held to its
    plain version (``_check_on_activations``, MLA's plain attention by
    batch row past ``PLAIN_SCORES_BYTES``), whose first MoE layer's input
    ``_moe_layer_check`` then takes; the float32 control.  -> its launches,
    times, peak and tokens."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import make_prompts, serve
    from repro_torch.models import moe as moe_mod
    from repro_torch.models.model import build_model

    device = torch.device(device)
    tag = f"[tp rank {rank} {arch}]"
    mesh = _tp_mesh(device)
    full = get_config(arch, "full")
    cfg = dataclasses.replace(full, n_layers=TP_MOE_LAYERS[arch])
    t0 = time.perf_counter()
    model = build_model(cfg, device, seed=None, mesh=mesh)
    _init_in_turn(model, 0)
    plan = model.split_plan
    runs = plan.runs()
    check(model.cfg.use_kernel is True and runs["experts"]
          and all(v for k, v in runs.items() if k != "expert mlp"),
          f"{tag} at model = {TP_RANKS} does not split every region on the "
          f"kernel route: {plan.describe()}")
    n_local = sum(p.numel() for p in model.parameters())
    print(f"{tag} {plan.describe()}; {cfg.n_layers} of {full.n_layers} "
          f"layers" + (f" ({cfg.first_k_dense} dense, "
                       f"{cfg.n_layers - cfg.first_k_dense} MoE)"
                       if cfg.first_k_dense else "")
          + f", {n_local / 1e9:.3f} B parameters on this rank, built whole "
          f"from the seed a rank at a time and cut in "
          f"{time.perf_counter() - t0:.2f} s")
    prompts = make_prompts(cfg, SERVE_BATCH, SERVE_PROMPT, seed=0,
                           device=device)
    serve(model, prompts[:1], 2)        # first use of each path
    torch.cuda.reset_peak_memory_stats(device)
    reset_launch_counts()
    res = serve(model, prompts, TP_SERVE_STEPS + 1)
    counts = _lm_counts(launch_counts())
    serve_peak = torch.cuda.max_memory_allocated(device) / 1e9
    want = lm_launches(cfg, 1, TP_SERVE_STEPS)
    check(counts == want, f"{tag} a split prefill and {TP_SERVE_STEPS} "
          f"decode steps launched {counts}, not {want}")
    print(f"{tag} {cfg.n_layers} layers: split prefill of {SERVE_BATCH} x "
          f"{SERVE_PROMPT} in {res.prefill_ms:.3f} ms, {TP_SERVE_STEPS} "
          f"greedy decode steps p50 {res.decode_p50_ms():.3f} ms; peak "
          f"memory {serve_peak:.3f} GB; launches {counts}")
    check(res.tokens.shape == (SERVE_BATCH, TP_SERVE_STEPS + 1)
          and bool((res.tokens >= 0).all()
                   and (res.tokens < cfg.vocab_size).all()),
          f"{tag} greedy tokens {tuple(res.tokens.shape)} out of range")
    out = {"prefill_ms": res.prefill_ms, "decode_p50_ms": res.decode_p50_ms(),
           "serve_peak_gb": serve_peak, "tokens": res.tokens.tolist(),
           "counts": {**dict.fromkeys(_kernel_modules(), 0), **counts}}
    del res
    torch.cuda.empty_cache()

    seen = []
    forward = moe_mod.moe_forward

    def first_input(p, x, cfg_):
        if not seen:
            seen.append(x.clone())
        return forward(p, x, cfg_)
    plain = ops.plain_attention
    heads = model.layers[0].attn.wo.shape[0]     # the rank's q heads
    if SERVE_BATCH * heads * SERVE_PROMPT ** 2 * 4 > PLAIN_SCORES_BYTES:
        ops.plain_attention = plain_attention_by_row(plain)
    moe_mod.moe_forward = first_input
    torch.cuda.reset_peak_memory_stats(device)
    try:
        reset_launch_counts()
        _check_on_activations(model, prompts, f"bf16 split, rank {rank}")
        reset_launch_counts()
    finally:
        moe_mod.moe_forward, ops.plain_attention = forward, plain
    out["check_peak_gb"] = torch.cuda.max_memory_allocated(device) / 1e9
    print(f"{tag} the checked prefill and decode step's peak memory "
          f"{out['check_peak_gb']:.3f} GB")
    layer = model.layers[0].moe
    del model, prompts
    torch.cuda.empty_cache()
    out["moe_layer"] = _moe_layer_check(layer, seen[0], cfg, device, tag)
    del layer, seen
    torch.cuda.empty_cache()
    out["control"], _, _ = _tp_f32_control(device, mesh, tag, arch)
    return out


def _moe_layer_check(layer, h, cfg, device, tag: str) -> float:
    """The split MoE ``layer``'s bf16 output on ``h`` (the activations that
    reach it in a checked prefill) against the unsplit layer's: rank 0
    assembles the whole layer from every rank's blocks (each broadcast by
    its owner in turn) and runs it whole; the relative L2 gap within
    ``MOE_BF16_L2``, each token's largest gap within ``MOE_BF16_TOKEN`` of
    its largest output element.  -> the larger of the two over its gate
    (rank 0; 0 elsewhere)."""
    import torch
    import torch.distributed as dist
    from repro_torch.models import moe as moe_mod
    from repro_torch.models.params import InitCtx, cut_ranges
    mg = layer.tp.mg
    whole = (moe_mod.moe_init(cfg, InitCtx(cfg.dtype, device))
             if mg.rank == 0 else None)
    with torch.no_grad():
        for name, p in layer.named_parameters():
            cut = getattr(p, "cut", None)
            if cut is None:
                if whole is not None:
                    whole.get_parameter(name).copy_(p)
                continue
            dim = cut[0]
            for r in range(mg.size):
                block = p.detach().clone() if r == mg.rank else                     torch.empty_like(p)
                dist.broadcast(block, dist.get_global_rank(mg.group, r),
                               group=mg.group)
                if whole is not None:
                    w = whole.get_parameter(name)
                    lo, hi = cut_ranges((dim, r, mg.size), w.shape[dim])[0]
                    w.narrow(dim, lo, hi - lo).copy_(block)
                del block
        t0 = time.perf_counter()
        got, _ = moe_mod.moe_forward(layer, h, cfg)
        torch.cuda.synchronize()
        split_s = time.perf_counter() - t0
        ratio = 0.0
        if whole is not None:
            want, _ = moe_mod.moe_forward(whole, h, cfg)
            diff = got.float() - want.float()
            l2 = (diff.norm() / want.float().norm()).item()
            token = (diff.abs().amax(-1)
                     / want.float().abs().amax(-1)).max().item()
            n_e = layer.tp.experts(cfg.n_experts)[1]
            print(f"{tag} the first MoE layer split ({n_e} of "
                  f"{cfg.n_experts} experts a rank, {split_s:.3f} s) against "
                  f"the unsplit layer on this rank, bf16, on the checked "
                  f"prefill's {h.shape[0]} x {h.shape[1]} activations: "
                  f"relative L2 gap {l2:.3e} (gate {MOE_BF16_L2:g}), a "
                  f"token's largest gap at most {token:.3e} of its largest "
                  f"output element (gate {MOE_BF16_TOKEN:g})")
            check(l2 <= MOE_BF16_L2 and token <= MOE_BF16_TOKEN,
                  f"{tag} the split MoE layer's output differs from the "
                  f"unsplit one's: relative L2 {l2:.3e}, a token's "
                  f"{token:.3e} of its scale")
            ratio = max(l2 / MOE_BF16_L2, token / MOE_BF16_TOKEN)
            del whole, want, diff
        del got
    dist.barrier()
    return ratio


def _tp_mesh(device, shape=(1, TP_RANKS)):
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(device.type, shape,
                            mesh_dim_names=("data", "model"))


def _allocator_blocks(ptrs) -> dict[int, int]:
    """{address: size} of the caching allocator's allocated blocks that
    start at the addresses ``ptrs`` (``torch.cuda.memory_snapshot``)."""
    import torch
    want, found = set(ptrs), {}
    for seg in torch.cuda.memory_snapshot():
        addr = seg["address"]
        for block in seg["blocks"]:
            addr = block.get("address", addr)
            if block["state"] == "active_allocated" and addr in want:
                found[addr] = block["size"]
            addr += block["size"]
    return found


def _fsdp_model(rank: int, device) -> dict:
    """Phase 17's FSDP part on one rank: qwen2-vl-2b whole, at full width,
    cut over the ``data`` axis of a (``TP_RANKS``, 1) mesh (``dist.fsdp``:
    each weight's ``embed`` dim, one layer gathered at a time, the
    gradients reduce-scattered back).  Its resting parameter bytes (their
    storages) at most half the whole model's plus the leaves the rules
    leave whole, and ``torch.cuda.memory_allocated`` across the build at
    most that plus what the allocator's blocks of the parameters hold past
    their storages (``_allocator_blocks``; each at most
    ``ALLOC_OVERHANG``); phase 16's 4 steps of 8 x 1024
    in 2 microbatches, this rank taking its 2 rows of each, exact
    launches a step; a microbatch's forward and backward with every
    launch held to its plain version; a prefill of this rank's 4 of the 8
    x 2048 prompts and ``TP_SERVE_STEPS`` decode steps (no first-use run:
    the steps warmed the path, and each decode step gathers every weight
    through gloo), exact launches; a checked prefill and decode step; the float32
    control at ``TP_F32_LAYERS`` on this rank's rows.  -> its losses,
    launches, times, peaks, resting bytes and the control's tokens."""
    import math
    import torch
    import repro_torch.train.loop as loop
    from repro_torch.dist import fsdp
    from repro_torch.dist.sharding import batch_block
    from repro_torch.launch.serve import make_prompts, serve
    from repro_torch.models.model import build_model
    from repro_torch.models.params import whole_shape

    device = torch.device(device)
    tag = f"[fsdp rank {rank} {TRAIN_ARCH}]"
    mesh = _tp_mesh(device, (TP_RANKS, 1))
    cfg = _train_cfg(TRAIN_ARCH)
    tcfg = loop.TrainConfig(microbatches=TRAIN_MICRO,
                            warmup_steps=TRAIN_WARMUP,
                            total_steps=TRAIN_STEPS)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated(device)
    model = build_model(cfg, device, seed=None, mesh=mesh)
    torch.cuda.synchronize()
    resting = torch.cuda.memory_allocated(device) - before
    params = list(model.parameters())
    whole = sum(math.prod(whole_shape(p)) * p.element_size() for p in params)
    kept = sum(p.numel() * p.element_size() for p in params
               if not hasattr(p, "data_cut"))
    own = sum(p.untyped_storage().nbytes() for p in params)
    bound = whole / 2 + kept
    # the caching allocator's blocks that hold the parameters, from its
    # own snapshot: a block is the request rounded up to 512 B, plus the
    # remainder of its segment where that is 1 MiB or less (unsplit)
    blocks = _allocator_blocks(p.untyped_storage().data_ptr()
                               for p in params)
    over = [blocks.get(p.untyped_storage().data_ptr(), -1)
            - p.untyped_storage().nbytes() for p in params]
    slack = sum(over)
    print(f"{tag} {fsdp.describe(model)}; {model.split_plan.describe()}; "
          f"this rank's parameters {own} B (their storages), "
          f"torch.cuda.memory_allocated across the build {resting} B, "
          f"against the whole model's {whole} B: {own / whole:.4f} and "
          f"{resting / whole:.4f} of it; bound half of it plus the leaves "
          f"left whole ({kept} B): {bound:.0f} B; the allocator's blocks "
          f"of the parameters {own + slack} B, {slack} B past their "
          f"storages (at most {max(over)} B a block)")
    check(min(over) >= 0 and max(over) <= ALLOC_OVERHANG,
          f"{tag} a parameter's allocator block overhangs its storage by "
          f"{min(over)}..{max(over)} B, outside 0..{ALLOC_OVERHANG}")
    check(model.fsdp is not None and model.cfg.use_kernel is True
          and own <= bound and resting <= bound + slack,
          f"{tag} a rank rests {own} B of parameters ({resting} B "
          f"allocated), past {bound:.0f} (+ the blocks' {slack})")
    _, opt = loop.init_train_state(model, 0, tcfg)
    step = loop.make_train_step(model, tcfg, mesh=mesh)
    batches = [train_batch(cfg, device, TRAIN_BATCH, seed=s) for s in (0, 1)]
    want = train_launches(cfg, tcfg.microbatches)
    counts = dict.fromkeys(_kernel_modules(), 0)
    mets, times = [], []
    torch.cuda.reset_peak_memory_stats(device)
    for i in range(DIST_STEPS):
        reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        opt, m = step(opt, batches[i % 2])
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        got = _lm_counts(launch_counts())
        check(got == want, f"{tag} step {i} launched {got}, not {want}")
        for n, c in got.items():
            counts[n] += c
        mets.append({k: float(v) for k, v in m.items()})
    train_peak = torch.cuda.max_memory_allocated(device) / 1e9
    p50 = statistics.median(times[1:])
    print(f"{tag} {DIST_STEPS} steps of {TRAIN_BATCH} x {TRAIN_SEQ} cut over "
          f"data, {tcfg.microbatches} microbatches, remat: losses "
          + " ".join(f"{m['loss']:.6f}" for m in mets) + "; step times "
          + " ".join(f"{t * 1e3:.1f}" for t in times) + f" ms (p50 of steps "
          f"2-{DIST_STEPS}: {p50 * 1e3:.1f} ms); peak memory "
          f"{train_peak:.3f} GB; launches a step {want}")
    index, count = batch_block(mesh, TRAIN_BATCH)
    per = TRAIN_BATCH // (TRAIN_MICRO * count)
    micro = {k: loop.rank_rows(v, TRAIN_MICRO, index, count)[:per]
             for k, v in batches[0].items()}
    reset_launch_counts()
    _checked_train_grads(model, micro, f"bf16 cut over data, rank {rank}")
    reset_launch_counts()
    del opt, step, batches, micro
    model.requires_grad_(False)
    torch.cuda.empty_cache()

    index, count = batch_block(mesh, SERVE_BATCH)
    rows = slice(index * SERVE_BATCH // count,
                 (index + 1) * SERVE_BATCH // count)
    prompts = make_prompts(cfg, SERVE_BATCH, SERVE_PROMPT, seed=0,
                           device=device)[rows]
    pe = serve_patch_embeds(cfg, device)[rows]
    torch.cuda.reset_peak_memory_stats(device)
    reset_launch_counts()
    res = serve(model, prompts, TP_SERVE_STEPS + 1, patch_embeds=pe)
    got = _lm_counts(launch_counts())
    serve_peak = torch.cuda.max_memory_allocated(device) / 1e9
    want_serve = lm_launches(cfg, 1, TP_SERVE_STEPS)
    check(got == want_serve, f"{tag} a prefill and {TP_SERVE_STEPS} decode "
          f"steps launched {got}, not {want_serve}")
    for n, c in got.items():
        counts[n] += c
    print(f"{tag} rows {rows.start}-{rows.stop - 1} of {SERVE_BATCH}: a "
          f"prefill of {prompts.shape[0]} x {SERVE_PROMPT} in "
          f"{res.prefill_ms:.3f} ms, {TP_SERVE_STEPS} greedy decode steps "
          f"p50 {res.decode_p50_ms():.3f} ms; peak memory {serve_peak:.3f} "
          f"GB; launches {got}")
    check(res.tokens.shape == (prompts.shape[0], TP_SERVE_STEPS + 1)
          and bool((res.tokens >= 0).all()
                   and (res.tokens < cfg.vocab_size).all()),
          f"{tag} greedy tokens {tuple(res.tokens.shape)} out of range")
    reset_launch_counts()
    _check_on_activations(model, prompts, f"bf16 cut over data, rank {rank}",
                          pe)
    reset_launch_counts()
    out = {"losses": [m["loss"] for m in mets],
           "grad_norms": [m["grad_norm"] for m in mets],
           "step_p50_ms": p50 * 1e3, "train_peak_gb": train_peak,
           "serve_peak_gb": serve_peak, "prefill_ms": res.prefill_ms,
           "decode_p50_ms": res.decode_p50_ms(), "resting_bytes": own,
           "allocated_bytes": resting,
           "whole_bytes": whole, "counts": counts}
    del model, res, prompts, pe
    torch.cuda.empty_cache()
    out["control"], out["tokens"], out["unsplit_tokens"] = _tp_f32_control(
        device, mesh, tag, TRAIN_ARCH, rows)
    return out


def _conditioned(model) -> None:
    """Each stacked layer weight of ``model`` (drawn at the reference's
    std 1/sqrt(depth)) rescaled in place to std 1/sqrt(its fan-in, the
    leading dim of its whole shape, or of an expert's: the dim after
    ``experts``), a split block as its whole weight.
    At 2 layers the reference's init leaves the stacked weights at std
    0.71: the attention scores reach the thousands, every softmax row is
    one key, and a float32 near-tie between two keys goes either way with
    the order of a product's sum (split against unsplit on the card:
    gradient norms 8.0e-3 and logits 3.5e-4 apart, the loss 7.8e-8), as
    MLA's do at its init (phase 14)."""
    import torch
    from repro_torch.models.params import whole_shape
    with torch.no_grad():
        for name, p in model.named_parameters():
            kind, scale = p.init_rule
            if name.startswith(("layers.", "dense_layers.")) \
                    and kind == "normal":
                fan_in = whole_shape(p)[p.logical_axes[0] == "experts"]
                p.mul_(float(fan_in) ** -0.5 / scale)


def _tp_f32_control(device, mesh, tag: str, arch: str,
                    serve_rows: slice = slice(None)
                    ) -> tuple[dict, list, list]:
    """``arch`` at full width and ``TP_F32_LAYERS`` layers in float32
    (zamba2-7b's shared block applied once, after its second layer; the
    MoE family at ``TP_F32_MOE_LAYERS``, deepseek-v3-671b's all dense),
    its weights ``_conditioned``, split over ``mesh`` and unsplit on this
    rank, from the same seed: two train steps (losses, gradient norms;
    AdamW's eps 1; qwen2-vl-2b at phase 15's batch and microbatches, the
    scan families at theirs; none for the MoE family, whose float32
    training state does not fit), then a prefill of the serve prompts and
    ``TP_SERVE_STEPS`` greedy decode steps (last-position logits,
    tokens), the split ones within ``TP_F32_RTOL`` (relative; the logits
    of their scale) of the unsplit ones, the tokens equal.  Cut over
    ``data`` the model serves this rank's ``serve_rows`` of the prompts,
    held to the unsplit model's same rows.  -> (the gaps, the split run's
    greedy tokens, the unsplit run's)."""
    import dataclasses
    import torch
    import repro_torch.train.loop as loop
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import make_prompts, serve
    from repro_torch.models.model import build_model
    from repro_torch.optim import AdamWConfig, adamw_init
    moe = arch in TP_MOE_ARCHS
    if moe:
        n = TP_F32_MOE_LAYERS[arch]
        full = get_config(arch, "full")
        cfg = dataclasses.replace(full, n_layers=n, dtype=torch.float32,
                                  first_k_dense=min(full.first_k_dense, n))
    else:
        cfg = _train_cfg(arch, TP_F32_LAYERS, torch.float32)
    if cfg.hybrid_attn_every:
        cfg = dataclasses.replace(cfg, hybrid_attn_every=TP_F32_LAYERS)
    whole = arch == TRAIN_ARCH
    # AdamW's eps 1, so that an update is linear in its gradient: at 1e-8
    # the first update is each gradient element's sign times the rate, and
    # a zero-initialised bias's near-cancelling elements take either sign
    # in either order of sum (tests/test_torch_tensor_parallel.py's EPS)
    tcfg = loop.TrainConfig(opt=AdamWConfig(eps=1.0),
                            microbatches=TRAIN_MICRO if whole else 1,
                            warmup_steps=1, total_steps=TRAIN_STEPS)
    rows = TRAIN_BATCH if whole else TRAIN_ONE_BATCH
    batches = [] if moe else [train_batch(cfg, device, rows, seed=s)
                              for s in (0, 1)]
    prompts = make_prompts(cfg, SERVE_BATCH, SERVE_PROMPT, seed=0,
                           device=device)
    pe = serve_patch_embeds(cfg, device)
    pe = None if pe is None else pe.float()
    runs = []
    for m, mine in ((mesh, serve_rows), (None, slice(None))):
        model = build_model(cfg, device, seed=0, mesh=m)
        _conditioned(model)
        mets = []
        if not moe:
            model.requires_grad_(True)
            opt = adamw_init(model, tcfg.opt)
            step = loop.make_train_step(model, tcfg, mesh=m)
            for b in batches:
                opt, met = step(opt, b)
                mets.append((float(met["loss"]), float(met["grad_norm"])))
            del opt, step
            model.requires_grad_(False)
        res = serve(model, prompts[mine], TP_SERVE_STEPS + 1,
                    patch_embeds=None if pe is None else pe[mine],
                    keep_logits=True)
        runs.append((mets, [res.prefill_logits] + res.decode_logits,
                     res.tokens))
        del model, res
        torch.cuda.empty_cache()
    (got_m, got_l, got_t), (want_m, want_l, all_t) = runs
    want_l = [lg[serve_rows] for lg in want_l]
    want_t = all_t[serve_rows]
    gaps = {"logits": max(((a - b).abs().max() / b.abs().max()).item()
                          for a, b in zip(got_l, want_l))}
    if not moe:
        gaps["loss"] = max(abs(a[0] - b[0]) / abs(b[0])
                           for a, b in zip(got_m, want_m))
        gaps["grad_norm"] = max(abs(a[1] - b[1]) / abs(b[1])
                                for a, b in zip(got_m, want_m))
    same = bool(torch.equal(got_t, want_t))
    print(f"{tag} {arch} float32 control at {cfg.n_layers} layers, full "
          f"width: split against unsplit on this rank, "
          f"{'' if moe else '2 steps and '}a prefill "
          f"with {TP_SERVE_STEPS} greedy decode steps: relative gaps "
          + ", ".join(f"{k} {v:.3e}" for k, v in gaps.items())
          + f" (gate {TP_F32_RTOL:g}); greedy tokens equal: {same}")
    check(all(v <= TP_F32_RTOL for v in gaps.values()) and same,
          f"{tag} the split float32 {arch} differs from the unsplit one: "
          f"{gaps}, tokens equal {same}")
    return gaps, got_t.tolist(), all_t.tolist()


def phase_tp(device, unsplit_losses: list[float],
             scan_losses: dict[str, list]) -> dict[str, int]:
    """Phase 17 (see the module's docstring): ``TP_RANKS`` processes
    (``tp_worker``) share the card on a gloo group; qwen2-vl-2b's split
    bf16 losses are held to phase 16's unsharded ones
    (``unsplit_losses``), each scan family's to phase 15's
    (``scan_losses``), and the ranks' greedy tokens to each other (the MoE
    family's too); -> the launches of their timed split steps and serve
    runs, summed over the ranks and models (each rank resets its counts
    just before each and reads them just after).
    Two NCCL ranks cannot share one card (NCCL 2.28 refuses them:
    "ncclInvalidUsage ... Duplicate GPU detected : rank 0 and rank 1 both
    on CUDA device", at the first collective), so the group is gloo's,
    which takes CUDA tensors (copying them through host memory): a rank's
    step time here is no speed figure for the split."""
    import os
    import torch
    torch.cuda.empty_cache()
    t_start = time.perf_counter()
    with tempfile.TemporaryDirectory() as d:
        procs = [subprocess.Popen(
            [sys.executable, "-c",
             f"import sys; sys.path.insert(0, {str(ROOT)!r}); "
             f"import chip_smoke; sys.exit(chip_smoke.tp_worker({r}, {d!r}))"],
            cwd=ROOT, env=dict(os.environ, PYTHONPATH=str(SRC)), text=True,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
            for r in range(TP_RANKS)]
        outs = {}
        try:
            for r, proc in enumerate(procs):
                left = TP_TIMEOUT_S - (time.perf_counter() - t_start)
                outs[r], _ = proc.communicate(timeout=max(left, 1.0))
        finally:
            for proc in procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        for r in range(TP_RANKS):
            print(outs.get(r, "").rstrip())
        codes = [proc.returncode for proc in procs]
        check(codes == [0] * TP_RANKS, f"phase 17's ranks exited {codes}")
        results = []
        for r in range(TP_RANKS):
            with open(f"{d}/rank{r}.json") as f:
                results.append(json.load(f))
    smi = smi_line()
    want_losses = {TRAIN_ARCH: (unsplit_losses, "phase 16's unsharded",
                                DIST_STEPS)}
    for arch in TP_SCAN_ARCHS:
        want_losses[arch] = (scan_losses[arch], "phase 15's unsplit",
                             TRAIN_ONE_STEPS)
    counts = dict.fromkeys(_kernel_modules(), 0)
    for arch, (unsplit, source, n_steps) in want_losses.items():
        runs = [res[arch] for res in results]
        losses = runs[0]["losses"]
        check(all(run["losses"] == losses and run["tokens"] ==
                  runs[0]["tokens"] for run in runs),
              f"the ranks of one model group disagree on {arch}'s losses or "
              f"tokens")
        gaps = [abs(a - b) / abs(b) for a, b in zip(losses, unsplit)]
        print(f"[tp] {arch} bf16 split losses "
              + " ".join(f"{x:.6f}" for x in losses) + f" against {source} "
              + " ".join(f"{x:.6f}" for x in unsplit) + ": relative gaps "
              + " ".join(f"{g:.2e}" for g in gaps) + f" (band "
              f"{TP_BF16_LOSS_RTOL:.4g})")
        check(len(gaps) == n_steps and max(gaps) <= TP_BF16_LOSS_RTOL,
              f"the split bf16 {arch} losses leave the band: {gaps}")
        for r, run in enumerate(runs):
            print(f"[tp] {arch} rank {r}: step p50 {run['step_p50_ms']:.1f} "
                  f"ms, train peak "
                  f"{run['train_peak_gb']:.3f} GB; prefill "
                  f"{run['prefill_ms']:.3f} ms, decode p50 "
                  f"{run['decode_p50_ms']:.3f} ms, serve peak "
                  f"{run['serve_peak_gb']:.3f} GB; card: {smi} (two "
                  f"processes share its SMs: no speed figure for the split)")
            for n in counts:
                counts[n] += run["counts"][n]
    for arch in TP_MOE_ARCHS:
        runs = [res[arch] for res in results]
        check(all(run["tokens"] == runs[0]["tokens"] for run in runs),
              f"the ranks of one model group disagree on {arch}'s tokens")
        for r, run in enumerate(runs):
            layer = (f"; the split MoE layer at {run['moe_layer']:.3f} of "
                     f"its gate" if r == 0 else "")
            print(f"[tp] {arch} rank {r}: prefill {run['prefill_ms']:.3f} "
                  f"ms, decode p50 {run['decode_p50_ms']:.3f} ms, serve peak "
                  f"{run['serve_peak_gb']:.3f} GB; float32 control "
                  f"{run['control']}{layer}; card: {smi} (two processes "
                  f"share its SMs: no speed figure for the split)")
            for n in counts:
                counts[n] += run["counts"][n]
    runs = [res["fsdp"] for res in results]
    losses = runs[0]["losses"]
    gaps = [abs(a - b) / abs(b) for a, b in zip(losses, unsplit_losses)]
    print(f"[fsdp] {TRAIN_ARCH} bf16 losses cut over data "
          + " ".join(f"{x:.6f}" for x in losses) + " against phase 16's "
          "unsharded " + " ".join(f"{x:.6f}" for x in unsplit_losses)
          + ": relative gaps " + " ".join(f"{g:.2e}" for g in gaps)
          + f" (band {TP_BF16_LOSS_RTOL:.4g})")
    check(all(run["losses"] == losses for run in runs)
          and len(gaps) == DIST_STEPS and max(gaps) <= TP_BF16_LOSS_RTOL,
          f"the bf16 losses cut over data disagree across the ranks or "
          f"leave the band: {[run['losses'] for run in runs]}, {gaps}")
    # data rank r serves block r of the prompts: in rank order, the rows
    tokens = [row for run in runs for row in run["tokens"]]
    check(tokens == runs[0]["unsplit_tokens"],
          "the float32 control's greedy tokens over both ranks' rows differ "
          "from the unsplit model's")
    for r, run in enumerate(runs):
        print(f"[fsdp] {TRAIN_ARCH} rank {r}: resting parameters "
              f"{run['resting_bytes']} B ({run['allocated_bytes']} B "
              f"allocated) of the whole model's {run['whole_bytes']} B; "
              f"step p50 {run['step_p50_ms']:.1f} "
              f"ms, train peak {run['train_peak_gb']:.3f} GB; prefill of "
              f"its {SERVE_BATCH // TP_RANKS} rows {run['prefill_ms']:.3f} "
              f"ms, decode p50 {run['decode_p50_ms']:.3f} ms, serve peak "
              f"{run['serve_peak_gb']:.3f} GB; float32 control "
              f"{run['control']}, its tokens over both ranks' rows equal "
              f"the unsplit model's; card: {smi} (two processes share its "
              f"SMs: no speed figure for the cut)")
        for n in counts:
            counts[n] += run["counts"][n]
    print(f"[tp] phase done in {time.perf_counter() - t_start:.1f} s; "
          f"launches over both ranks {counts}")
    return counts


# phase 18's dry-run runs, one process each: (name, arch, shape, extra CLI
# flags, meshes); qwen2-vl-2b x train_4k on the 2x16x16 mesh shows the
# batch split over pod x data, llama3-405b x decode_32k the q heads split
# over kv heads that do not, zamba2-7b x decode_32k the Mamba2 split,
# mixtral-8x22b x decode_32k each expert's columns split (its 8 experts do
# not divide 16) and deepseek-v3-671b x decode_32k the experts and MLA's
# heads, both routing over the batch group
DRYRUN_CELLS = (("rwkv6", "rwkv6-1.6b", "decode_32k", ["--both-meshes"],
                 {"16x16": 256, "2x16x16": 512}),
                ("qwen2-vl", "qwen2-vl-2b", "train_4k", [], {"16x16": 256}),
                ("qwen2-vl-pod", "qwen2-vl-2b", "train_4k", ["--multi-pod"],
                 {"2x16x16": 512}),
                ("llama3", "llama3-405b", "decode_32k", [], {"16x16": 256}),
                ("zamba2", "zamba2-7b", "decode_32k", [], {"16x16": 256}),
                ("mixtral", "mixtral-8x22b", "decode_32k", [],
                 {"16x16": 256}),
                ("deepseek", MLA_ARCH, "decode_32k", [], {"16x16": 256}))
LAUNCH_TIMEOUT_S = 900              # from the start, beside phase 17
# the split decode rows at 16x16: (FLOPs a rank at most, peak bytes at
# most, the split plan's line); whole on every rank they read 1.951e11
# FLOPs and 66.29 GiB (zamba2-7b), 2.319e10 (rwkv6-1.6b), 2.292e12 and
# 269.21 GiB (mixtral-8x22b), 1.518e13 and 1267.92 GiB (deepseek-v3-671b);
# split over ``model`` and cut over ``data`` (``dist.fsdp``) on the CPU
# they read 1.219e10 and 3.43 GiB, 1.473e9, 1.539e11 and 8.51 GiB,
# 9.639e11 and 24.46 GiB, gated at about twice that
SPLIT_DECODE_GATES = {
    "zamba2-7b": (2.44e10, 7 * 2 ** 30,
                  "mamba2 split, attention split, mlp split, vocab split"),
    "rwkv6-1.6b": (2.9e9, None,
                   "time mix split, channel mix split, vocab split"),
    "mixtral-8x22b": (3.1e11, 17 * 2 ** 30, "attention split, experts "
                      "whole, expert mlp split, vocab split"),
    MLA_ARCH: (1.93e12, 49 * 2 ** 30, "mla split, mlp split, experts "
               "split, expert mlp whole, vocab split")}
# the reference's own peak a device of the MoE rows at 16x16, from its dry
# run on the CPU (tests/test_torch_launch.py's REFERENCE_DECODE_PEAK): a
# rank of the port's, its weights cut over ``data``, peaks at or below it
REFERENCE_DECODE_PEAK = {"mixtral-8x22b": 16_214_567_462,
                         MLA_ARCH: 42_597_803_382}
# the split decode rows' argument bytes at 16x16: the reference's own dry
# run of each cell (``repro.launch.dryrun.run_cell`` on the CPU) reads the
# same, and they come from the specs, which the split does not move
DECODE_ARGUMENT = {"zamba2-7b": 3_182_791_172,
                   "mixtral-8x22b": 8_697_844_736,
                   MLA_ARCH: 24_174_346_132}


def smi_line() -> str:
    """The card's name and power limit, as ``nvidia-smi`` gives them."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return smi.stdout.strip().splitlines()[0]


def start_launch_tooling(out_dir: str) -> tuple[dict, float]:
    """Phase 18's processes (see the module's docstring), started at once:
    host work on fake tensors, which ``main`` runs beside phase 17 (whose
    two ranks mostly wait on the card and on gloo).  Each writes its
    output to ``<name>.log`` in ``out_dir``, and its JSON there.  -> (the
    processes by name, the start time)."""
    import os
    env = dict(os.environ, PYTHONPATH=str(SRC))
    t_start = time.perf_counter()
    runs = {}
    for name, arch, shape, flags, _ in DRYRUN_CELLS:
        runs[name] = [sys.executable, "-m", "repro_torch.launch.dryrun",
                      "--arch", arch, "--shape", shape, *flags,
                      "--out", f"{out_dir}/dryrun_{name}.json"]
    runs["cost"] = [sys.executable, "-m", "repro_torch.launch.dryrun",
                    "--cost", "--arch", "rwkv6-1.6b", "--shape", "decode_32k",
                    "--out", f"{out_dir}/cost.json"]
    runs["analysis"] = [sys.executable, "-m", "repro_torch.analysis",
                        "src/repro_torch"]
    procs = {}
    for name, cmd in runs.items():
        with open(f"{out_dir}/{name}.log", "w") as log:
            procs[name] = subprocess.Popen(cmd, cwd=ROOT, env=env,
                                           stdout=log,
                                           stderr=subprocess.STDOUT)
    return procs, t_start


def stop_processes(procs: dict) -> None:
    for proc in procs.values():
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def phase_launch_tooling(out_dir: str, started: tuple[dict, float]) -> None:
    """Phase 18 (see the module's docstring): waits for the processes of
    ``start_launch_tooling`` (``started``), then gates their rows; the
    dry-run and roofline JSON are in ``out_dir``."""
    import os
    env = dict(os.environ, PYTHONPATH=str(SRC))
    procs, t_start = started
    outs = {}
    try:
        for name, proc in procs.items():
            proc.wait(timeout=max(LAUNCH_TIMEOUT_S
                                  - (time.perf_counter() - t_start), 1.0))
            with open(f"{out_dir}/{name}.log") as log:
                outs[name] = log.read()
    finally:
        stop_processes(procs)
    for name, out in outs.items():
        tail = "\n".join(out.strip().splitlines()[-3:])
        print(f"[launch] {name}: exit {procs[name].returncode}; {tail}")
    analysis = outs["analysis"]
    check(procs["analysis"].returncode == 0 and " 0 violations" in analysis,
          f"the port's analysis found something:\n{analysis[-3000:]}")
    smi = smi_line()
    mem = []
    by_cell = {}
    for name, arch, shape, _, meshes in DRYRUN_CELLS:
        check(procs[name].returncode == 0,
              f"the dry run of {arch} exited {procs[name].returncode}:\n"
              f"{outs[name][-3000:]}")
        with open(f"{out_dir}/dryrun_{name}.json") as f:
            rows = json.load(f)
        check(sorted(r["mesh"] for r in rows) == sorted(meshes),
              f"{arch} x {shape}: rows for {[r['mesh'] for r in rows]}")
        for r in rows:
            check("error" not in r, f"{arch} x {shape} @ {r['mesh']}: "
                  f"error row {r.get('error')}")
            check(r["n_devices"] == meshes[r["mesh"]],
                  f"{arch} @ {r['mesh']}: {r['n_devices']} devices")
            check(r["flops_total"] > 0 and r["bytes_per_device"]["peak"] > 0,
                  f"{arch} @ {r['mesh']}: zero FLOPs or peak: {r}")
            print(f"[launch] dry run {json.dumps(r)}")
            print(f"[launch] card: {smi}")
            by_cell[(arch, shape, r["mesh"])] = r
        mem += rows
    # the model-axis split's rows: qwen2-vl-2b x train_4k a rank within
    # 4.0e14 FLOPs and 95 GB at 16x16 (9.129e14 and 113.9 GB whole), half
    # the FLOPs at 2x16x16 (8 rows a rank, not 16)
    one = by_cell[("qwen2-vl-2b", "train_4k", "16x16")]
    two = by_cell[("qwen2-vl-2b", "train_4k", "2x16x16")]
    half = two["flops_total"] / one["flops_total"]
    print(f"[launch] qwen2-vl-2b x train_4k: {one['flops_total']:.4e} FLOPs "
          f"and {one['bytes_per_device']['peak'] / 1e9:.2f} GB peak a rank at "
          f"16x16; 2x16x16 / 16x16 FLOPs {half:.4f}")
    check(one["flops_total"] <= 4.0e14
          and one["bytes_per_device"]["peak"] <= 95e9
          and abs(half - 0.5) <= 0.01,
          f"the split train row is outside its gates: {one}, ratio {half}")
    # its all-gathers are the weights' a layer at a time, no gather of the
    # optimizer state (which rests in the parameters' blocks)
    from repro_torch.configs import get_config
    from repro_torch.dist.fsdp import weight_gather_bytes
    from repro_torch.dist.sharding import CutMesh
    from repro_torch.launch.shapes import TRAIN_MICROBATCHES
    from repro_torch.models.model import build_model
    micro = TRAIN_MICROBATCHES.get("qwen2-vl-2b", TRAIN_MICROBATCHES["default"])
    for row, shape in ((one, {"data": 16, "model": 16}),
                       (two, {"pod": 2, "data": 16, "model": 16})):
        want = weight_gather_bytes(build_model(
            get_config("qwen2-vl-2b"), "meta", seed=None,
            mesh=CutMesh(shape)), micro)
        got = row["collective_bytes"].get("all-gather")
        print(f"[launch] qwen2-vl-2b x train_4k @ {row['mesh']}: all-gather "
              f"{got:.0f} B a rank, the weights cut over data gathered a "
              f"layer at a time {want} B")
        check(got == want, f"qwen2-vl-2b x train_4k @ {row['mesh']} "
              f"all-gathers {got} B, not the weights' {want} B")
    for arch, (flops, peak, plan) in SPLIT_DECODE_GATES.items():
        row = by_cell[(arch, "decode_32k", "16x16")]
        name = next(c[0] for c in DRYRUN_CELLS if c[1] == arch)
        print(f"[launch] {arch} x decode_32k split: "
              f"{row['flops_total']:.4e} FLOPs (gate {flops:.3g}), peak "
              f"{row['bytes_per_device']['peak'] / 2 ** 30:.2f} GiB, argument "
              f"{row['bytes_per_device']['argument']:.0f} B a rank at 16x16")
        check(row["flops_total"] <= flops
              and (peak is None or row["bytes_per_device"]["peak"] <= peak)
              and plan in outs[name],
              f"the split {arch} decode row is outside its gates or does "
              f"not say '{plan}': {row}")
    for arch, peak in REFERENCE_DECODE_PEAK.items():
        row = by_cell[(arch, "decode_32k", "16x16")]
        print(f"[launch] {arch} x decode_32k: peak "
              f"{row['bytes_per_device']['peak']:.0f} B a rank, the "
              f"reference's own device {peak} B")
        check(row["bytes_per_device"]["peak"] <= peak,
              f"{arch} x decode_32k peaks past the reference's device: "
              f"{row['bytes_per_device']}")
    for arch, argument in DECODE_ARGUMENT.items():
        row = by_cell[(arch, "decode_32k", "16x16")]
        check(row["bytes_per_device"]["argument"] == argument
              and row["collective_bytes_total"] > 0,
              f"{arch} x decode_32k's argument bytes moved, or it issued no "
              f"collective: {row}")
    check(procs["cost"].returncode == 0, f"the cost run exited "
          f"{procs['cost'].returncode}:\n{outs['cost'][-3000:]}")
    with open(f"{out_dir}/cost.json") as f:
        cost = json.load(f)
    check(len(cost) == 1 and "error" not in cost[0]
          and cost[0]["flops_total"] > 0, f"cost row {cost}")
    print(f"[launch] cost {json.dumps(cost[0])}")
    print(f"[launch] card: {smi}")
    with open(f"{out_dir}/mem.json", "w") as f:
        json.dump(mem, f)
    with open(f"{out_dir}/cost_and_mem.json", "w") as f:
        json.dump(cost + mem, f)
    roof = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.roofline",
         "--cost", f"{out_dir}/cost_and_mem.json",
         "--mem", f"{out_dir}/mem.json", "--out", f"{out_dir}/roofline.json",
         "--markdown"], cwd=ROOT, env=env, capture_output=True, text=True,
        timeout=120)
    check(roof.returncode == 0, f"the roofline exited {roof.returncode}:\n"
          f"{roof.stderr[-3000:]}")
    with open(f"{out_dir}/roofline.json") as f:
        terms = json.load(f)
    check(len(terms) == len(cost) + len(mem) and all(
        math.isfinite(t["roofline_mfu_bound"]) for t in terms),
        f"roofline rows {terms}")
    for t in terms:
        print(f"[launch] roofline {json.dumps(t)}")
        print(f"[launch] card: {smi}")
    print(roof.stdout.strip())
    print(f"[launch] phase done in {time.perf_counter() - t_start:.1f} s")


def launch_floor(device) -> float:
    """Device ms of a one-element ``add_``, replayed as ``cuda_ms`` replays
    the kernels: the least a launch costs, whatever it computes."""
    import torch
    one = torch.zeros(1, device=device)
    ms, call_ms = cuda_ms(lambda: one.add_(1.0))
    print(f"[kernels] launch floor: a one-element add_ takes {ms:.4f} ms a "
          f"launch (graph replay), {call_ms:.4f} ms an eager call")
    return ms


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
            phase_kernel_transfer_select(card_db),
            phase_kernel_flash_attention(device), phase_kernel_ssd_scan(device),
            phase_kernel_rwkv6(device), phase_kernel_decode_attention(device)]
    launch_floor(device)
    paths = [phase_offline(device), phase_tuner(device),
             phase_fleet(device, card_db), phase_baselines(device)]
    paths += [phase_serve(device, arch) for arch in SERVE_ARCHS]
    paths.append(phase_checkpoint(device))
    paths.append(phase_serve(device, MLA_ARCH))
    train, scan_losses = phase_train(device)
    dist_counts, unsplit_losses = phase_dist(device)
    with tempfile.TemporaryDirectory() as out_dir:
        started = start_launch_tooling(out_dir)
        try:
            tp_counts = phase_tp(device, unsplit_losses, scan_losses)
        except BaseException:
            stop_processes(started[0])
            raise
        phase_launch_tooling(out_dir, started)
    paths += [train, dist_counts, tp_counts]
    for row in rows:
        row["launches"] = sum(path[row["name"]] for path in paths)
        row["train_launches"] = train[row["name"]]
        row["dist_launches"] = dist_counts[row["name"]]
        row["tp_launches"] = tp_counts[row["name"]]
        check(row["launches"] > 0, f"the main path never launched {row['name']}")
    print(f"[done] all phases passed in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": rows}))
    print(smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
