"""Run one cell of the benchmark once and print its result line.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the card(s) the cell asks
for.  Standard output's last line is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer ones, as ``BENCHMARK.json`` lists them),
``device``, with ``--trace 1`` ``breakdown``, and last ``checks``: each
number the check compared beside its limit, which are also the last lines
on standard error.  Without a CUDA card, with fewer cards than the cell
asks for, or with JAX or the JAX package loaded once the window has
closed, it prints no result and exits with a code other than 0.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# every build and kernel cache at a fixed path inside the checkout
# characters of a device operation's name the breakdown keeps
NAME_CHARS = 200
CACHES = {"TORCH_EXTENSIONS_DIR": "torch_extensions",
          "TRITON_CACHE_DIR": "triton", "CUDA_CACHE_PATH": "cuda"}


def _environment() -> None:
    for var, sub in CACHES.items():
        os.environ[var] = str(ROOT / "build" / "cache" / sub)
    for path in (ROOT / "src", ROOT):
        if str(path) not in sys.path:
            sys.path.insert(0, str(path))


def _reader(name: str):
    path = ROOT / "bench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "bench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def metrics(bench: dict, cell: str, run, traced: bool) -> dict:
    """The cell's metrics that its readers find, by ``BENCHMARK.json``."""
    out = {}
    for m in bench["per_layer" if traced else "end_to_end"]:
        if not applies(m, cell):
            continue
        value = _reader(m["name"])(run)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def result_line(run, bench: dict, cell: str, traced: bool, kind: str,
                count: int) -> dict:
    line = {"correct": bool(run.checks["correct"]),
            "attempted": run.requests, "failed": 0,
            "metrics": metrics(bench, cell, run, traced),
            "device": {"platform": "gpu", "kind": kind, "count": count,
                       "memory_peak_bytes": run.peak_bytes}}
    if traced:
        tr = run.trace
        line["device"]["busy_s"] = tr.busy_s if tr else 0.0
        line["device"]["window_s"] = tr.window_s if tr else run.window_s
        if tr is not None:
            line["breakdown"] = {"device_ops": [[name[:NAME_CHARS], s]
                                                for name, s in tr.top_ops()],
                                 "idle_gaps": tr.idle_gaps()}
    line["checks"] = {name: {"value": run.checks["values"].get(name),
                             "limit": limit}
                      for name, limit in run.checks["limits"].items()}
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if args.seed < 0:
        ap.error("--seed must be a whole number >= 0")
    _environment()
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    entry = {w["name"]: w for w in bench["workloads"]}.get(args.workload)
    if entry is None:
        print(f"no cell {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2

    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < entry["chips"]:
        print(f"the cell needs {entry['chips']} CUDA card(s); this machine "
              f"has {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    from bench import harness
    device = torch.device("cuda", 0)
    c = harness.cell(args.workload)
    print(f"configuration {harness.rendition(c.cfg)}", file=sys.stderr)
    run = harness.run_cell(c, args.seed, args.seconds, bool(args.trace),
                           device, T_START)
    line = result_line(run, bench, args.workload, bool(args.trace),
                       torch.cuda.get_device_name(device), entry["chips"])
    found = harness.forbidden_modules()
    if found:
        print(f"the run loaded {', '.join(found)}: the benchmark measures "
              f"repro_torch alone", file=sys.stderr)
        return 3
    ch = run.checks
    print(f"setup_s {run.setup_s!r} window_s {run.window_s!r}: "
          f"{len(run.prefills)} prefills, {len(run.steps)} decode steps, "
          f"{run.requests} requests", file=sys.stderr)
    print(f"check: {ch['requests']} requests, {ch['tokens']} tokens "
          f"compared in {ch['seconds']:.1f} s"
          + (f"; worst state {ch['worst_state']}" if ch.get("worst_state")
             else ""), file=sys.stderr)
    for name, v in line["checks"].items():
        print(f"{name} {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
