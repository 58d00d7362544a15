"""The control's readings beside the program's, for setting a cell's
limits: for each seed, one run of the cell (set-up, the window, the
check), whose check also reads the numbers of the reference in float8 in
the program's place on the same requests and judges them by the check's
own verdict (``bench.check``).  With ``--witness 1`` a prefill's check
also reads the reference with bfloat16 operands, the gaps that rounding
alone gives.  All seeds run in one process, so the kernels build once.

    python3 bench/control.py --workload <cell> --seeds 1,2,3 --seconds 30 \\
        [--control 0|1] [--witness 0|1]

prints one JSON line a seed: the program's numbers and verdict, the
control's and its verdict (``control_correct``, which has to be false),
the witness's, the limits, and each leaf's gaps layer by layer for each
side.  The benchmark's runs never run it.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

from run import _environment


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True,
                    help="comma-separated whole numbers")
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--control", type=int, choices=(0, 1), default=1)
    ap.add_argument("--witness", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _environment()
    import torch
    if not torch.cuda.is_available():
        print("the control runs on a CUDA card", file=sys.stderr)
        return 2
    from bench import harness
    c = harness.cell(args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        run = harness.run_cell(c, seed, args.seconds, False,
                               torch.device("cuda", 0), t0,
                               control=bool(args.control),
                               witness=bool(args.witness))
        ch = run.checks
        print(json.dumps({"workload": c.name, "seed": seed,
                          "program": ch["values"], "correct": ch["correct"],
                          "control": ch["control"],
                          "control_correct": ch["control_correct"],
                          "witness": ch.get("witness"),
                          "limits": ch["limits"],
                          "requests": ch["requests"], "tokens": ch["tokens"],
                          "worst_state": ch.get("worst_state"),
                          "check_s": ch["seconds"], "setup_s": run.setup_s,
                          "window_s": run.window_s,
                          "steps": len(run.steps),
                          "valid": ([run.steps[0].valid, run.steps[-1].valid]
                                    if run.steps else None),
                          "by_layer": ch.get("by_layer")}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
