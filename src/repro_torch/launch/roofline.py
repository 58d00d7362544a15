"""Roofline analysis over the dry-run artifacts (``repro.launch.roofline``),
at one NVIDIA H100 SXM's figures.

Three terms per (arch x shape), single-pod 16x16 mesh:

    compute    = FLOPs / (989 TFLOP/s bf16 dense, on the tensor cores)
    memory     = bytes / (3.35 TB/s HBM3)
    collective = collective_bytes / (50 GB/s per GPU)

The peaks are NVIDIA's data-sheet figures for the H100 SXM at its full
700 W power limit (``CHIP_F32_FLOPS`` is float32 outside the tensor
cores).  The collective term models one 400 Gb/s NDR InfiniBand NIC per
GPU: a 16-wide mesh axis spans two 8-GPU NVLink domains, and the NIC is
the slowest link its collectives cross.

FLOPs, bytes and collective bytes come from the *cost-mode* dry run
(``dryrun.run_cost_cell``: two depths at full width, extrapolated to the
real depth) and are one rank's program, so each term is that rank's time.
Its FLOPs are the port's data-parallel compute on whole local tensors, not
an SPMD partition: the port has no tensor-parallel compute.  MODEL_FLOPS
uses 6*N*D (dense) or 6*N_active*D (MoE) for training, 2*N*D for a single
forward/prefill/decode, over ``N_CHIPS``.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.roofline \
        --cost cost_results.json --mem dryrun_results.json \
        --out roofline.json [--markdown]
"""
import argparse
import json

CHIP_FLOPS = 989e12          # bf16 dense tensor-core peak per GPU
CHIP_F32_FLOPS = 67e12       # float32 peak per GPU, CUDA cores
HBM_BPS = 3.35e12            # bytes/s of HBM3 per GPU
LINK_BPS = 50e9              # bytes/s per GPU: one 400 Gb/s NDR NIC
N_CHIPS = 256                # single-pod roofline


def model_flops(arch: str, shape_name: str) -> float:
    from repro_torch.configs import get_config
    from repro_torch.launch.shapes import SHAPES
    cfg = get_config(arch, "full")
    shape = SHAPES[shape_name]
    n_active = cfg.n_active_params_est
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n_active * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n_active * tokens
    # decode: one token per sequence
    return 2.0 * n_active * shape.global_batch


def roofline_terms(cost_row: dict) -> dict:
    """The three per-rank times of one cost row, its dominant term, and the
    model FLOPs a rank owes beside the FLOPs it runs.  Negative inputs (the
    two-depth extrapolation on a tiny program) count as 0."""
    f = max(cost_row["flops_total"], 0.0)          # per rank
    b = max(cost_row["bytes_accessed"], 0.0)       # per rank
    c = max(cost_row["collective_bytes_total"], 0.0)
    t_compute = f / CHIP_FLOPS
    t_memory = b / HBM_BPS
    t_coll = c / LINK_BPS
    dominant = max((t_compute, "compute"), (t_memory, "memory"),
                   (t_coll, "collective"))[1]
    mf = model_flops(cost_row["arch"], cost_row["shape"]) / N_CHIPS
    bound = max(t_compute, t_memory, t_coll)
    return {
        "arch": cost_row["arch"], "shape": cost_row["shape"],
        "t_compute_s": t_compute, "t_memory_s": t_memory,
        "t_collective_s": t_coll, "dominant": dominant,
        "model_flops_per_dev": mf, "hlo_flops_per_dev": f,
        "useful_ratio": mf / max(f, 1.0),
        # the step can't run faster than its dominant term, so usable MFU
        # is bounded by the model FLOPs over that time at peak
        "roofline_mfu_bound": (mf / CHIP_FLOPS) / max(bound, 1e-12),
    }


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cost", default="cost_results.json")
    ap.add_argument("--mem", default="dryrun_results.json")
    ap.add_argument("--out", default="roofline.json")
    ap.add_argument("--markdown", action="store_true")
    args = ap.parse_args()
    with open(args.cost) as f:
        cost = [r for r in json.load(f) if "error" not in r]
    with open(args.mem) as f:
        mem = {(r["arch"], r["shape"]): r for r in json.load(f)
               if "error" not in r and r["mesh"] == "16x16"}
    rows = []
    for r in cost:
        t = roofline_terms(r)
        m = mem.get((r["arch"], r["shape"]))
        if m:
            held = m["bytes_per_device"]
            t["peak_gib_per_device"] = (held["argument"]
                                        + held["temp"]) / 2**30
        rows.append(t)
    with open(args.out, "w") as f:
        json.dump(rows, f, indent=1)

    if args.markdown:
        print("| arch | shape | compute s | memory s | collective s | "
              "dominant | MODEL/HLO | MFU bound | GiB/dev |")
        print("|---|---|---|---|---|---|---|---|---|")
        for t in sorted(rows, key=lambda t: (t["arch"], t["shape"])):
            print(f"| {t['arch']} | {t['shape']} | {t['t_compute_s']:.2e} | "
                  f"{t['t_memory_s']:.2e} | {t['t_collective_s']:.2e} | "
                  f"{t['dominant']} | {t['useful_ratio']:.2f} | "
                  f"{t['roofline_mfu_bound']:.2f} | "
                  f"{t.get('peak_gib_per_device', float('nan')):.1f} |")


if __name__ == "__main__":
    main()
