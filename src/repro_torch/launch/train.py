"""Training launcher, the port of ``repro.launch.train``: the same flags,
and ``--device`` (default: the CUDA card; the CPU only when asked).

    PYTHONPATH=src python -m repro_torch.launch.train --arch minitron-4b \\
        --variant smoke --device cpu --steps 20
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-vl-2b \\
        --variant full --seq 1024 --microbatches 2 --steps 12

Batches come from ``data.pipeline.TokenPipeline``; a model with the vision
stub is also given seeded patch embeddings, (global batch, n_patches,
d_model) at the embedding table's scale (0.02), n_patches cut to the
sequence length where it is shorter.  Every ``--ckpt-every`` steps the
parameters are saved in the reference's layout (stacked layers,
``params.reference_paths``), so either package resumes from the other's
checkpoints; ``--tune-ckpt`` retunes (cc, p, pp) from the save log with
``CheckpointTuner``.  A run resumes from the newest complete checkpoint in
``--ckpt-dir`` (default: a directory named after the model under the
system's temporary directory).
"""
from __future__ import annotations

import argparse
import os
import tempfile

import numpy as np
import torch


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--variant", default="smoke", choices=["smoke", "full"])
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--tune-ckpt", action="store_true",
                    help="tune (cc,p,pp) for checkpoint saves from live logs")
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card; 'cpu' only when asked")
    args = ap.parse_args(argv)

    from repro_torch.checkpoint.ckpt import (CkptParams, latest_step,
                                             restore_checkpoint,
                                             save_checkpoint)
    from repro_torch.checkpoint.tuning import CheckpointTuner
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import (DataConfig, PipelineParams,
                                           TokenPipeline)
    from repro_torch.device import resolve_device
    from repro_torch.launch.serve import device_name
    from repro_torch.models.model import build_model
    from repro_torch.models.params import (paths_from_tree, reference_paths,
                                           split_reference_paths)
    from repro_torch.train.loop import TrainConfig, Trainer
    from repro_torch.train.straggler import StragglerDetector

    dev = resolve_device(args.device)
    cfg = get_config(args.arch, args.variant)
    model = build_model(cfg, dev, seed=None)
    tcfg = TrainConfig(microbatches=args.microbatches,
                       total_steps=args.steps)
    trainer = Trainer(model, tcfg, seed=0)

    ckpt_dir = args.ckpt_dir or os.path.join(tempfile.gettempdir(),
                                             f"repro_torch_ckpt_{cfg.name}")
    log_path = os.path.join(ckpt_dir, "transfers.jsonl")
    os.makedirs(ckpt_dir, exist_ok=True)
    start = latest_step(ckpt_dir) or 0
    if start:
        # the parameters and their float32 master copies (the reference
        # restores the parameters alone and keeps the fresh master, which
        # its first update then writes back over them)
        host = split_reference_paths(paths_from_tree(
            restore_checkpoint(ckpt_dir, device=dev)))
        with torch.no_grad():
            for name, p in trainer.params.items():
                if name in host:
                    p.copy_(host[name])
                    trainer.opt_state["master"][name].copy_(host[name])
        print(f"resumed from step {start}")

    pipe = TokenPipeline(
        DataConfig(cfg.vocab_size, args.global_batch, args.seq,
                   n_codebooks=cfg.n_codebooks, seed=start),
        PipelineParams(cc=2, p=2, pp=3))
    patches = torch.Generator(device=dev).manual_seed(start)
    n_patches = min(cfg.n_patches, args.seq)

    def batches():
        for _ in range(args.steps):
            batch = pipe.next_batch()
            if cfg.vision_stub:
                batch = dict(batch, patch_embeds=(0.02 * torch.randn(
                    (args.global_batch, n_patches, cfg.d_model),
                    generator=patches, device=dev)).to(cfg.dtype))
            yield batch

    detector = StragglerDetector(n_hosts=1)
    ckpt_params = CkptParams()

    def on_step(step, m):
        nonlocal ckpt_params
        detector.record(np.array([m["step_time_s"]]))
        if step % 10 == 0:
            print(f"step {start + step} loss={m['loss']:.4f} "
                  f"{m['step_time_s'] * 1e3:.0f}ms")
        if (step + 1) % args.ckpt_every == 0:
            stats = save_checkpoint(ckpt_dir, start + step + 1,
                                    reference_paths(trainer.params),
                                    params=ckpt_params, log_path=log_path)
            print(f"ckpt @{start + step + 1}: "
                  f"{stats['throughput_mbps']:.0f} Mbps "
                  f"(cc={ckpt_params.cc},p={ckpt_params.p},pp={ckpt_params.pp})")
            if args.tune_ckpt and os.path.exists(log_path):
                with open(log_path) as fh:
                    n_logged = sum(1 for _ in fh)
                if n_logged >= 8:
                    ckpt_params = CheckpointTuner(
                        log_path, device=dev).fit().recommend()

    try:
        log = trainer.run(batches(), on_step=on_step)
    finally:
        pipe.close()
    print(f"done; device: {device_name(dev)}")
    return log


if __name__ == "__main__":
    main()
