"""Serving launcher: batched prefill + greedy decode, the port of
``repro.launch.serve``.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-7b \\
        --variant smoke --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-7b \\
        --variant full --batch 8 --prompt-len 2048 --tokens 65
    PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-1.6b \\
        --variant full --batch 8 --prompt-len 2048 --tokens 65
    PYTHONPATH=src python -m repro_torch.launch.serve --arch minitron-4b \\
        --variant full --batch 8 --prompt-len 2048 --tokens 65
    PYTHONPATH=src python -m repro_torch.launch.serve --arch musicgen-large \\
        --variant full --batch 8 --prompt-len 2048 --tokens 65
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-vl-2b \\
        --variant full --batch 8 --prompt-len 2048 --tokens 65

``--arch`` takes every registered id (``repro_torch.configs.all_archs``):
the hybrid, RWKV6, dense, MoE, audio and vision-language families.  An
audio model's prompts and picks are (B, S, CB) codebook ids.  The CLI, like
the reference's launcher, gives a vision-language model no patch
embeddings; ``serve`` takes them.  There is no depth option, as
the reference's launcher has none: a full model that does not fit one card
(mixtral-8x22b, llama3-405b) is served cut in depth through the library,
as ``chip_smoke.py`` does with ``dataclasses.replace(cfg, n_layers=8)``.

Weights and prompts come from seeded ``torch.Generator``s on the device.
The run prints the reference's line (prefill ms, decode p50 ms, tok/s) and
the device's name.  It runs on the card unless ``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.device import resolve_device
from repro_torch.models.model import Model, build_model


@dataclasses.dataclass
class ServeResult:
    """One batch served: greedy ``tokens`` (B, n), or (B, n, CB) with
    codebooks (the first from the prefill), host wall times of the prefill
    and of each decode step (each ending in a device synchronise), the
    decode cache as the last step left it, and, when kept, the prefill's
    logits (B, 1, V) and each decode step's (B, 1, V) ((B, 1, CB, V) with
    codebooks)."""
    tokens: torch.Tensor
    prefill_ms: float
    decode_ms: list[float]
    cache: dict
    prefill_logits: torch.Tensor | None = None
    decode_logits: list[torch.Tensor] | None = None

    def decode_p50_ms(self) -> float:
        """Median decode step, the first step left out as warm-up (as the
        reference does)."""
        lat = self.decode_ms[1:] or self.decode_ms
        return float(np.percentile(lat, 50))


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def make_prompts(cfg, batch: int, prompt_len: int, *, seed: int = 0,
                 device=None) -> torch.Tensor:
    """(batch, prompt_len) int64 token ids, (batch, prompt_len, CB) with
    codebooks, uniform over the vocabulary, from a seeded generator on
    ``device``."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    shape = (batch, prompt_len) + ((cfg.n_codebooks,) if cfg.n_codebooks
                                   else ())
    return torch.randint(0, cfg.vocab_size, shape, generator=gen, device=dev)


def serve(model: Model, prompts: torch.Tensor, n_tokens: int, *,
          force: torch.Tensor | None = None,
          patch_embeds: torch.Tensor | None = None,
          keep_logits: bool = False) -> ServeResult:
    """Prefill ``prompts`` (B, S), or (B, S, CB) with codebooks, then
    decode greedily until ``n_tokens`` tokens (the prefill's included) are
    out: ``n_tokens - 1`` decode steps.  ``patch_embeds`` (B, n, d) go to
    the prefill (``Model.embed``).

    With ``force`` (B, n_tokens) or (B, n_tokens, CB), decode step j is fed
    ``force[:, j]`` instead of this run's own pick (teacher forcing);
    ``tokens`` still holds this run's own greedy picks.
    """
    dev = prompts.device
    B, S = prompts.shape[:2]
    cache = model.init_cache(B, S + n_tokens + 4)
    _sync(dev)
    t0 = time.perf_counter()
    logits, cache = model.prefill(prompts, cache, patch_embeds)
    _sync(dev)
    prefill_ms = (time.perf_counter() - t0) * 1e3
    tok = torch.argmax(logits, dim=-1)                   # (B, 1[, CB])
    picks, lat, step_logits = [tok], [], []
    for j in range(n_tokens - 1):
        feed = tok if force is None else force[:, j:j + 1]
        t0 = time.perf_counter()
        step, cache = model.decode(feed, cache)
        _sync(dev)
        lat.append((time.perf_counter() - t0) * 1e3)
        tok = torch.argmax(step, dim=-1)
        picks.append(tok)
        if keep_logits:
            step_logits.append(step)
    return ServeResult(tokens=torch.cat(picks, dim=1), prefill_ms=prefill_ms,
                       decode_ms=lat, cache=cache,
                       prefill_logits=logits if keep_logits else None,
                       decode_logits=step_logits if keep_logits else None)


def device_name(device: torch.device) -> str:
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return "cpu"


def main(argv=None) -> ServeResult:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--variant", default="smoke", choices=["smoke", "full"])
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--tokens", type=int, default=64)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card; 'cpu' only when asked")
    args = ap.parse_args(argv)
    if args.tokens < 1:
        ap.error("--tokens must be at least 1")

    cfg = get_config(args.arch, args.variant)
    dev = resolve_device(args.device)
    model = build_model(cfg, dev, seed=args.seed)
    prompts = make_prompts(cfg, args.batch, args.prompt_len, seed=args.seed,
                           device=dev)
    res = serve(model, prompts, args.tokens)
    B = args.batch
    line = f"arch={cfg.name} batch={B}: prefill {res.prefill_ms:.0f}ms"
    if res.decode_ms:
        p50 = res.decode_p50_ms()
        line += (f", decode p50 {p50:.2f}ms "
                 f"({B * 1e3 / p50:.0f} tok/s)")
    print(line)
    print(f"device: {device_name(dev)}")
    return res


if __name__ == "__main__":
    main()
