"""Assigned input-shape sets and input stand-ins per (arch, shape)
(``repro.launch.shapes``).

``decode_*`` / ``long_*`` run ``decode`` (one token against a KV/state
cache); ``train_4k`` runs the train step; ``prefill_32k`` runs the
cache-filling prefill.  ``long_500k`` requires sub-quadratic attention and
only applies to SSM / hybrid / sliding-window archs.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.models.config import ModelConfig


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str             # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES = {
    "train_4k": ShapeSpec("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524288, 1),
}

# archs with sub-quadratic attention paths; everything else skips long_500k
LONG_CONTEXT_OK = {"zamba2-7b", "rwkv6-1.6b", "mixtral-8x22b"}

# per-arch gradient-accumulation microbatches for the train_4k step
TRAIN_MICROBATCHES = {
    "llama3-405b": 8,
    "deepseek-v3-671b": 8,
    "mixtral-8x22b": 4,
    "qwen2.5-32b": 4,
    "internlm2-20b": 4,
    "zamba2-7b": 2,
    "default": 2,
}


def applicable_cells() -> list[tuple[str, str]]:
    from repro_torch.configs import all_archs
    cells = []
    for arch in all_archs():
        for sname in SHAPES:
            if sname == "long_500k" and arch not in LONG_CONTEXT_OK:
                continue
            cells.append((arch, sname))
    # the reference's order: zamba2 last, train_4k first within an arch
    cells.sort(key=lambda c: (c[0] == "zamba2-7b", c[1] != "train_4k"))
    return cells


def input_specs(cfg: ModelConfig, shape: ShapeSpec, device="meta") -> dict:
    """Stand-ins for every model input with the reference's shapes and
    dtypes that allocate nothing: tensors on the ``meta`` device, or, with
    ``device`` a real device inside a ``FakeTensorMode``, fake tensors
    there.  Decode takes one new token; its cache comes from
    ``Model.init_cache``."""
    B, S = shape.global_batch, shape.seq_len
    i32 = torch.int32

    def spec(shp, dtype):
        return torch.empty(shp, dtype=dtype, device=device)

    if shape.kind in ("train", "prefill"):
        tok_shape = (B, S, cfg.n_codebooks) if cfg.n_codebooks else (B, S)
        specs = {"tokens": spec(tok_shape, i32)}
        if shape.kind == "train":
            specs["labels"] = spec(tok_shape, i32)
        if cfg.vision_stub:
            specs["patch_embeds"] = spec((B, cfg.n_patches, cfg.d_model),
                                         cfg.dtype)
        return specs
    tok_shape = (B, 1, cfg.n_codebooks) if cfg.n_codebooks else (B, 1)
    return {"tokens": spec(tok_shape, i32)}
