"""Cells at a size the CPU holds: the cells' own configurations cut to the
port's smoke sizes, their traffic shrunk, their limits as they are."""
from __future__ import annotations

import dataclasses

from bench import harness

SMOKE_MIX = {
    "prefill": {"kind": "prefill", "tokens_per_batch": 64,
                "lengths": [16, 32, 64]},
    "decode": {"kind": "decode", "batch": 4,
               "prompt_len": 16, "new_tokens": 10, "generated_before": 4,
               "cache_slack": 4},
}
SMOKE_SAMPLE = {"prefill": {"tokens": 160, "kv_positions": 8},
                "decode": {"rows": 4}}


def smoke_cfg(name: str, **over) -> dict:
    """``configs/<name>.json`` at the port's smoke sizes."""
    from repro_torch.configs import get_config
    cfg = dict(harness.load("configs", name))
    small = get_config(name, "smoke")
    cfg.update({k: getattr(small, k) for k in harness.PROGRAM_KEYS
                if k != "name"})
    cfg.update(over)
    return cfg


def smoke_cell(name: str, **over) -> harness.Cell:
    """The cell ``name`` at smoke size, with its own limits."""
    c = harness.cell(name)
    kind = c.mix["kind"]
    return dataclasses.replace(c, cfg=smoke_cfg(c.cfg["name"], **over),
                               mix=dict(SMOKE_MIX[kind]),
                               sample=dict(SMOKE_SAMPLE[kind]))


CELLS = ("zamba2-7b.prefill", "minitron-4b.decode",
         "minitron-4b.prefill-long")
