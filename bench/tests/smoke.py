"""Cells at a size the CPU holds: the cells' own configurations cut to the
port's smoke sizes, their traffic shrunk, their limits as they are.  The
cells are read from ``BENCHMARK.json`` (``CELLS``, which the card runs)
and from the workload files (``FILED``, which the CPU runs), so a cell
added by files and entries alone gets the smoke and fault tests with no
edit here."""
from __future__ import annotations

import dataclasses
import json

from bench import families, harness

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
    """``configs/<name>.json`` at the port's smoke sizes: its family's
    program keys taken from the smoke variant of the port's configuration
    of the same name, or of the one its ``port_config`` names."""
    from repro_torch.configs import get_config
    cfg = dict(harness.load("configs", name))
    small = get_config(cfg.get("port_config", name), "smoke")
    cfg.update({k: getattr(small, k) for k in families.of(cfg).PROGRAM_KEYS
                if k not in ("name", "family")})
    cfg.update(over)
    return cfg


def smoke_cell(name: str, **over) -> harness.Cell:
    """The cell ``name`` at smoke size, with its own limits."""
    c = harness.cell(name)
    kind = c.mix["kind"]
    return dataclasses.replace(c, cfg=smoke_cfg(c.cfg["name"], **over),
                               mix=dict(SMOKE_MIX[kind]),
                               sample=dict(SMOKE_SAMPLE[kind]))


CELLS = tuple(w["name"] for w in json.loads(
    (harness.ROOT / "BENCHMARK.json").read_text())["workloads"])
# every cell its files define (``workloads/<cell>.json``), whether or not
# ``BENCHMARK.json`` lists it: a cell taken out of the benchmark keeps its
# CPU smoke and fault runs, so that it can come back by entries alone
FILED = tuple(sorted(p.stem for p in (harness.BENCH / "workloads").glob(
    "*.json")))
