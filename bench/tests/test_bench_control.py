"""The control: the reference in float8 put in the program's place must
come out not correct under each cell's own limits, while the program
passes them.  On the card the control is read at the cells' own sizes
(``bench/control.py``); here each cell's configuration is cut to a size
the CPU holds, deep and wide enough that the precisions' gaps open as
they do at full size (zamba2-7b's grow with depth: at the port's smoke
size of 4 layers its float8 state reads ~0.22, under the limit)."""
from __future__ import annotations

import dataclasses
import time

import pytest

from bench import harness
from bench.tests.smoke import smoke_cell

SIZES = {
    "zamba2-7b.prefill": dict(n_layers=24, d_model=256, n_heads=4,
                              n_kv_heads=4, d_ff=512, vocab_size=2048,
                              ssm_state=32, ssm_head_dim=32,
                              hybrid_attn_every=6, ssm_chunk=64),
    "minitron-4b.prefill-long": dict(n_layers=8, d_model=256, n_heads=4,
                                     n_kv_heads=2, d_ff=768,
                                     vocab_size=4096),
    "minitron-4b.decode": dict(n_layers=12, d_model=256, n_heads=4,
                               n_kv_heads=2, d_ff=768, vocab_size=4096),
}
MIX = {"prefill": dict(tokens_per_batch=256, lengths=[64, 128, 256]),
       "decode": dict(batch=16, prompt_len=64, new_tokens=96,
                      generated_before=32)}
SAMPLE = {"prefill": {"tokens": 1024, "kv_positions": 16},
          "decode": {"rows": 16}}


@pytest.mark.parametrize("name", sorted(SIZES))
def test_control_is_not_correct(name):
    c = smoke_cell(name, **SIZES[name])
    kind = c.mix["kind"]
    c = dataclasses.replace(c, mix=dict(c.mix, **MIX[kind]),
                            sample=SAMPLE[kind])
    checks = harness.run_cell(c, 2 ** 31 + 3, 3.0, False, "cpu",
                              time.perf_counter(), control=True).checks
    assert checks["correct"], checks
    # the control goes through the check's own verdict, and fails it
    assert checks["control_correct"] is False, checks
    ctl = checks["control"]
    assert any(ctl[n] > limit for n, limit in checks["limits"].items()), \
        checks
