"""The cells on the card, each run once for a short window through the
benchmark's own command; skips without a card."""
from __future__ import annotations

import json
import subprocess
import sys

import pytest

from bench import harness
from bench.tests.smoke import CELLS


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_cell_runs_correct_on_the_card(name, cuda_card):
    res = subprocess.run(
        [sys.executable, "bench/run.py", "--workload", name, "--seed",
         str(2 ** 31 + 99), "--seconds", "5", "--trace", "1"],
        cwd=harness.ROOT, capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    line = json.loads(res.stdout.strip().splitlines()[-1])
    assert line["correct"] is True, line["checks"]
    assert line["device"]["busy_s"] > 0
