"""The check's own arithmetic: the verdict that judges the program and the
control alike, the gaps layer by layer, the first layer's number, and the
witness's rounding."""
from __future__ import annotations

import math
import types

import pytest
import torch

from bench import check
from bench.reference import quant

CELL = types.SimpleNamespace(limits={"logit_err": 0.2, "state_err": 0.5})


@pytest.mark.parametrize("values,want", [
    ({"logit_err": 0.1, "state_err": 0.4}, True),
    ({"logit_err": 0.2, "state_err": 0.5}, True),
    ({"logit_err": 0.3, "state_err": 0.4}, False),
    ({"logit_err": 0.1}, False),
    ({"logit_err": 0.1, "state_err": math.nan}, False),
])
def test_one_verdict_for_program_and_control(values, want):
    assert check.passes(CELL, values) is want
    v = check._verdict(CELL, {"logit_err": 0.0, "state_err": 0.0}, values, {})
    assert v["correct"] is True and v["control_correct"] is want
    assert check._verdict(CELL, values, None, {})["control_correct"] is None


def _state(errs: dict) -> tuple[dict, dict]:
    """A state and its reference whose layer i of leaf l lies errs[l][i]
    away in relative L2."""
    got, want = {}, {}
    for leaf, e in errs.items():
        w = torch.ones(len(e), 4)
        want[leaf] = w
        got[leaf] = w * (1 + torch.tensor(e)[:, None])
    return got, want


def test_layer_errs_and_worst():
    got, want = _state({"ssm": [0.01, 0.2, 0.05], "conv": [0.03, 0.1]})
    by = check.layer_errs(got, want, "cpu")
    assert by["ssm"] == pytest.approx([0.01, 0.2, 0.05])
    assert check.worst(by) == (pytest.approx(0.2), "ssm[1]")
    assert check.state_err(got, want, "cpu")[1] == "ssm[1]"
    by["conv"][1] = math.nan
    assert check.worst(by)[1] == "conv[1]"


def test_prefill_numbers_first_layer_and_by_layer():
    side = check._Prefills()
    for errs in ({"ssm": [0.01, 0.3], "k": [0.02]},
                 {"ssm": [0.04, 0.1], "k": [0.005]}):
        got, want = _state(errs)
        want["logits"] = torch.ones(8)
        side.add(torch.ones(8) * 1.1, got, want, "cpu")
    v = side.values()
    assert v["logit_err"] == pytest.approx(0.1)
    assert v["state_err"] == pytest.approx(0.3)
    assert v["state_err_first"] == pytest.approx(0.04)
    by = side.by_layer()
    assert by["ssm"] == pytest.approx([0.04, 0.3])
    assert by["k"] == pytest.approx([0.02])


def test_no_request_reads_nan():
    v = check._Prefills().values()
    assert all(math.isnan(x) for x in v.values())
    assert not check.passes(CELL, v)


def test_witness_rounds_where_bf16_keeps_and_control_only_operands():
    t = torch.randn(64, 32) * 3
    for kind in ("activation", "weight", "output", "stream"):
        assert torch.equal(quant.bf16(t, kind),
                           t.to(torch.bfloat16).to(torch.float32))
    for kind in ("output", "stream"):
        assert quant.fp8(t, kind) is t
    rel8 = (quant.fp8(t, "activation") - t).norm() / t.norm()
    rel16 = (quant.bf16(t, "activation") - t).norm() / t.norm()
    assert rel16 < 0.005 < rel8
