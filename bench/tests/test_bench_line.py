"""``BENCHMARK.json`` against the benchmark's files, the result line's
keys, the metric readers and the trace's arithmetic."""
from __future__ import annotations

import json
import re

import pytest

from bench import harness, run, traffic
from bench.trace import Trace

BENCH = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "bench/run.py"]
    assert BENCH["paths"] == ["bench"]
    assert isinstance(BENCH["run_seconds"], int)
    cells = len(BENCH["workloads"])
    # a full check of 24 cells in its time budget
    assert (2 + 14 * 24) * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 \
        <= 43200
    assert 1 <= cells <= 24


def test_names_units_and_whys():
    entries = BENCH["configs"] + BENCH["workloads"] + BENCH["end_to_end"] \
        + BENCH["per_layer"]
    names = [e["name"] for e in entries]
    assert all(NAME.match(n) for n in names)
    assert len(set(e["name"] for e in BENCH["end_to_end"] + BENCH["per_layer"])) \
        == len(BENCH["end_to_end"]) + len(BENCH["per_layer"])
    for e in BENCH["configs"] + BENCH["workloads"]:
        assert 1 <= len(e["why"]) <= 200 and "\n" not in e["why"]
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")


def test_configs_files_and_cells_agree():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        cfg = json.loads((harness.ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
        assert any(w["config"] == c["name"] for w in BENCH["workloads"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        spec = harness.load("workloads", w["name"])
        assert (spec["config"], spec["traffic"]) == (w["config"], w["traffic"])
        assert w["chips"] == 1
        c = harness.cell(w["name"])
        assert c.limits
        assert (harness.BENCH / "reference"
                / f"{c.cfg['reference']}.py").is_file()
        assert (harness.BENCH / "families" / f"{c.cfg['family']}.py").is_file()


# keys that name a width, which ``reduced`` may not name
WIDTH = re.compile(r"(_dim|_rank|_size)$|intermediate|latent|expand"
                   r"|per_tok|d_model|d_ff")


@pytest.mark.parametrize("name", [c["name"] for c in BENCH["configs"]])
def test_configurations_name_their_departures(name):
    cfg = harness.load("configs", name)
    assert cfg["reduced"], "each departs from its source"
    for key in cfg["reduced"]:
        assert key in cfg and NAME.match(key) and not WIDTH.search(key), key
    assert all(isinstance(d, str) and d for d in cfg["departs_from_published"])
    line = harness.rendition(cfg)
    assert line.startswith(name) and cfg["source"] in line and "\n" not in line
    broken = dict(cfg)
    broken.pop("departs_from_published")
    with pytest.raises(KeyError):
        harness.rendition(broken)


@pytest.mark.parametrize("name", ["zamba2-7b", "minitron-4b"])
def test_configurations_are_the_port_s(name):
    from repro_torch.configs import get_config
    want = get_config(name, "full")
    cfg = harness.program_config(harness.load("configs", name))
    assert cfg == want


def test_every_metric_has_a_reader_and_is_reported():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert (harness.BENCH / "metrics" / f"{m['name']}.py").is_file()
    for w in BENCH["workloads"]:
        mine = [m["name"] for m in BENCH["end_to_end"]
                if run.applies(m, w["name"])]
        assert "setup_s" in mine and len(mine) >= 2
        layers = [m for m in BENCH["per_layer"] if run.applies(m, w["name"])]
        assert layers
        for m in layers:
            assert m["moves"] in mine, (w["name"], m["name"])


def _run(kind: str, trace: Trace | None = None) -> harness.Run:
    c = harness.cell({"prefill": "zamba2-7b.prefill",
                      "decode": "minitron-4b.decode"}[kind])
    prefills = [harness.Prefill(32, 512, 1.2), harness.Prefill(2, 8192, 1.3)] \
        if kind == "prefill" else []
    steps = [harness.Step(64, 1030 + i, 0.15, 0.1) for i in range(5)] \
        if kind == "decode" else []
    r = harness.Run(c, setup_s=20.0, window_s=2.5, prefills=prefills,
                    steps=steps, ttft_s=[1.2] * 32 + [1.3] * 2,
                    tokens=33000 if kind == "prefill" else 320,
                    requests=34 if kind == "prefill" else 64,
                    peak_bytes=3 << 30, trace=trace)
    r.checks = {"correct": True, "values": {"token_gap": 0.01},
                "limits": dict(c.limits)}
    return r


def _trace() -> Trace:
    ops = [("nvjet_gemm", 0, 400), ("ssd_scan_bf16_kernel", 300, 600),
           ("void at::native::elementwise_kernel<x>", 700, 900),
           ("flash_attention_bf16_kernel<7>", 900, 950)]
    host = [("window", 0, 1000), ("serve", 0, 800), ("aten::mm", 600, 650),
            ("sync", 800, 1000)]
    return Trace(0, 1000, ops, host)


@pytest.mark.parametrize("kind", ["prefill", "decode"])
@pytest.mark.parametrize("traced", [False, True])
def test_result_line_keys(kind, traced):
    r = _run(kind, _trace() if traced else None)
    name = r.cell.name
    line = run.result_line(r, BENCH, name, traced, "NVIDIA H100 80GB HBM3", 1)
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert list(line)[-1] == "checks"
    assert set(line["checks"]) == set(r.cell.limits)
    assert all(set(v) == {"value", "limit"} for v in line["checks"].values())
    dev = line["device"]
    assert dev["platform"] == "gpu" and dev["count"] == 1
    assert dev["memory_peak_bytes"] == 3 << 30
    for v in line["metrics"].values():
        assert set(v) == {"value", "unit"} and v["value"] > 0
    group = "per_layer" if traced else "end_to_end"
    listed = {m["name"] for m in BENCH[group] if run.applies(m, name)}
    assert set(line["metrics"]) <= listed
    if traced:
        assert dev["busy_s"] > 0 and dev["window_s"] > 0
        bd = line["breakdown"]
        assert set(bd) == {"device_ops", "idle_gaps"}
        assert len(bd["device_ops"]) <= 10 and len(bd["idle_gaps"]) <= 10
    else:
        assert "breakdown" not in line
        assert set(line["metrics"]) == listed
    json.dumps(line)


def test_readers_find_nothing_in_an_untraced_run():
    r = _run("prefill")
    for name in ("ssd_scan_roofline", "flash_attention_roofline",
                 "idle_share.prefill", "plain_ops_share.prefill"):
        assert run._reader(name)(r) is None
    assert run._reader("itl_p95_ms")(r) is None
    # the 95th percentile of 34 requests lies 0.35 of the way from the
    # 32nd to the 33rd slowest
    assert run._reader("ttft_p95_ms")(r) == pytest.approx(1235.0)


def test_trace_busy_is_the_union():
    tr = _trace()
    assert tr.window_s == pytest.approx(1e-6)
    assert tr.busy_s == pytest.approx(850e-9)      # 0-600, 700-950
    gaps = tr.idle_gaps()
    assert [g[0] for g in gaps] == ["serve/aten::mm", "sync"]
    assert gaps[0][1] == pytest.approx(100e-9)
    assert tr.top_ops(1) == [["nvjet_gemm", pytest.approx(400e-9)]]


def test_prefill_shares_from_a_trace():
    r = _run("prefill", _trace())
    plain = run._reader("plain_ops_share.prefill")(r)
    assert plain == pytest.approx(100 * 200 / 950)
    assert run._reader("idle_share.prefill")(r) == pytest.approx(15.0)
    # one launch a layer per prefill, or nothing to read
    assert run._reader("ssd_scan_roofline")(r) is None
    assert run._reader("idle_share.decode")(r) is None


def test_mfu_readers():
    from bench import roofline
    r = _run("prefill")
    cfg = r.cell.cfg
    want = 100 * (roofline.least_s(*roofline.prefill(cfg, 32, 512))
                  + roofline.least_s(*roofline.prefill(cfg, 2, 8192))) / 2.5
    assert run._reader("mfu.prefill")(r) == pytest.approx(want)
    d = _run("decode")
    assert 0 < run._reader("mfu.decode")(d) < 100
    assert run._reader("decode.enqueue_ms")(d) == pytest.approx(100.0)
    assert run._reader("itl_p95_ms")(d) == pytest.approx(150.0)
    assert run._reader("tokens_per_s")(d) == pytest.approx(128.0)
    assert run._reader("tokens_per_s.decode")(d) == pytest.approx(128.0)
    assert run._reader("peak_mem_gib.decode")(d) == pytest.approx(3.0)


def test_traffic_mixes_are_data():
    for w in BENCH["workloads"]:
        mix = harness.load("traffic", w["traffic"])
        assert next(traffic.batches(mix, 1)).index == 0
