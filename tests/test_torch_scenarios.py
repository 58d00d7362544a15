"""The port's scenario matrix against the JAX package's.

Every ``SCENARIO_MATRIX`` cell runs, with recovery on and off, through the
port's threaded engine on the reference's knowledge (carried over with
``offline_db_to_state`` / ``offline_db_from_state(device="cpu")``), and its
``canonical_trace`` must equal the reference's.  The port's vectorized and
sharded (strict) engines must give its threaded trace, and a DB fit by the
port itself on the CPU must give the reference's traces too: below 4096 log
rows the clustering is numpy float64 and the surface fit is numpy in both
packages, so nothing may differ.  The windowed sharded regime is held to
determinism and to the 10% band of ``benchmarks/fleet_shard.py`` around the
strict run.

Scenario cells pin ``max_concurrent`` to the fleet size, so they never reach
``transfer_select``; ``tests/test_torch_fleet.py`` covers the admission
path.  The reference suite runs its sharded engine over 4 host devices
(``tests/conftest.py``); here the card count is made 4 the same way, so the
default ``n_shards`` resolves to 4 shards.
"""
import pytest
import torch

import repro.core as jcore
import repro.netsim as jn
import repro.testing as jt
import repro_torch.core as pcore
import repro_torch.netsim as pn
import repro_torch.testing as pt
from _port_parity import plain
from repro_torch.core.engine import ShardedFleetEngine
from repro_torch.core.state import offline_db_from_state, offline_db_to_state

MATRIX = pt.SCENARIO_MATRIX
TESTBEDS = sorted({sc.testbed for sc in MATRIX})


@pytest.fixture(scope="module")
def dbs():
    ref = {tb: jt.build_scenario_db(tb) for tb in TESTBEDS}
    port = {tb: offline_db_from_state(offline_db_to_state(db), device="cpu")
            for tb, db in ref.items()}
    return ref, port


@pytest.fixture
def four_cards(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)


def test_the_matrix_is_the_reference_matrix():
    assert plain(MATRIX) == plain(jt.SCENARIO_MATRIX)
    assert len(MATRIX) == 21


@pytest.mark.parametrize("recovery", [False, True], ids=["norec", "rec"])
@pytest.mark.parametrize("sc", MATRIX, ids=lambda sc: sc.name)
def test_canonical_trace_equals_the_reference(dbs, sc, recovery):
    ref, port = dbs
    want = jt.run_scenario(ref[sc.testbed], jt.SCENARIO_MATRIX[
        MATRIX.index(sc)], recovery=recovery)
    got = pt.run_scenario(port[sc.testbed], sc, recovery=recovery)
    assert pt.canonical_trace(got) == jt.canonical_trace(want)
    assert plain(got) == plain(want)
    assert pt.check_invariants(sc, got, pt.build_requests(sc),
                               recovery=recovery) == []


@pytest.mark.parametrize("recovery", [False, True], ids=["norec", "rec"])
@pytest.mark.parametrize("sc", MATRIX, ids=lambda sc: sc.name)
def test_vectorized_and_sharded_equal_threaded(dbs, four_cards, sc, recovery):
    db = dbs[1][sc.testbed]
    threaded = pt.run_scenario(db, sc, recovery=recovery)
    vec = pt.run_scenario(db, sc, recovery=recovery, engine="vectorized")
    shd = pt.run_scenario(db, sc, recovery=recovery, engine="sharded")
    assert pt.canonical_trace(vec) == pt.canonical_trace(threaded)
    assert pt.canonical_trace(shd) == pt.canonical_trace(threaded)
    assert shd == vec                    # bit for bit, not approximately


@pytest.mark.parametrize("testbed", TESTBEDS)
def test_a_db_fit_by_the_port_gives_the_reference_traces(dbs, testbed):
    port_db = pt.build_scenario_db(testbed, device="cpu")
    for sc in (s for s in MATRIX if s.testbed == testbed):
        want = jt.run_scenario(dbs[0][testbed], jt.SCENARIO_MATRIX[
            MATRIX.index(sc)])
        got = pt.run_scenario(port_db, sc)
        assert pt.canonical_trace(got) == jt.canonical_trace(want), sc.name


@pytest.mark.parametrize("name", ["xsede-3-drop-constant",
                                  "xsede-3-churn-constant",
                                  "didclab-xsede-3-none-shift"])
def test_service_scenarios_equal_the_reference(name):
    """Knowledge through a ``KnowledgeService`` (streamed refits), on fresh
    DBs since the service refits them."""
    sc = next(s for s in MATRIX if s.name == name)
    ref_db = jt.build_scenario_db(sc.testbed)
    port_db = offline_db_from_state(offline_db_to_state(ref_db), device="cpu")
    want = jt.run_scenario(ref_db, jt.SCENARIO_MATRIX[MATRIX.index(sc)],
                           service=True)
    got = pt.run_scenario(port_db, sc, service=True)
    assert pt.canonical_trace(got) == jt.canonical_trace(want)


def _scale_requests(core, nm, n):
    return [core.FleetRequest(dataset=nm.make_dataset(
        ("small", "medium", "large")[i % 3], 7 + i), env_seed=99 + i,
        start_clock_s=4 * 3600.0, constant_load=0.15) for i in range(n)]


def _sharded(core, nm, db, window, n=256):
    return core.run_fleet(db, _scale_requests(core, nm, n), core.EngineConfig(
        engine="sharded", n_shards=4, shard_window_s=window,
        max_concurrent=8, score_vs_single=False))


def test_windowed_sharded_run_is_deterministic_and_close_to_strict(dbs):
    ref, port = dbs
    strict = _sharded(pcore, pn, port["xsede"], 0.0)
    a = _sharded(pcore, pn, port["xsede"], 120.0)
    b = _sharded(pcore, pn, port["xsede"], 120.0)
    assert pt.canonical_trace(a) == pt.canonical_trace(b)
    assert a.reports == b.reports and a.goodput_mbps == b.goodput_mbps
    assert len(a.reports) == 256 and len(a.sessions) == len(strict.sessions)
    assert a.goodput_mbps == pytest.approx(strict.goodput_mbps, rel=0.10)
    assert a.makespan_s == pytest.approx(strict.makespan_s, rel=0.10)
    want = _sharded(jcore, jn, ref["xsede"], 120.0)
    assert pt.canonical_trace(a) == jt.canonical_trace(want)


def test_default_shard_count_is_the_card_count(four_cards):
    cfg = pcore.EngineConfig(engine="sharded")
    assert ShardedFleetEngine._resolve_n_shards(cfg) == 4
    assert ShardedFleetEngine._resolve_n_shards(
        pcore.EngineConfig(engine="sharded", n_shards=3)) == 3
