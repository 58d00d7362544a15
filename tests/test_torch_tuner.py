"""The port's online phase against the JAX package's.

Both packages run on the same fitted knowledge: the reference's ``OfflineDB``
is carried into the port through ``offline_db_to_state`` /
``offline_db_from_state``, so online parity is judged apart from float32
drift in clustering.  The online phase is numpy float64 in both packages,
so every ``TransferReport`` must be equal field for field; a refresher run
refits through the batched float32 spline solve and must refit the same
clusters into the same knowledge (coefficients to rtol 1e-5).
"""
import copy

import numpy as np
import pytest

import repro.core as jcore
import repro.netsim as jn
import repro_torch.core as pcore
import repro_torch.netsim as pn
from _port_parity import plain
from repro_torch.core.state import offline_db_from_state, offline_db_to_state

RTOL = 1e-5


@pytest.fixture(scope="module")
def dbs():
    env = jn.make_testbed("xsede", seed=3)
    hist = jn.generate_history(env, days=4, transfers_per_day=120, seed=0)
    ref = jcore.TransferTuner(jcore.TunerConfig(seed=0)).fit(hist).db
    return ref, offline_db_to_state(ref)


def _port_db(dbs):
    return offline_db_from_state(dbs[1], device="cpu")


def test_state_round_trip_keeps_everything(dbs):
    ref, state = dbs
    back = offline_db_to_state(_port_db(dbs))
    assert plain(back) == plain(state)
    assert plain(state["clusters"][0]["entries"][0]) == plain(
        list(ref.clusters[0].entries[0].__dict__.values()))


def _faults(nm, kind, t0):
    if kind == "drop":
        return nm.FaultSchedule((nm.CapacityDrop(t0 + 15.0, 600.0,
                                                 factor=0.12),))
    if kind == "flap":
        return nm.FaultSchedule((nm.LinkFlap(t0 + 20.0, 60.0,
                                             residual=0.03),))
    if kind == "burst":
        return nm.FaultSchedule((nm.LossBurst(
            t0 + 10.0, 120.0, loss_sensitivity_mult=5.0,
            streams_to_saturate_mult=3.0, goodput_factor=0.4),))
    if kind == "kill":
        return nm.FaultSchedule((nm.TenantKill(t0 + 30.0),))
    return None


def _session(core, nm, db, kind, recovery, testbed="xsede"):
    env = nm.make_testbed(testbed, seed=42)
    env.clock_s = 5 * 3600.0
    env.faults = _faults(nm, kind, env.clock_s)
    dataset = nm.make_dataset("medium", 7)
    sampler = core.AdaptiveSampler(
        db, recovery=core.RecoveryConfig() if recovery else None)
    return sampler.transfer(env, dataset), env.clock_s


@pytest.mark.parametrize("recovery", [False, True])
@pytest.mark.parametrize("kind", [None, "drop", "flap", "burst", "kill"])
def test_transfer_reports_are_equal(dbs, kind, recovery):
    ref_report = _session(jcore, jn, dbs[0], kind, recovery)
    port_report = _session(pcore, pn, _port_db(dbs), kind, recovery)
    assert plain(port_report) == plain(ref_report)
    if kind == "drop" and recovery:
        assert port_report[0].collapses >= 1
    assert port_report[0].interrupted == (kind == "kill")


@pytest.mark.parametrize("testbed", ["xsede", "didclab", "didclab-xsede"])
def test_quickstart_flow_is_equal(dbs, testbed):
    """The quickstart's TransferTuner flow: recommend, then transfer."""
    out = []
    for core, nm, db in ((jcore, jn, dbs[0]), (pcore, pn, _port_db(dbs))):
        tuner = core.TransferTuner(core.TunerConfig(seed=0))
        tuner.db = db
        live = nm.make_testbed(testbed, seed=42)
        live.clock_s = 5 * 3600.0
        dataset = nm.make_dataset("medium", 7)
        rec = tuner.recommend(live, dataset)
        report = tuner.transfer(live, dataset)
        out.append((rec, report, report.steady_mbps,
                    report.prediction_accuracy, report.predicted_mbps))
    assert plain(out[1]) == plain(out[0])


def _refresh_run(core, nm, db, use_kernel_kw):
    refresher = core.KnowledgeRefresher(
        db, nm.make_testbed("xsede", seed=0).link,
        core.RefreshConfig(every_completions=2, min_entries=4,
                           **use_kernel_kw))
    tuner = core.TransferTuner(core.TunerConfig(seed=0))
    tuner.db = db
    fired = []
    for i in range(4):
        env = nm.make_testbed("xsede", seed=50 + i)
        env.clock_s = (2 + 5 * i) * 3600.0
        dataset = nm.make_dataset(("small", "medium", "large", "medium")[i],
                                  60 + i)
        report = tuner.transfer(env, dataset)
        fired.append(refresher.observe(report, dataset, now_s=env.clock_s))
    staleness = {k: (s.last_refresh_s, s.entries_since_refresh, s.refreshes)
                 for k, s in refresher.staleness.items()}
    return fired, refresher.refreshes, refresher.entries_folded, staleness


def test_knowledge_refresher_refits_the_same_clusters(dbs):
    ref_db, port_db = copy.deepcopy(dbs[0]), _port_db(dbs)
    a = _refresh_run(jcore, jn, ref_db, {"use_pallas": False})
    b = _refresh_run(pcore, pn, port_db, {})
    assert b == a
    assert b[1] >= 1 and any(s[2] for s in b[3].values())
    for ca, cb in zip(ref_db.clusters, port_db.clusters):
        assert len(ca.entries) == len(cb.entries)
        assert [s.argmax_params.as_tuple() for s in ca.surfaces] == [
            s.argmax_params.as_tuple() for s in cb.surfaces]
        for sa, sb in zip(ca.surfaces, cb.surfaces):
            np.testing.assert_array_equal(sa.surface.grid, sb.surface.grid)
            np.testing.assert_allclose(
                sb.surface.ppc, sa.surface.ppc, rtol=RTOL,
                atol=RTOL * np.abs(sa.surface.grid).max())
