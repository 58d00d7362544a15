"""The port's fleet path against the JAX package's: ``run_fleet`` over the
threaded, vectorized and sharded engines, continuous refresh, the
``KnowledgeService``, fault recovery and the legacy ``FleetConfig`` shim.

Both packages run on the same knowledge: the reference's ``OfflineDB`` is
carried into the port through ``offline_db_to_state`` /
``offline_db_from_state(device="cpu")``, and each run gets a fresh copy, so
refits never leak from one run into the next.  The reference's kernel
dispatch goes through its Pallas kernels in interpret mode
(``use_pallas=True``); the port's runs with ``use_kernel=True``, which on
CPU tensors is each kernel's plain twin, and with the default
``use_kernel=None``, the CPU's non-kernel route.  Admission (``max_concurrent
=None``) goes through ``transfer_select`` on both sides: a gather, exact in
both, so every ``FleetReport`` is equal under ``plain``.  The one exception
is a refit through the batched float32 spline solve, whose coefficients
agree to rtol 1e-5 (``tests/test_torch_tuner.py``): the reports of such a run
are held to that tolerance, and a run with scalar float64 refits exactly.
"""
import copy
import math
import warnings

import numpy as np
import pytest

import repro.core as jcore
import repro.netsim as jn
import repro_torch.core as pcore
import repro_torch.core.fleet as pfleet
import repro_torch.netsim as pn
from _port_parity import interpret_reference_kernels, plain
from repro.core import fleet as jfleet
from repro_torch.core.state import offline_db_from_state, offline_db_to_state

START = 4 * 3600.0
CLASSES = ("small", "medium", "large")


@pytest.fixture(scope="module")
def dbs():
    env = jn.make_testbed("xsede", seed=3)
    hist = jn.generate_history(env, days=4, transfers_per_day=120, seed=0)
    ref = jcore.TransferTuner(jcore.TunerConfig(seed=0)).fit(hist).db
    return ref, offline_db_to_state(ref)


@pytest.fixture
def pallas(monkeypatch):
    interpret_reference_kernels(monkeypatch)


def _fresh(dbs):
    return copy.deepcopy(dbs[0]), offline_db_from_state(dbs[1], device="cpu")


def _requests(core, nm, n, seed0=500):
    return [core.FleetRequest(dataset=nm.make_dataset(CLASSES[i % 3], 30 + i),
                              env_seed=seed0 + i, start_clock_s=START,
                              constant_load=0.15)
            for i in range(n)]


def _run_both(dbs, n=8, *, ref_kw=(), port_kw=(), both_kw=(), make=None):
    """One fleet through each package; ``make(core, db)`` adds per-package
    config objects."""
    out = []
    for core, nm, db, kw in zip((jcore, pcore), (jn, pn), _fresh(dbs),
                                (dict(ref_kw), dict(port_kw))):
        kw.update(both_kw)
        if make is not None:
            kw.update(make(core, nm, db))
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)
            cfg = core.EngineConfig(**kw)
        out.append(core.run_fleet(db, _requests(core, nm, n), cfg))
    return out


def _assert_close(a, b, rtol, path="report"):
    """``a == b`` for every field but floats, which agree to ``rtol``."""
    if isinstance(a, float) and isinstance(b, float):
        assert math.isclose(a, b, rel_tol=rtol, abs_tol=rtol), (path, a, b)
    elif isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            _assert_close(a[k], b[k], rtol, f"{path}.{k}")
    elif isinstance(a, list):
        assert len(a) == len(b), path
        for i, (u, v) in enumerate(zip(a, b)):
            _assert_close(u, v, rtol, f"{path}[{i}]")
    else:
        assert a == b, (path, a, b)


KERNEL_ROUTES = [({"use_pallas": True}, {"use_kernel": True}),
                 ({}, {})]


def test_predict_demands_and_the_admission_cap_are_equal(dbs, pallas):
    ref, port = _fresh(dbs)
    link = jn.TESTBEDS["xsede"]
    for n in (1, 8, 64):
        want = jfleet.predict_demands(ref, _requests(jcore, jn, n),
                                      use_pallas=True)
        got = pfleet.predict_demands(port, _requests(pcore, pn, n),
                                     use_kernel=True)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
        assert pfleet.auto_concurrency(port, _requests(pcore, pn, n), link) \
            == jfleet.auto_concurrency(ref, _requests(jcore, jn, n), link)


@pytest.mark.parametrize("routes", KERNEL_ROUTES, ids=["kernel", "default"])
@pytest.mark.parametrize("engine", ["threaded", "vectorized", "sharded"])
def test_auto_admission_fleet_is_equal(dbs, pallas, engine, routes):
    extra = {"n_shards": 2} if engine == "sharded" else {}
    a, b = _run_both(dbs, ref_kw=routes[0], port_kw=routes[1],
                     both_kw=dict(engine=engine, **extra))
    assert plain(b) == plain(a)
    assert b.admitted_concurrency < 8        # the cap did bind
    assert len(b.reports) == 8


def test_refresh_fleet_with_scalar_refits_is_equal(dbs, pallas):
    a, b = _run_both(dbs, ref_kw={"use_pallas": True},
                     port_kw={"use_kernel": True},
                     make=lambda core, nm, db: {"refresh": core.RefreshConfig(
                         every_completions=2, min_entries=4,
                         batched_fit=False)})
    assert plain(b) == plain(a)
    assert b.refreshes >= 2 and b.refreshed_entries > 0


def test_refresh_fleet_with_batched_refits_agrees(dbs, pallas):
    kw = ({"use_pallas": True}, {"use_kernel": True})
    a, b = _run_both(dbs, ref_kw=kw[0], port_kw=kw[1],
                     make=lambda core, nm, db: {"refresh": core.RefreshConfig(
                         every_completions=2, min_entries=4,
                         **(kw[0] if core is jcore else kw[1]))})
    assert b.refreshes >= 2
    _assert_close(plain(a), plain(b), rtol=1e-5)


@pytest.mark.parametrize("engine", ["threaded", "vectorized"])
def test_knowledge_service_fleet_is_equal(dbs, pallas, engine):
    services = {}

    def make(core, nm, db):
        key = "use_pallas" if core is jcore else "use_kernel"
        services[core] = core.KnowledgeService(db, core.ServiceConfig(
            max_staleness_s=120.0, drift_threshold=0.1, **{key: True}))
        return {"knowledge": services[core]}

    a, b = _run_both(dbs, both_kw=dict(engine=engine, max_concurrent=4),
                     ref_kw={"use_pallas": True}, port_kw={"use_kernel": True},
                     make=make)
    assert plain(b) == plain(a)
    assert plain(services[pcore].stats()) == plain(services[jcore].stats())
    assert b.refreshes >= 1 or b.refreshed_entries >= 1


def test_faulted_fleet_with_recovery_is_equal(dbs, pallas):
    def make(core, nm, db):
        faults = nm.FaultSchedule((
            nm.TenantKill(START + 30.0, tenant_id=0),
            nm.TenantKill(START + 45.0, tenant_id=2),
            nm.CapacityDrop(START + 25.0, 300.0, factor=0.3)))
        return {"faults": faults, "recovery": core.RecoveryConfig()}

    for engine in ("threaded", "vectorized"):
        a, b = _run_both(dbs, ref_kw={"use_pallas": True},
                         port_kw={"use_kernel": True},
                         both_kw={"engine": engine}, make=make)
        assert plain(b) == plain(a)
        assert b.kills >= 1 and b.recoveries >= 1


def test_legacy_fleet_config_shim_is_equal(dbs, pallas):
    out = []
    for core, nm, db in zip((jcore, pcore), (jn, pn), _fresh(dbs)):
        cfg = core.FleetConfig(refresh=core.RefreshConfig(
            every_completions=3, min_entries=4, batched_fit=False))
        with pytest.warns(DeprecationWarning, match="EngineConfig"):
            out.append(core.run_fleet(db, _requests(core, nm, 6), cfg))
    assert plain(out[1]) == plain(out[0])
    legacy = pcore.EngineConfig.from_fleet_config(pcore.FleetConfig(),
                                                  engine="vectorized")
    assert legacy.use_kernel is None and legacy.engine == "vectorized"
