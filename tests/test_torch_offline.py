"""The port's offline phase against the JAX package's: clustering on both
routes, the surface fit, the additive refit through the batched spline
solve, and the cross-network cold start.

Where the reference reaches a Pallas kernel (``use_pallas=True``) it runs in
interpret mode.  Tolerances: the clustering sweeps run in float32 in both
packages, with sums taken in another order, so centroids agree to 1e-4 and
labels exactly (the seeds are chosen, and asserted, to leave no point within
1e-4 (|x|^2 + |c|^2) of a tie); everything computed in numpy float64 is
bit-equal; the spline coefficients of a batched refit are float32 in both
packages and agree to rtol 1e-5 (absolute floor 1e-5 of the grid's scale),
as do the quantities read off them.
"""
import copy

import numpy as np
import pytest

import repro.core.clustering as jc
import repro.core.offline as joff
import repro.netsim as jn
import repro_torch.core.clustering as pc
import repro_torch.core.offline as poff
import repro_torch.netsim as pn
from _port_parity import interpret_reference_kernels, plain
from repro_torch.core.state import offline_db_from_state, offline_db_to_state

RTOL = 1e-5


def _no_near_tie(X, C):
    d2 = ((X[:, None, :] - C[None]) ** 2).sum(-1)
    two = np.sort(d2, axis=1)[:, :2]
    scale = (X ** 2).sum(1) + (C ** 2).sum(1).max()
    return ((two[:, 1] - two[:, 0]) > 1e-4 * scale).all()


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("n,batched", [(1500, True), (5000, None)])
def test_fit_clusters_matches_reference(monkeypatch, n, batched, use_kernel):
    interpret_reference_kernels(monkeypatch)
    X = pn.sample_feature_logs(n, seed=0)
    a = jc.fit_clusters(X, seed=0, batched=batched, use_pallas=use_kernel)
    b = pc.fit_clusters(X, seed=0, batched=batched, use_kernel=use_kernel,
                        device="cpu")
    assert _no_near_tie(X, a.centroids)
    assert (b.m, b.method) == (a.m, a.method)
    np.testing.assert_array_equal(b.labels, a.labels)
    np.testing.assert_allclose(b.centroids, a.centroids, rtol=0, atol=1e-4)
    np.testing.assert_allclose(b.counts, a.counts, rtol=0, atol=0)
    assert b.ch == pytest.approx(a.ch, rel=1e-4)


def test_fit_clusters_numpy_path_is_bit_equal():
    X = pn.sample_feature_logs(600, seed=4)
    for method in ("kmeans++", "hac"):
        m_range = range(2, 6) if method == "kmeans++" else range(2, 4)
        a = jc.fit_clusters(X[:300] if method == "hac" else X,
                            m_range=m_range, method=method, seed=1)
        b = pc.fit_clusters(X[:300] if method == "hac" else X,
                            m_range=m_range, method=method, seed=1,
                            device="cpu")
        assert plain(a) == plain(b)


# ------------------------------------------------------------------ #
# offline_analysis and the additive refit
# ------------------------------------------------------------------ #
def _history(nm, days, per_day, seed):
    return nm.generate_history(nm.make_testbed("xsede", seed=3), days=days,
                               transfers_per_day=per_day, seed=seed)


@pytest.fixture(scope="module")
def fitted():
    """One reference and one port DB fit on the same log."""
    a = joff.offline_analysis(_history(jn, 3, 150, 0), seed=0)
    b = poff.offline_analysis(_history(pn, 3, 150, 0), seed=0, device="cpu")
    return a, b


def _state(db):
    s = offline_db_to_state(db)
    s.pop("fit_seconds")
    return s


def _split(state):
    """(exact part, f32-solve-derived part) of a DB state.  A bin's load tag
    is read off the residuals against the base surface, so it is soft too."""
    soft = []
    for ck in state["clusters"]:
        for s in ck["surfaces"]:
            soft.append(s.pop("ppc"))
            soft.append(np.array([s.pop("sigma"), s.pop("max_throughput"),
                                  s.pop("load_intensity")]))
            soft.append(np.array([v for _, v, _ in s["local_maxima"]]))
            s["local_maxima"] = [(p, i) for p, _, i in s["local_maxima"]]
        soft.append(np.array(ck["region"].pop("separations")))
    return state, soft


def _assert_refit_close(a, b):
    (ea, sa), (eb, sb) = _split(_state(a)), _split(_state(b))
    assert plain(ea) == plain(eb)
    scale = max(np.abs(ck.surfaces[0].surface.grid).max() for ck in a.clusters)
    for x, y in zip(sa, sb):
        np.testing.assert_allclose(y, x, rtol=RTOL, atol=RTOL * scale)


def test_offline_analysis_is_bit_equal(fitted):
    a, b = fitted
    assert plain(_state(a)) == plain(_state(b))
    for ca, cb in zip(a.clusters, b.clusters):
        for sa, sb in zip(ca.surfaces, cb.surfaces):
            np.testing.assert_array_equal(sa.surface.grid, sb.surface.grid)
            assert sa.argmax_params.as_tuple() == sb.argmax_params.as_tuple()


def _copies(fitted):
    """Fresh copies to refit: the port's through its state round trip."""
    a, b = fitted
    return (copy.deepcopy(a),
            offline_db_from_state(offline_db_to_state(b), device="cpu"))


@pytest.mark.parametrize("use_kernel", [None, True])
def test_batched_update_matches_reference(monkeypatch, fitted, use_kernel):
    """60 fresh entries: scalar routing, all refits through the batched
    spline solve (the plain version on the CPU with use_kernel=None, the
    kernel route with use_kernel=True)."""
    interpret_reference_kernels(monkeypatch)
    a, b = _copies(fitted)
    ta = a.update(_history(jn, 1, 60, 9), batched_fit=True,
                  use_pallas=bool(use_kernel))
    tb = b.update(_history(pn, 1, 60, 9), batched_fit=True,
                  use_kernel=use_kernel)
    assert ta == tb and tb
    _assert_refit_close(a, b)


def test_large_update_routes_through_the_kernel_and_matches(monkeypatch,
                                                            fitted):
    """>= 512 fresh entries route through ``assign_many(use_kernel=True)``."""
    interpret_reference_kernels(monkeypatch)
    a, b = _copies(fitted)
    new_a, new_b = _history(jn, 2, 300, 11), _history(pn, 2, 300, 11)
    assert len(new_b) >= 512
    F = np.stack([e.features() for e in new_b])
    np.testing.assert_array_equal(
        b.cluster_model.assign_many(F, use_kernel=True, device="cpu"),
        b.cluster_model.assign_many(F))
    ta = a.update(new_a, batched_fit=True, use_pallas=True)
    tb = b.update(new_b, batched_fit=True, use_kernel=True)
    assert ta == tb
    _assert_refit_close(a, b)


# ------------------------------------------------------------------ #
# multi-network knowledge and the cold start
# ------------------------------------------------------------------ #
def test_multinetwork_cold_start_matches_reference():
    hist_a = jn.generate_multi_network_history(days=1.0, transfers_per_day=60,
                                               seed=1)
    hist_b = pn.generate_multi_network_history(days=1.0, transfers_per_day=60,
                                               seed=1)
    ma = joff.MultiNetworkDB().fit(hist_a)
    mb = poff.MultiNetworkDB(device="cpu").fit(hist_b)
    assert ma.networks() == mb.networks()
    for pair in ma.networks():
        assert plain(_state(ma.get(*pair))) == plain(_state(mb.get(*pair)))
    feats = np.stack([e.features() for e in hist_b[:40]])
    feats[:, 0] += 0.3  # a faster link than any known network
    assert ma.rank_networks(feats) == mb.rank_networks(feats)
    ca = ma.bootstrap("new/a", "new/b", feats)
    cb = mb.bootstrap("new/a", "new/b", feats)
    assert cb.origin == ca.origin and cb.device == mb.get(*ma.networks()[0]).device
    assert plain(_state(ca)) == plain(_state(cb))
    qa = ma.query("other/a", "other/b", feats[:1])
    qb = mb.query("other/a", "other/b", feats[:1])
    np.testing.assert_array_equal(qa.centroid, qb.centroid)
