"""The port's batched surface path (``repro_torch.core.batched``) against the
JAX package's (``repro.core.batched``).

Both stacks are built from the same knowledge: the reference's ``OfflineDB``
is carried into the port through ``offline_db_to_state`` /
``offline_db_from_state(device="cpu")``.  The lattice is the same float64
``dense_eval`` cast to float32 in both packages, and every op on it is a
gather, a comparison or an elementwise op in float32, so every output is
compared exactly.
"""
import copy

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jcore
import repro.core.batched as jb
import repro.netsim as jn
import repro_torch.core.batched as pb
from repro.kernels.ops import transfer_predict_argmax
from repro_torch.core.state import offline_db_from_state, offline_db_to_state
from repro_torch.netsim import LogEntry, ParamBounds


@pytest.fixture(scope="module")
def dbs():
    env = jn.make_testbed("xsede", seed=3)
    hist = jn.generate_history(env, days=4, transfers_per_day=120, seed=0)
    ref = jcore.TransferTuner(jcore.TunerConfig(seed=0)).fit(hist).db
    return ref, offline_db_to_state(ref)


@pytest.fixture(scope="module")
def stacks(dbs):
    ref, state = dbs
    port = offline_db_from_state(state, device="cpu")
    k = 1
    return (ref.clusters[k].surface_stack(ref.bounds),
            port.clusters[k].surface_stack(port.bounds))


def _int_points(rng, *shape, bounds=ParamBounds()):
    return np.stack([rng.integers(1, bounds.max_cc + 1, shape),
                     rng.integers(1, bounds.max_p + 1, shape),
                     rng.integers(1, bounds.max_pp + 1, shape)], axis=-1)


def _eq(got, want):
    got = got.cpu().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_stack_is_bit_equal_to_the_reference(stacks):
    a, b = stacks
    assert b.device == torch.device("cpu")
    assert b.values.dtype == torch.float32
    for name in ("values", "sigma", "load", "argmax_pts", "max_throughput"):
        _eq(getattr(b, name), getattr(a, name))
    assert b.values.shape[1:] == (16, 16, 16)
    assert (np.diff(b.load.numpy()) >= 0).all()
    assert b.n_surfaces == a.n_surfaces


def test_flat_index_and_predict_are_equal(stacks):
    a, b = stacks
    rng = np.random.default_rng(0)
    for shape in ((128,), (6, 7), (1,)):
        pts = _int_points(rng, *shape)
        _eq(b.flat_index(pts), a.flat_index(pts))
        _eq(b.predict(pts), a.predict(pts))
    _eq(b.predict(a.argmax_pts), a.predict(a.argmax_pts))


@pytest.mark.parametrize("B,P", [(1, 5), (16, 12), (5, 7), (64, 16)])
def test_candidates_and_best_candidates_are_equal(stacks, B, P):
    a, b = stacks
    pts = _int_points(np.random.default_rng(B * P), B, P)
    _eq(b.predict_candidates(pts), a.predict_candidates(pts))
    want = a.best_candidates(pts)
    for use_kernel in (None, False, True):
        got = b.best_candidates(pts, use_kernel=use_kernel)
        _eq(got[0], want[0])
        _eq(got[1], want[1])
    # the reference's Pallas kernel agrees too (it is an f32 matmul with a
    # one-hot operand, held to its own rtol 1e-6, atol 1e-5)
    best_p, argk_p = transfer_predict_argmax(a.flat_values, a.flat_index(pts),
                                             use_pallas=True, interpret=True)
    got = b.best_candidates(pts)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(best_p),
                               rtol=1e-6, atol=1e-5)
    _eq(got[1], argk_p)


def test_best_candidates_of_the_admission_path(stacks):
    """``predict_demands`` scores each cluster's own argmax points."""
    a, b = stacks
    cand = a.argmax_pts[None, :, :]
    got, want = b.best_candidates(cand), a.best_candidates(cand)
    _eq(got[0], want[0])
    _eq(got[1], want[1])


def _probes(stack, rng, n):
    pts = _int_points(rng, n)
    preds = np.array(stack.predict(pts))       # a writable copy
    return pts, preds


@pytest.mark.parametrize("direction", [-1, 0, 1])
def test_closest_surface_index_is_equal(stacks, direction):
    a, _ = stacks
    rng = np.random.default_rng(10 + direction)
    _, preds = _probes(a, rng, 64)
    achieved = (preds[:, 0] * rng.uniform(0.5, 1.5, len(preds))
                ).astype(np.float32)
    preds[:3, 2] = preds[:3, 1]            # ties between surfaces
    dirs = np.full(len(preds), direction, np.int32)
    dirs[::5] = -direction                 # mixed directions in one batch
    want = jb.closest_surface_index(jnp.asarray(preds), jnp.asarray(achieved),
                                    jnp.asarray(dirs))
    got = pb.closest_surface_index(torch.from_numpy(preds),
                                   torch.from_numpy(achieved),
                                   torch.from_numpy(dirs))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("direction", [-1, 1])
def test_closest_surface_index_empty_filter_fallback(stacks, direction):
    """A direction filter that empties the candidate set falls back to all
    surfaces, in both packages alike."""
    a, _ = stacks
    _, preds = _probes(a, np.random.default_rng(20 + direction), 16)
    achieved = (preds.min(axis=1) - 50.0 if direction < 0
                else preds.max(axis=1) + 50.0).astype(np.float32)
    dirs = np.full(len(preds), direction, np.int32)
    want = jb.closest_surface_index(jnp.asarray(preds), jnp.asarray(achieved),
                                    jnp.asarray(dirs))
    got = pb.closest_surface_index(torch.from_numpy(preds),
                                   torch.from_numpy(achieved),
                                   torch.from_numpy(dirs))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_within_band_is_equal(stacks):
    a, b = stacks
    rng = np.random.default_rng(30)
    pts, preds = _probes(a, rng, 32)
    achieved = (preds[:, 0] * rng.uniform(0.7, 1.3, len(pts))
                ).astype(np.float32)
    for z in (1.0, 2.0):
        want = jb.within_band(a.predict(pts), a.sigma, jnp.asarray(achieved), z)
        got = pb.within_band(b.predict(pts), b.sigma,
                             torch.from_numpy(achieved), z)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_surface_stack_is_cached_per_bounds_on_the_db_device(dbs):
    port = offline_db_from_state(dbs[1], device="cpu")
    ck = port.clusters[0]
    first = ck.surface_stack(port.bounds)
    assert first.device == torch.device("cpu")
    assert ck.surface_stack(port.bounds) is first
    other = ParamBounds(max_cc=8, max_p=8, max_pp=8)
    assert ck.surface_stack(other).values.shape[1:] == (8, 8, 8)
    assert ck.surface_stack(port.bounds) is not first


def test_surface_stack_survives_an_update(dbs):
    """``OfflineDB.update`` rebuilds a cached stack for the refit cluster on
    the DB's device, as the reference rebuilds its own."""
    ref = copy.deepcopy(dbs[0])
    port = offline_db_from_state(dbs[1], device="cpu")
    for db in (ref, port):
        for ck in db.clusters:
            ck.surface_stack(db.bounds)
    env = jn.make_testbed("xsede", seed=9)
    fresh = jn.generate_history(env, days=1, transfers_per_day=40, seed=5)
    rows = [LogEntry(*e.__dict__.values()) for e in fresh]
    touched_ref = ref.update(fresh)
    touched = port.update(rows)
    assert touched == touched_ref and touched
    for k in sorted(touched):
        a = ref.clusters[k]._stack[1]
        b = port.clusters[k]._stack[1]
        assert b.device == torch.device("cpu")
        for name in ("values", "sigma", "load", "argmax_pts"):
            _eq(getattr(b, name), getattr(a, name))
        assert port.clusters[k].device == torch.device("cpu")
