"""The port's torch spline classes (``CubicSpline1D``, ``_fit_many``,
``_eval_packed``, ``BicubicSpline``) against the JAX package's, on the same
inputs, and against scipy's natural spline.

Each case runs in float64 (JAX with ``jax_enable_x64``, the port on float64
arrays) and in float32 (both packages' defaults).  Tolerance: 1e-12 in
float64 and 1e-5 in float32, relative to the largest |value| compared (both
packages solve the same (N, N) system; LAPACK and XLA order the
elimination's sums differently).  The conftest restores
``jax_enable_x64`` after every test.

``tests/test_spline.py::test_cubic1d_single_knot_fit_is_traceable`` checks
that the reference's single-knot fit traces under ``jax.vmap``; the port's
classes run eagerly and nothing traces them, so it has no counterpart here.
Its hypothesis properties (node interpolation, C2 continuity) run here over
fixed seeds.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.interpolate import CubicSpline as SciSpline

from repro.core import spline as js
from repro_torch.core import spline as ps

RTOL = {"float64": 1e-12, "float32": 1e-5}
DTYPES = list(RTOL)


@pytest.fixture(params=DTYPES)
def dtype(request):
    """The precision of both packages for one case (JAX's by its config)."""
    jax.config.update("jax_enable_x64", request.param == "float64")
    return request.param


def _close(got, want, dtype):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=0, atol=RTOL[dtype] * scale)


def _fit_both(x, y, dtype):
    x, y = np.asarray(x, dtype), np.asarray(y, dtype)
    return js.CubicSpline1D.fit(x, y), ps.CubicSpline1D.fit(x, y,
                                                            device="cpu")


def test_cubic1d_matches_scipy_natural_and_the_reference(dtype):
    x = np.array([1.0, 2.0, 4.0, 8.0, 16.0])
    y = np.array([3.0, 5.0, 4.0, 9.0, 2.0])
    ref, port = _fit_both(x, y, dtype)
    assert port.coeffs.dtype == getattr(torch, dtype)
    xq = np.linspace(1, 16, 64).astype(dtype)
    got = np.array([float(port(q)) for q in xq])
    np.testing.assert_allclose(got, SciSpline(x, y, bc_type="natural")(xq),
                               rtol=1e-4, atol=1e-4)
    _close(got, ref(jnp.asarray(xq)), dtype)
    _close(port.coeffs.numpy(), ref.coeffs, dtype)
    # a batch of query points at once is the same as one at a time
    _close(port(torch.from_numpy(xq)).numpy(), got, dtype)


@pytest.mark.parametrize("seed", range(4))
def test_cubic1d_interpolates_nodes(seed, dtype):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(3, 9))
    x = np.sort(rng.choice(np.arange(1, 33), size=n, replace=False)).astype(float)
    y = rng.normal(size=n) * 10
    ref, port = _fit_both(x, y, dtype)
    got = port(torch.from_numpy(x.astype(dtype))).numpy()
    _close(got, y.astype(dtype), dtype)
    _close(got, ref(jnp.asarray(x.astype(dtype))), dtype)


@pytest.mark.parametrize("seed", range(4))
def test_cubic1d_c2_continuity(seed, dtype):
    """First and second derivatives match across interior knots, and the
    coefficients are the reference's."""
    rng = np.random.default_rng(100 + seed)
    n = int(rng.integers(4, 8))
    x = np.sort(rng.choice(np.arange(1, 25), size=n, replace=False)).astype(float)
    y = rng.normal(size=n) * 5
    ref, port = _fit_both(x, y, dtype)
    c = port.coeffs.numpy().astype(np.float64)
    tol = 1e-6 if dtype == "float64" else 1e-3
    for i in range(1, n - 1):
        h = x[i] - x[i - 1]
        a, b_, cc, d = c[i - 1]
        np.testing.assert_allclose(b_ + 2 * cc * h + 3 * d * h * h, c[i, 1],
                                   rtol=tol, atol=tol)
        np.testing.assert_allclose(2 * cc + 6 * d * h, 2 * c[i, 2],
                                   rtol=tol, atol=tol)
    _close(c, ref.coeffs, dtype)


def test_cubic1d_degenerate_knot_counts(dtype):
    """n == 1: the constant y_0; n == 2: the straight line; each as one
    (1, 4) coefficient row, the reference's."""
    one_ref, one = _fit_both([4.0], [7.0], dtype)
    assert one.coeffs.shape == (1, 4)
    np.testing.assert_array_equal(one.coeffs.numpy(), np.asarray(one_ref.coeffs))
    for q in (0.0, 4.0, 11.0):
        assert abs(float(one(q)) - 7.0) < 1e-6
    two_ref, two = _fit_both([2.0, 6.0], [1.0, 9.0], dtype)
    assert two.coeffs.shape == (1, 4)
    np.testing.assert_array_equal(two.coeffs.numpy(), np.asarray(two_ref.coeffs))
    for q, want in ((2.0, 1.0), (4.0, 5.0), (6.0, 9.0)):
        assert abs(float(two(q)) - want) < 1e-6


@pytest.mark.parametrize("n", [1, 2, 3, 6])
def test_fit_many_and_eval_packed_match_the_reference(n, dtype):
    rng = np.random.default_rng(n)
    x = np.cumsum(rng.uniform(0.5, 3.0, n)).astype(dtype)
    ys = rng.normal(size=(5, n)).astype(dtype)
    _, want = js._fit_many(jnp.asarray(x), jnp.asarray(ys))
    xt, got = ps._fit_many(torch.from_numpy(x), torch.from_numpy(ys))
    assert got.shape == (5, max(n - 1, 1), 4)
    _close(got.numpy(), want, dtype)
    for q in np.linspace(x[0] - 1.0, x[-1] + 1.0, 7).astype(dtype):
        _close(ps._eval_packed(xt, got, torch.tensor(q)).numpy(),
               js._eval_packed(jnp.asarray(x), want, q), dtype)


@pytest.mark.parametrize("shape", [(4, 3), (1, 3), (2, 3), (4, 1)])
def test_bicubic_hits_grid_nodes_and_matches_the_reference(shape, dtype):
    rng = np.random.default_rng(1)
    gx = np.array([1.0, 2.0, 4.0, 8.0])[:shape[0]].astype(dtype)
    gy = np.array([1.0, 3.0, 6.0])[:shape[1]].astype(dtype)
    z = rng.normal(size=shape).astype(dtype)
    ref = js.BicubicSpline.fit(gx, gy, z)
    port = ps.BicubicSpline.fit(gx, gy, z, device="cpu")
    _close(port.row_coeffs.numpy(), ref.row_coeffs, dtype)
    for i in range(shape[0]):
        for j in range(shape[1]):
            assert abs(float(port(gx[i], gy[j])) - z[i, j]) < 1e-5
    pts = [(a, b) for a in np.linspace(0.5, 9.0, 3) for b in np.linspace(0.5, 7.0, 3)]
    _close([float(port(a, b)) for a, b in pts],
           [float(ref(np.asarray(a, dtype), np.asarray(b, dtype))) for a, b in pts],
           dtype)


def test_bicubic_refuses_a_grid_of_the_wrong_shape():
    with pytest.raises(ValueError, match="knots 3 x 2"):
        ps.BicubicSpline.fit([1.0, 2.0, 3.0], [1.0, 2.0], np.zeros((2, 3)),
                             device="cpu")
