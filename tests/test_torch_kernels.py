"""The port's kernels against the JAX package's: the plain-torch twins
against ``repro.kernels.ref`` and the Pallas kernels (interpret mode) on the
CPU, and the hand-written CUDA kernels against their twins on the card.

Tolerances: float32 throughout, rtol 1e-5, with an absolute floor at 1e-5 of
the data scale for values that are differences of larger f32 terms (the
expanded squared distance near a centroid, the spline's b and d
coefficients).  Labels are compared exactly, except at near-ties: points
whose best and second-best squared distances lie within 1e-4 (|x|^2 + |c|^2)
of each other, where f32 rounding in either package may pick either.
``transfer_select`` is a gather and a max with no arithmetic, so its twin
equals the JAX oracle exactly, NaN and out-of-range indices included, and
the CUDA kernel equals its twin bit for bit; against the Pallas one-hot
matmul the JAX package's own tolerance holds (rtol 1e-5, atol 1e-5, argk
exact) on finite, in-range inputs, the only ones that kernel takes.

The JAX package is imported inside a fixture, so that the card tests also
run on a machine that has the port but no jax:
``python -m pytest -q -m cuda tests/test_torch_kernels.py``.
"""
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch.kernels import ops, ref

RTOL = 1e-5


@pytest.fixture(scope="module")
def jax_pkg():
    """The JAX package's oracles and Pallas kernels."""
    pytest.importorskip("jax")
    from repro.core.spline import nat_spline_coeffs
    from repro.kernels import ref as jref
    from repro.kernels.cluster_assign import cluster_assign_pallas
    from repro.kernels.spline_fit import nat_spline_fit_pallas
    from repro.kernels.transfer_select import batched_predict_argmax_pallas
    return SimpleNamespace(ref=jref, cluster_assign_pallas=cluster_assign_pallas,
                           nat_spline_fit_pallas=nat_spline_fit_pallas,
                           nat_spline_coeffs=nat_spline_coeffs,
                           select_pallas=batched_predict_argmax_pallas)


@pytest.fixture
def cuda():
    """The card; skips where there is none (decided at run time)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _assign_inputs(n, m, seed, d=4):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d)).astype(np.float32) * 2.0
    C = rng.normal(size=(m, d)).astype(np.float32) * 2.0
    return X, C


def _clear(X, C):
    """Points whose nearest centroid is clear of f32 rounding."""
    X64, C64 = X.astype(np.float64), C.astype(np.float64)
    d2 = ((X64[:, None, :] - C64[None]) ** 2).sum(-1)
    scale = (X64 ** 2).sum(1) + (C64 ** 2).sum(1).max()
    if d2.shape[1] < 2:                 # one centroid: nothing to tie with
        return np.ones(len(X), bool), scale
    two = np.sort(d2, axis=1)[:, :2]
    return (two[:, 1] - two[:, 0]) > 1e-4 * scale, scale


def _check_assign(lab, d2, lab_ref, d2_ref, X, C):
    clear, scale = _clear(X, C)
    assert clear.mean() > 0.95
    np.testing.assert_array_equal(np.asarray(lab)[clear],
                                  np.asarray(lab_ref)[clear])
    err = np.abs(np.asarray(d2, np.float64) - np.asarray(d2_ref, np.float64))
    assert (err <= RTOL * np.abs(np.asarray(d2_ref)) + RTOL * scale).all()


# ------------------------------------------------------------------ #
# cluster_assign
# ------------------------------------------------------------------ #
ASSIGN_CASES = [(1000, 2, 0), (1000, 12, 1), (2500, 12, 2), (3001, 2, 3)]


@pytest.mark.parametrize("n,m,seed", ASSIGN_CASES)
def test_cluster_assign_twin_matches_jax_oracle(jax_pkg, n, m, seed):
    X, C = _assign_inputs(n, m, seed)
    lab, d2 = ref.cluster_assign_ref(torch.from_numpy(X), torch.from_numpy(C))
    assert lab.dtype == torch.int32 and d2.dtype == torch.float32
    lab_j, d2_j = jax_pkg.ref.cluster_assign_ref(X, C)
    _check_assign(lab.numpy(), d2.numpy(), lab_j, d2_j, X, C)


@pytest.mark.parametrize("n,m,seed", ASSIGN_CASES[1:3])
def test_cluster_assign_twin_matches_pallas_interpret(jax_pkg, n, m, seed):
    X, C = _assign_inputs(n, m, seed)
    lab, d2 = ref.cluster_assign_ref(torch.from_numpy(X), torch.from_numpy(C))
    lab_p, d2_p = jax_pkg.cluster_assign_pallas(X, C, interpret=True)
    _check_assign(lab.numpy(), d2.numpy(), lab_p, d2_p, X, C)


def test_cluster_assign_planted_ties_take_the_first_index(jax_pkg):
    X, C = _assign_inputs(1000, 6, 4)
    C[3] = C[1]          # duplicate centroids: every tie must go to 1
    C[5] = C[1]
    lab, _ = ref.cluster_assign_ref(torch.from_numpy(X), torch.from_numpy(C))
    lab_j, _ = jax_pkg.ref.cluster_assign_ref(X, C)
    assert (lab.numpy() == 1).any()
    assert not np.isin(lab.numpy(), [3, 5]).any()
    np.testing.assert_array_equal(lab.numpy() == 1, np.asarray(lab_j) == 1)


# ------------------------------------------------------------------ #
# nat_spline_fit
# ------------------------------------------------------------------ #
def _spline_inputs(n, R, seed):
    rng = np.random.default_rng(seed)
    x = np.cumsum(rng.uniform(0.5, 4.0, n)).astype(np.float32)
    Y = rng.uniform(50.0, 5000.0, (R, n)).astype(np.float32)
    return x, Y


def _check_coeffs(got, want, Y):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    err = np.abs(got - want)
    assert (err <= RTOL * np.abs(want) + RTOL * np.abs(Y).max()).all(), err.max()


@pytest.mark.parametrize("R", [1, 64, 300])
@pytest.mark.parametrize("n", range(1, 17))
def test_nat_spline_fit_twin_matches_jax_oracle(jax_pkg, n, R):
    x, Y = _spline_inputs(n, R, seed=100 + n)
    got = ref.nat_spline_fit_ref(torch.from_numpy(x), torch.from_numpy(Y))
    assert got.dtype == torch.float32
    _check_coeffs(got.numpy(), jax_pkg.ref.nat_spline_fit_ref(x, Y), Y)


@pytest.mark.parametrize("n,R", [(3, 64), (9, 300), (16, 1), (16, 300)])
def test_nat_spline_fit_twin_matches_pallas_interpret(jax_pkg, n, R):
    x, Y = _spline_inputs(n, R, seed=200 + n)
    got = ref.nat_spline_fit_ref(torch.from_numpy(x), torch.from_numpy(Y))
    _check_coeffs(got.numpy(),
                  jax_pkg.nat_spline_fit_pallas(x, Y, interpret=True), Y)


def test_nat_spline_fit_twin_takes_its_dtype_from_the_input(jax_pkg):
    x, Y = _spline_inputs(9, 8, seed=3)
    got = ref.nat_spline_fit_ref(torch.from_numpy(x),
                                 torch.from_numpy(Y.astype(np.float64)))
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), jax_pkg.nat_spline_coeffs(x, Y),
                               rtol=1e-9, atol=1e-9 * np.abs(Y).max())


# ------------------------------------------------------------------ #
# transfer_select
# ------------------------------------------------------------------ #
# (S, G, B, P): the JAX package's SELECT_CASES, the degenerate B = P = S = 1,
# and the fleet path's full lattice G = 16^3 at its admission shape (B = 1,
# P = S = 5) and at the batched scoring shape (B = 64, P = 16)
SELECT_CASES = [(3, 64, 17, 4), (5, 256, 32, 16), (2, 128, 7, 5),
                (1, 1, 1, 1), (1, 4096, 1, 1), (5, 4096, 1, 5),
                (5, 4096, 64, 16)]


def _select_inputs(S, G, B, P, seed):
    rng = np.random.default_rng(seed)
    values = rng.normal(size=(S, G)).astype(np.float32) * 5.0
    idx = rng.integers(0, G, size=(B, P)).astype(np.int32)
    return values, idx


def _select_twin(values, idx, device="cpu"):
    best, argk = ref.batched_predict_argmax_ref(
        torch.from_numpy(values).to(device), torch.from_numpy(idx).to(device))
    assert best.dtype == torch.float32 and argk.dtype == torch.int32
    return best.cpu().numpy(), argk.cpu().numpy()


def _assert_exact(got, want):
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


@pytest.mark.parametrize("S,G,B,P", SELECT_CASES)
def test_transfer_select_twin_equals_jax_oracle(jax_pkg, S, G, B, P):
    values, idx = _select_inputs(S, G, B, P, seed=S * G + B * P)
    _assert_exact(_select_twin(values, idx),
                  jax_pkg.ref.batched_predict_argmax_ref(values, idx))


@pytest.mark.parametrize("S,G,B,P", SELECT_CASES)
def test_transfer_select_twin_matches_pallas_interpret(jax_pkg, S, G, B, P):
    values, idx = _select_inputs(S, G, B, P, seed=7 + S * G + B * P)
    best, argk = _select_twin(values, idx)
    best_p, argk_p = jax_pkg.select_pallas(values, idx, interpret=True)
    np.testing.assert_allclose(best, np.asarray(best_p), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(argk, np.asarray(argk_p))


def _tied_inputs():
    """Ties across candidates: repeated indices, and distinct lattice points
    that hold the same value."""
    values, idx = _select_inputs(4, 512, 24, 9, seed=11)
    values[:, 100:110] = 3.0 * values.max()    # ten equal maxima per row
    idx[:, 2] = 105
    idx[:, 5] = 101
    idx[:, 7] = 105
    idx[::3, 0] = 108                          # a tie at the first candidate
    return values, idx


def test_transfer_select_ties_take_the_first_candidate(jax_pkg):
    values, idx = _tied_inputs()
    best, argk = _select_twin(values, idx)
    want = np.where(np.arange(24)[:, None] % 3 == 0, 0, 2)
    np.testing.assert_array_equal(argk, np.broadcast_to(want, argk.shape))
    _assert_exact((best, argk),
                  jax_pkg.ref.batched_predict_argmax_ref(values, idx))
    best_p, argk_p = jax_pkg.select_pallas(values, idx, interpret=True)
    np.testing.assert_allclose(best, np.asarray(best_p), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(argk, np.asarray(argk_p))


def _odd_inputs():
    """NaN values, and indices in [-G, 0) and outside [-G, G), beside
    ordinary rows."""
    values, idx = _select_inputs(3, 64, 8, 6, seed=12)
    values[1, 10] = np.nan
    values[2, 20] = np.nan
    idx[0] = [10, 11, 20, 12, 13, 10]          # NaN in some rows only
    idx[1] = [-1, -64, 5, 6, 7, 8]             # counts from the end
    idx[2] = [0, 64, 1, 2, 3, 4]               # reads NaN at p = 1
    idx[3] = [-65, -2**31, 2**31 - 1, 100, 64, 65]  # every one out of range
    idx[4] = [3, 3, 3, 3, 3, 3]
    idx[5, 0] = 20                             # NaN first in row 2
    return values, idx


def test_transfer_select_nan_and_out_of_range_follow_jnp(jax_pkg):
    values, idx = _odd_inputs()
    best, argk = _select_twin(values, idx)
    _assert_exact((best, argk),
                  jax_pkg.ref.batched_predict_argmax_ref(values, idx))
    assert np.isnan(best[0, 1:]).all() and (argk[0, 1:] == [0, 2]).all()
    assert np.isnan(best[2]).all() and (argk[2] == 1).all()
    assert np.isnan(best[3]).all() and (argk[3] == 0).all()
    assert (best[1] == values[:, [63, 0, 5, 6, 7, 8]].max(1)).all()


def test_transfer_select_routes_by_device_and_refuses_no_candidates():
    values, idx = _select_inputs(3, 64, 5, 4, seed=13)
    v, i = torch.from_numpy(values), torch.from_numpy(idx)
    _assert_exact(ops.transfer_predict_argmax(v, i),
                  ref.batched_predict_argmax_ref(v, i))
    with pytest.raises(ValueError, match="P >= 1"):
        ops.transfer_predict_argmax(v, i[:, :0])


# ------------------------------------------------------------------ #
# the CUDA kernels on the card
# ------------------------------------------------------------------ #
@pytest.mark.cuda
@pytest.mark.parametrize("n,m,seed", ASSIGN_CASES + [(1, 1, 5), (70001, 64, 6)])
def test_cluster_assign_kernel_matches_twin_on_card(cuda, n, m, seed):
    X, C = _assign_inputs(n, m, seed)
    Xt, Ct = torch.from_numpy(X).to(cuda), torch.from_numpy(C).to(cuda)
    lab, d2 = ops.cluster_assign(Xt, Ct)
    lab_r, d2_r = ref.cluster_assign_ref(Xt, Ct)
    torch.cuda.synchronize()
    assert lab.dtype == torch.int32 and lab.is_cuda
    _check_assign(lab.cpu().numpy(), d2.cpu().numpy(), lab_r.cpu().numpy(),
                  d2_r.cpu().numpy(), X, C)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [1, 3, 4, 8, 13, 16])
def test_cluster_assign_kernel_every_width_and_offset_on_card(cuda, d):
    X, C = _assign_inputs(5000, 12, 10 + d, d=d)
    Ct = torch.from_numpy(C).to(cuda)
    flat = torch.from_numpy(X).reshape(-1).to(cuda)
    # offset 1: a contiguous view that is not 16-byte aligned
    for lo in (0, 1):
        n = (flat.numel() - lo) // d
        Xt = flat[lo:lo + n * d].view(n, d)
        lab, d2 = ops.cluster_assign(Xt, Ct)
        lab_r, d2_r = ref.cluster_assign_ref(Xt, Ct)
        torch.cuda.synchronize()
        _check_assign(lab.cpu().numpy(), d2.cpu().numpy(),
                      lab_r.cpu().numpy(), d2_r.cpu().numpy(),
                      Xt.cpu().numpy(), C)


@pytest.mark.cuda
def test_cluster_assign_kernel_ties_and_limits_on_card(cuda):
    X, C = _assign_inputs(4000, 6, 7, d=16)
    C[3] = C[1]
    lab, _ = ops.cluster_assign(torch.from_numpy(X).to(cuda),
                                torch.from_numpy(C).to(cuda))
    assert (lab.cpu().numpy() == 1).any()
    assert not (lab.cpu().numpy() == 3).any()
    with pytest.raises(ValueError):
        ops.cluster_assign(torch.zeros((8, 4), device=cuda),
                           torch.zeros((65, 4), device=cuda))
    with pytest.raises(TypeError):
        ops.cluster_assign(torch.zeros((8, 4), device=cuda, dtype=torch.float64),
                           torch.zeros((3, 4), device=cuda, dtype=torch.float64))


@pytest.mark.cuda
@pytest.mark.parametrize("R", [1, 64, 300, 4097])
@pytest.mark.parametrize("n", range(1, 17))
def test_nat_spline_fit_kernel_matches_twin_on_card(cuda, n, R):
    x, Y = _spline_inputs(n, R, seed=300 + n)
    xt, Yt = torch.from_numpy(x).to(cuda), torch.from_numpy(Y).to(cuda)
    got = ops.nat_spline_fit(xt, Yt)
    want = ref.nat_spline_fit_ref(xt, Yt)
    torch.cuda.synchronize()
    _check_coeffs(got.cpu().numpy(), want.cpu().numpy(), Y)
    with pytest.raises(ValueError):
        ops.nat_spline_fit(torch.zeros(17, device=cuda),
                           torch.zeros((2, 17), device=cuda))


@pytest.mark.cuda
@pytest.mark.parametrize("S,G,B,P", SELECT_CASES + [(5, 4096, 4099, 16)])
def test_transfer_select_kernel_equals_twin_on_card(cuda, S, G, B, P):
    values, idx = _select_inputs(S, G, B, P, seed=21 + S + B)
    vt, it = torch.from_numpy(values).to(cuda), torch.from_numpy(idx).to(cuda)
    best, argk = ops.transfer_predict_argmax(vt, it)
    torch.cuda.synchronize()
    assert best.is_cuda and best.dtype == torch.float32
    assert argk.is_cuda and argk.dtype == torch.int32
    _assert_exact((best.cpu(), argk.cpu()), _select_twin(values, idx, cuda))


@pytest.mark.cuda
def test_transfer_select_kernel_ties_nan_and_range_on_card(cuda):
    for values, idx in (_tied_inputs(), _odd_inputs()):
        got = ops.transfer_predict_argmax(torch.from_numpy(values).to(cuda),
                                          torch.from_numpy(idx).to(cuda))
        torch.cuda.synchronize()
        _assert_exact([t.cpu() for t in got], _select_twin(values, idx))


@pytest.mark.cuda
def test_transfer_select_kernel_refuses_what_it_does_not_take(cuda):
    from repro_torch.kernels.transfer_select import batched_predict_argmax_cuda
    v = torch.zeros((3, 64), device=cuda)
    i = torch.zeros((4, 5), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="P >= 1"):
        batched_predict_argmax_cuda(v, i[:, :0])
    with pytest.raises(TypeError):
        batched_predict_argmax_cuda(v.double(), i)
    with pytest.raises(TypeError):
        batched_predict_argmax_cuda(v, i.long())
    with pytest.raises(ValueError, match="contiguous"):
        batched_predict_argmax_cuda(torch.zeros((64, 3), device=cuda).T, i)
    with pytest.raises(ValueError, match="CUDA"):
        batched_predict_argmax_cuda(v, i.cpu())
    with pytest.raises(ValueError, match="2\\*\\*31"):
        batched_predict_argmax_cuda(torch.zeros((1, 1), device=cuda)
                                    .expand(2, 2 ** 30), i)
