"""Sparse QR / least-squares tier (`linalg/qr.py`).

Oracle: `numpy.linalg.lstsq` / `numpy.linalg.qr` on the densified
operand — the reference documents factorization intent (`csr.rs:16-17`)
but implements none, so dense LAPACK semantics are the contract.
"""

import numpy as np
import pytest

from spalinalg import CooMatrix, CsrMatrix
from spalinalg.errors import ShapeError
from spalinalg.linalg import (
    lstsq,
    qr,
    qr_q_apply,
    qr_qt_apply,
    qr_r_dense,
    qr_solve,
)


def _random_tall(rng, m, n, density=0.2):
    """Full-column-rank sparse tall matrix (diagonal reinforced)."""
    nnz = max(int(m * n * density), n)
    rows = rng.integers(0, m, size=nnz)
    cols = rng.integers(0, n, size=nnz)
    vals = rng.normal(size=nnz)
    # reinforce the leading diagonal for guaranteed full column rank
    rows = np.concatenate([rows, np.arange(n)])
    cols = np.concatenate([cols, np.arange(n)])
    vals = np.concatenate([vals, np.full(n, 3.0 + n)])
    coo = CooMatrix.with_triplets(m, n, rows.tolist(), cols.tolist(),
                                  vals.tolist())
    return CsrMatrix.from_coo(coo)


@pytest.mark.parametrize("method", ["dense", "sparse"])
def test_lstsq_matches_numpy(rng, method):
    m, n = 60, 24
    a = _random_tall(rng, m, n)
    b = rng.normal(size=m)
    fac = qr(a, method=method)
    x = np.asarray(qr_solve(fac, b))
    ref = np.linalg.lstsq(np.asarray(a.to_dense()), b, rcond=None)[0]
    np.testing.assert_allclose(x, ref, atol=1e-6)


def test_lstsq_oneshot(rng):
    a = _random_tall(rng, 40, 10)
    b = rng.normal(size=40)
    ref = np.linalg.lstsq(np.asarray(a.to_dense()), b, rcond=None)[0]
    np.testing.assert_allclose(np.asarray(lstsq(a, b)), ref, atol=1e-6)


def test_square_system_exact(rng):
    """m == n nonsingular: least squares degenerates to the exact solve."""
    n = 16
    a = _random_tall(rng, n, n)
    x_true = rng.normal(size=n)
    b = np.asarray(a.to_dense()) @ x_true
    x = np.asarray(qr_solve(qr(a, method="sparse"), b))
    np.testing.assert_allclose(x, x_true, atol=1e-6)


@pytest.mark.parametrize("method", ["dense", "sparse"])
def test_r_factor_matches_numpy(rng, method):
    a = _random_tall(rng, 30, 12)
    r = np.asarray(qr_r_dense(qr(a, method=method)))
    ref = np.linalg.qr(np.asarray(a.to_dense()))[1]
    # R unique up to row signs
    np.testing.assert_allclose(np.abs(r), np.abs(ref), atol=1e-6)
    assert np.allclose(r, np.triu(r))


@pytest.mark.parametrize("method", ["dense", "sparse"])
def test_q_apply_roundtrip(rng, method):
    """Qᵀ(Qy) == y and Q(Qᵀ(Ax)) == Ax (range projection)."""
    a = _random_tall(rng, 30, 12)
    fac = qr(a, method=method)
    y = rng.normal(size=12)
    np.testing.assert_allclose(
        np.asarray(qr_qt_apply(fac, qr_q_apply(fac, y))), y, atol=1e-6)
    ax = np.asarray(a.to_dense()) @ rng.normal(size=12)
    np.testing.assert_allclose(
        np.asarray(qr_q_apply(fac, qr_qt_apply(fac, ax))), ax, atol=1e-6)


def test_multiple_rhs(rng):
    a = _random_tall(rng, 40, 10)
    B = rng.normal(size=(40, 3))
    fac = qr(a, method="sparse")
    X = np.asarray(qr_solve(fac, B))
    ref = np.linalg.lstsq(np.asarray(a.to_dense()), B, rcond=None)[0]
    np.testing.assert_allclose(X, ref, atol=1e-6)


def test_underdetermined_raises(rng):
    a = _random_tall(rng, 10, 10)
    wide = CsrMatrix.from_coo(CooMatrix.with_entries(
        2, 5, [(0, 0, 1.0), (1, 4, 2.0)]))
    with pytest.raises(ShapeError):
        qr(wide)


def test_bad_method_raises(rng):
    a = _random_tall(rng, 10, 4)
    with pytest.raises(ValueError):
        qr(a, method="givens")


def test_refinement_improves_ill_conditioned(rng):
    """The corrected seminormal step must beat the raw normal equations."""
    m, n = 50, 12
    a_np = rng.normal(size=(m, n))
    a_np[:, 0] *= 1e4          # condition number ~1e4 → κ² ~1e8 for AᵀA
    rows, cols = np.nonzero(a_np)
    coo = CooMatrix.with_triplets(m, n, rows.tolist(), cols.tolist(),
                                  a_np[rows, cols].tolist())
    a = CsrMatrix.from_coo(coo)
    b = rng.normal(size=m)
    fac = qr(a, method="sparse")
    ref = np.linalg.lstsq(a_np, b, rcond=None)[0]
    err0 = np.linalg.norm(np.asarray(qr_solve(fac, b, refine=0)) - ref)
    err1 = np.linalg.norm(np.asarray(qr_solve(fac, b, refine=1)) - ref)
    assert err1 <= err0 * 1.01
    np.testing.assert_allclose(
        np.asarray(qr_solve(fac, b, refine=2)), ref,
        atol=1e-6 * np.linalg.norm(ref))
