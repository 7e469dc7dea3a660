"""spsolve/factorized front door (`linalg/solve.py`)."""

import numpy as np
import pytest

from spalinalg import CooMatrix, CsrMatrix
from spalinalg.errors import ShapeError
from spalinalg.linalg import factorized, is_symmetric, spsolve


def _spd(rng, n):
    B = rng.normal(size=(n, n)) * 0.3
    d = B @ B.T + np.eye(n) * 3.0
    rows, cols = np.nonzero(d)
    return CsrMatrix.from_coo(CooMatrix.with_triplets(
        n, n, rows.tolist(), cols.tolist(), d[rows, cols].tolist())), d


def _gen(rng, n):
    d = np.where(rng.random((n, n)) < 0.2, rng.normal(size=(n, n)), 0)
    d += np.eye(n) * 4.0
    rows, cols = np.nonzero(d)
    return CsrMatrix.from_coo(CooMatrix.with_triplets(
        n, n, rows.tolist(), cols.tolist(), d[rows, cols].tolist())), d


def test_is_symmetric(rng):
    a, _ = _spd(rng, 12)
    assert is_symmetric(a)
    g, dg = _gen(rng, 12)
    assert is_symmetric(g) == bool(np.allclose(dg, dg.T))


@pytest.mark.parametrize("maker,assume", [("spd", "auto"), ("spd", "pos"),
                                          ("gen", "auto"), ("gen", "gen")])
def test_spsolve(rng, maker, assume):
    n = 24
    A, d = (_spd if maker == "spd" else _gen)(rng, n)
    x_true = rng.normal(size=n)
    b = d @ x_true
    x = np.asarray(spsolve(A, b, assume_a=assume))
    np.testing.assert_allclose(x, x_true, atol=1e-7)


def test_symmetric_indefinite_falls_back_to_lu(rng):
    """Symmetric but NOT positive definite: auto must not return NaNs."""
    n = 16
    d = rng.normal(size=(n, n))
    d = (d + d.T) / 2        # symmetric, indefinite
    d += np.eye(n) * 0.1
    rows, cols = np.nonzero(d)
    A = CsrMatrix.from_coo(CooMatrix.with_triplets(
        n, n, rows.tolist(), cols.tolist(), d[rows, cols].tolist()))
    b = rng.normal(size=n)
    x = np.asarray(spsolve(A, b))
    np.testing.assert_allclose(d @ x, b, atol=1e-7)


def test_factorized_reuse(rng):
    A, d = _spd(rng, 20)
    solve = factorized(A)
    for _ in range(3):
        b = rng.normal(size=20)
        np.testing.assert_allclose(d @ np.asarray(solve(b)), b, atol=1e-7)


def test_validation(rng):
    wide = CsrMatrix.from_coo(CooMatrix.with_entries(
        2, 5, [(0, 0, 1.0), (1, 4, 2.0)]))
    with pytest.raises(ShapeError):
        spsolve(wide, np.ones(5))
    A, _ = _spd(rng, 4)
    with pytest.raises(ValueError):
        spsolve(A, np.ones(4), assume_a="hermitian")
