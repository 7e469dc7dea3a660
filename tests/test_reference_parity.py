"""Reference-semantics parity vs the scipy oracle (SURVEY.md §4: "numeric
oracle = reference semantics re-derived via scipy.sparse").

Randomised sweeps over the whole op surface: construction, conversion
closure, arithmetic, products, transpose — every result must agree with
scipy/dense within dtype tolerance, and structural invariants (sorted
unique indices) must hold everywhere.
"""

import numpy as np
import pytest

sps = pytest.importorskip("scipy.sparse")

from spalinalg import CooMatrix, CscMatrix, CsrMatrix
from spalinalg.io import from_scipy, to_scipy


def _rand_sps(rng, n, m, density):
    return sps.random(n, m, density=density, format="csr",
                      random_state=np.random.RandomState(rng.integers(2**31)),
                      data_rvs=lambda k: rng.normal(size=k))


@pytest.mark.parametrize("shape,density", [((40, 40), 0.1), ((23, 57), 0.2),
                                           ((64, 16), 0.05)])
def test_bridge_roundtrip(rng, shape, density):
    s = _rand_sps(rng, *shape, density)
    ours = from_scipy(s)
    back = to_scipy(ours)
    assert (back != s).nnz == 0


def test_arithmetic_parity(rng):
    for _ in range(3):
        a_s = _rand_sps(rng, 30, 30, 0.15)
        b_s = _rand_sps(rng, 30, 30, 0.15)
        a, b = from_scipy(a_s), from_scipy(b_s)
        np.testing.assert_allclose(
            np.asarray((a + b).to_dense()), (a_s + b_s).toarray(), rtol=1e-12,
            atol=1e-14,
        )
        np.testing.assert_allclose(
            np.asarray((a - b).to_dense()), (a_s - b_s).toarray(), rtol=1e-12,
            atol=1e-14,
        )
        np.testing.assert_allclose(
            np.asarray((a * b).to_dense()), (a_s @ b_s).toarray(), rtol=1e-10,
            atol=1e-12,
        )


def test_matvec_parity(rng):
    a_s = _rand_sps(rng, 50, 37, 0.1)
    a = from_scipy(a_s)
    x = rng.normal(size=37)
    np.testing.assert_allclose(np.asarray(a @ x), a_s @ x, rtol=1e-12)
    X = rng.normal(size=(37, 8))
    np.testing.assert_allclose(np.asarray(a @ X), a_s @ X, rtol=1e-12)


def test_transpose_and_conversion_closure(rng):
    a_s = _rand_sps(rng, 20, 33, 0.2)
    a = from_scipy(a_s)
    np.testing.assert_allclose(np.asarray(a.transpose().to_dense()),
                               a_s.T.toarray(), rtol=1e-14)
    csc = a.to_csc()
    np.testing.assert_allclose(np.asarray(csc.to_dense()), a_s.toarray(),
                               rtol=1e-14)
    # structural invariants after every transformation
    for mat in (a, csc, a.transpose()):
        ptr = np.asarray(mat._ptr)
        ind = np.asarray(mat._minor)
        assert ptr[0] == 0 and np.all(np.diff(ptr) >= 0)
        for r in range(ptr.size - 1):
            seg = ind[ptr[r]:ptr[r + 1]]
            assert np.all(np.diff(seg) > 0)


def test_coo_dedup_matches_scipy_sum_duplicates(rng):
    n = 15
    rows = rng.integers(0, n, 60)
    cols = rng.integers(0, n, 60)
    vals = rng.normal(size=60)
    coo = CooMatrix.with_triplets(n, n, rows, cols, vals)
    ours = CsrMatrix.from_coo(coo)
    ref = sps.coo_matrix((vals, (rows, cols)), shape=(n, n)).tocsr()
    ref.sum_duplicates()
    np.testing.assert_allclose(np.asarray(ours.to_dense()), ref.toarray(),
                               rtol=1e-12)


def test_solve_parity(rng):
    from spalinalg.linalg import cholesky, cholesky_solve

    g = sps.diags([-1, 4, -1], [-1, 0, 1], shape=(48, 48)).tocsr()
    a = from_scipy(g)
    b = rng.normal(size=48)
    x = cholesky_solve(cholesky(a), b)
    np.testing.assert_allclose(np.asarray(x),
                               np.linalg.solve(g.toarray(), b), rtol=1e-9)
