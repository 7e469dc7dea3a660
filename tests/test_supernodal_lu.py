"""General-sparsity supernodal LU.

The reference names lu as intended scope only
(/root/reference/src/csr.rs:16-17, csc.rs:16-17); this is north-star
N5's unsymmetric path: AMD + postorder on struct(A+Aᵀ), batched
multifrontal LU with restricted partial pivoting, parity vs scipy.
"""

import numpy as np
import pytest
import scipy.sparse as sps
from scipy.sparse.linalg import spsolve

import jax.numpy as jnp

from spalinalg import CsrMatrix
from spalinalg.dtypes import INDEX_DTYPE
from spalinalg.linalg.lu import lu, lu_solve


def convdiff2d(k, c=0.4):
    """2-D convection-diffusion: unsymmetric 5-point stencil."""
    T = sps.diags([-1.0 - c, 4.0, -1.0 + c], [-1, 0, 1], shape=(k, k))
    I = sps.eye(k)
    D = sps.diags([-1.0 - c, -1.0 + c], [-1, 1], shape=(k, k))
    return (sps.kron(I, T) + sps.kron(D, I)).tocsr()


def _csr(A):
    A = A.tocsr()
    A.sort_indices()
    n = A.shape[0]
    return CsrMatrix._from_parts(
        n, n,
        jnp.asarray(A.indptr, dtype=INDEX_DTYPE),
        jnp.asarray(A.indices, dtype=INDEX_DTYPE),
        jnp.asarray(A.data))


def _check(A, rng, *, method="supernodal", tol=1e-8, **kw):
    A = A.tocsr()
    A.sort_indices()
    n = A.shape[0]
    csr = _csr(A)
    b = rng.normal(size=n)
    fac = lu(csr, method=method, **kw)
    x = np.asarray(lu_solve(fac, jnp.asarray(b)))
    xref = spsolve(A.tocsc(), b)
    np.testing.assert_allclose(x, xref, rtol=tol,
                               atol=tol * np.abs(xref).max())
    return fac


class TestSupernodalLu:
    def test_convdiff2d(self, rng):
        fac = _check(convdiff2d(16), rng)
        assert fac.snlu is not None  # really the supernodal path

    def test_convdiff2d_larger(self, rng):
        _check(convdiff2d(24, c=0.7), rng)

    def test_no_densification(self):
        # a 40x40-grid operator factors with panel storage ~ fill size,
        # far below dense n^2
        A = convdiff2d(40)
        csr = _csr(A)
        fac = lu(csr, method="supernodal")
        n = A.shape[0]
        assert fac.snlu.plan.lu_nnz < 0.2 * n * n

    def test_structurally_unsymmetric(self, rng):
        n = 60
        B = sps.random(n, n, 0.06, random_state=7, format="csr")
        A = (B + sps.eye(n) * 8.0).tocsr()  # diagonally dominant
        _check(A, rng)

    def test_random_unsymmetric_values(self, rng):
        n = 80
        S = sps.random(n, n, 0.05, random_state=11, format="csr")
        A = (S - S.T.multiply(0.3) + sps.eye(n) * 10.0).tocsr()
        _check(A, rng)

    def test_no_reorder(self, rng):
        _check(convdiff2d(10), rng, reorder=False)

    def test_auto_dispatches_supernodal_for_wide_band(self, rng):
        # random sparse structure: RCM band is a large fraction of n
        n = 120
        S = sps.random(n, n, 0.05, random_state=3, format="csr")
        A = (S + S.T + sps.eye(n) * 12.0).tocsr()
        A.sort_indices()
        csr = _csr(A)
        fac = lu(csr, method="auto")
        assert fac.snlu is not None
        b = rng.normal(size=n)
        x = np.asarray(lu_solve(fac, jnp.asarray(b)))
        np.testing.assert_allclose(x, spsolve(A.tocsc(), b), rtol=1e-8)

    def test_banded_still_wins_tight_band(self, rng):
        n, bw = 64, 2
        d = np.zeros((n, n))
        for i in range(n):
            for j in range(max(0, i - bw), min(n, i + bw + 1)):
                d[i, j] = rng.normal()
            d[i, i] += 10.0
        A = sps.csr_matrix(d)
        csr = _csr(A)
        fac = lu(csr, method="auto")
        assert fac.snlu is None and fac.band is not None

    def test_perturb_handles_zero_diagonal(self, rng):
        # an off-diagonal-coupled system with a zero diagonal entry:
        # restricted pivoting inside the supernode block handles it
        A = convdiff2d(12).tolil()
        A[5, 5] = 0.0
        A = A.tocsr()
        # still solvable (det != 0): compare against scipy
        _check(A, rng, tol=1e-7)

    def test_multiple_rhs_sequential(self, rng):
        A = convdiff2d(12)
        csr = _csr(A)
        fac = lu(csr, method="supernodal")
        for _ in range(3):
            b = rng.normal(size=A.shape[0])
            x = np.asarray(lu_solve(fac, jnp.asarray(b)))
            np.testing.assert_allclose(
                x, spsolve(A.tocsc(), b), rtol=1e-8)

    def test_f32_values(self, rng):
        A = convdiff2d(10)
        A32 = A.astype(np.float32)
        csr = _csr(A32)
        b = rng.normal(size=A.shape[0]).astype(np.float32)
        fac = lu(csr, method="supernodal")
        x = np.asarray(lu_solve(fac, jnp.asarray(b)))
        xref = spsolve(A.tocsc(), b.astype(np.float64))
        np.testing.assert_allclose(x, xref, rtol=2e-3,
                                   atol=2e-3 * np.abs(xref).max())

    def test_small_magnitude_values_not_corrupted_by_perturb(self, rng):
        # regression: the pivot-lift threshold must scale with the
        # OPERAND, not the pad-polluted block max — a 1e-6-scaled
        # well-conditioned system used to come back ~100% wrong with
        # perturb=True (the default)
        A = (convdiff2d(8) * 1e-6).tocsr()
        A.sort_indices()
        csr = _csr(A.astype(np.float32))
        b = rng.normal(size=A.shape[0]).astype(np.float32) * 1e-6
        fac = lu(csr, method="supernodal", perturb=True)
        x = np.asarray(lu_solve(fac, jnp.asarray(b)))
        xref = spsolve(A.tocsc().astype(np.float64), b.astype(np.float64))
        np.testing.assert_allclose(x, xref, rtol=2e-3,
                                   atol=2e-3 * np.abs(xref).max())

    def test_pivot_true_conflicts_with_supernodal(self):
        csr = _csr(convdiff2d(6))
        with pytest.raises(ValueError, match="partial pivoting"):
            lu(csr, method="supernodal", pivot=True)
