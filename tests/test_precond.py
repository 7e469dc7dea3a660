"""ILU(0)/IC(0) preconditioners (`linalg/precond.py`) and their wiring
into cg/gmres/bicgstab. Oracle: exact dense factorizations restricted to
the pattern + convergence-acceleration assertions."""

import numpy as np
import pytest

import jax

from spalinalg import CooMatrix, CsrMatrix
from spalinalg.errors import ShapeError, StructureError
from spalinalg.linalg import bicgstab, cg, gmres, ic0, ilu0


def _laplacian_2d(g):
    n = g * g
    ent = []
    for i in range(g):
        for j in range(g):
            k = i * g + j
            ent.append((k, k, 4.0))
            for di, dj in ((1, 0), (-1, 0), (0, 1), (0, -1)):
                a, b = i + di, j + dj
                if 0 <= a < g and 0 <= b < g:
                    ent.append((k, a * g + b, -1.0))
    return CsrMatrix.from_coo(CooMatrix.with_entries(n, n, ent))


def _nonsym(rng, n, density=0.06):
    nnz = int(n * n * density)
    rows = np.concatenate([rng.integers(0, n, nnz), np.arange(n)])
    cols = np.concatenate([rng.integers(0, n, nnz), np.arange(n)])
    vals = np.concatenate([rng.normal(size=nnz) * 0.4, np.full(n, 5.0)])
    return CsrMatrix.from_coo(CooMatrix.with_triplets(
        n, n, rows.tolist(), cols.tolist(), vals.tolist()))


def test_ilu0_exact_when_no_fill(rng):
    """On a tridiagonal matrix ILU(0) IS the exact LU — M.solve == A^-1."""
    n = 24
    ent = [(i, i, 4.0) for i in range(n)]
    ent += [(i, i + 1, -1.0) for i in range(n - 1)]
    ent += [(i + 1, i, -2.0) for i in range(n - 1)]
    A = CsrMatrix.from_coo(CooMatrix.with_entries(n, n, ent))
    M = ilu0(A)
    b = rng.normal(size=n)
    x = np.asarray(M.solve(b))
    np.testing.assert_allclose(
        np.asarray(A.to_dense()) @ x, b, atol=1e-8)


def test_ic0_exact_when_no_fill(rng):
    n = 24
    ent = [(i, i, 4.0) for i in range(n)]
    ent += [(i, i + 1, -1.0) for i in range(n - 1)]
    ent += [(i + 1, i, -1.0) for i in range(n - 1)]
    A = CsrMatrix.from_coo(CooMatrix.with_entries(n, n, ent))
    M = ic0(A)
    b = rng.normal(size=n)
    np.testing.assert_allclose(
        np.asarray(A.to_dense()) @ np.asarray(M.solve(b)), b, atol=1e-8)


def test_ilu0_lu_product_matches_on_pattern(rng):
    """L@U must equal A exactly ON A's sparsity pattern (ILU(0) contract)."""
    A = _nonsym(rng, 40)
    M = ilu0(A)
    lu = np.asarray(M.l_mat.to_dense()) @ np.asarray(M.u_mat.to_dense())
    a = np.asarray(A.to_dense())
    mask = a != 0
    np.testing.assert_allclose(lu[mask], a[mask], atol=1e-8)


def test_ic0_llt_matches_on_pattern():
    A = _laplacian_2d(6)
    M = ic0(A)
    llt = np.asarray(M.l_mat.to_dense()) @ np.asarray(M.l_mat.to_dense()).T
    a = np.asarray(A.to_dense())
    mask = np.tril(a) != 0
    np.testing.assert_allclose(llt[mask], a[mask], atol=1e-8)


def test_pcg_accelerates():
    A = _laplacian_2d(16)           # n=256, cond ~ O(g^2)
    b = np.ones(A.nrows)
    plain = cg(A, b, tol=1e-10)
    pre = cg(A, b, tol=1e-10, precondition=ic0(A))
    assert float(pre.residual) < 1e-8
    assert int(pre.iterations) <= int(plain.iterations) * 0.8
    np.testing.assert_allclose(np.asarray(pre.x), np.asarray(plain.x),
                               atol=1e-6)


def test_pgmres_accelerates(rng):
    A = _nonsym(rng, 128)
    b = rng.normal(size=128)
    ref = np.linalg.solve(np.asarray(A.to_dense()), b)
    plain = gmres(A, b, tol=1e-10, restart=8)
    pre = gmres(A, b, tol=1e-10, restart=8, M=ilu0(A))
    assert int(pre.iterations) <= int(plain.iterations)
    np.testing.assert_allclose(np.asarray(pre.x), ref, atol=1e-6)


def test_pbicgstab(rng):
    A = _nonsym(rng, 96)
    b = rng.normal(size=96)
    ref = np.linalg.solve(np.asarray(A.to_dense()), b)
    pre = bicgstab(A, b, tol=1e-10, M=ilu0(A))
    np.testing.assert_allclose(np.asarray(pre.x), ref, atol=1e-6)
    plain = bicgstab(A, b, tol=1e-10)
    assert int(pre.iterations) <= int(plain.iterations)


def test_precond_jittable(rng):
    A = _nonsym(rng, 48)
    M = ilu0(A)
    b = rng.normal(size=48)
    f = jax.jit(M.solve)
    np.testing.assert_allclose(np.asarray(f(b)), np.asarray(M.solve(b)),
                               atol=1e-10)


def test_validation(rng):
    wide = CsrMatrix.from_coo(CooMatrix.with_entries(
        2, 5, [(0, 0, 1.0), (1, 4, 2.0)]))
    with pytest.raises(ShapeError):
        ilu0(wide)
    # missing diagonal
    n = 4
    A = CsrMatrix.from_coo(CooMatrix.with_entries(
        n, n, [(i, i, 2.0) for i in range(n - 1)] + [(n - 1, 0, 1.0)]))
    with pytest.raises(StructureError):
        ilu0(A)
    # indefinite matrix fails ic0
    B = CsrMatrix.from_coo(CooMatrix.with_entries(
        2, 2, [(0, 0, 1.0), (0, 1, 3.0), (1, 0, 3.0), (1, 1, 1.0)]))
    with pytest.raises(StructureError):
        ic0(B)
    with pytest.raises(ValueError):
        cg(_laplacian_2d(4), np.ones(16), precondition=123)


def test_dist_rejects_factorization_precond(rng):
    from spalinalg.parallel.partition import make_row_mesh, partition_csr
    from spalinalg.parallel.spmv import shard_vector

    A = _nonsym(rng, 64)
    dist = partition_csr(A, make_row_mesh(8))
    bs = shard_vector(np.ones(64), dist)
    with pytest.raises(ValueError):
        gmres(dist, bs, M=ilu0(A))


class TestChebyshev:
    def test_approximates_inverse(self):
        from spalinalg.linalg import chebyshev

        A = _laplacian_2d(8)
        M = chebyshev(A, degree=40, lmin=0.1, lmax=8.0)
        b = np.ones(A.nrows)
        z = np.asarray(M.solve(b))
        ref = np.linalg.solve(np.asarray(A.to_dense()), b)
        # degree-40 on a bracketed spectrum: close to the true inverse
        assert np.linalg.norm(z - ref) < 0.05 * np.linalg.norm(ref)

    def test_accelerates_cg(self):
        from spalinalg.linalg import chebyshev

        A = _laplacian_2d(16)
        b = np.ones(A.nrows)
        plain = cg(A, b, tol=1e-10)
        M = chebyshev(A, degree=8)        # auto spectrum estimate
        pre = cg(A, b, tol=1e-10, precondition=M)
        assert float(pre.residual) < 1e-8
        assert int(pre.iterations) < int(plain.iterations) / 2
        np.testing.assert_allclose(np.asarray(pre.x), np.asarray(plain.x),
                                   atol=1e-6)

    def test_distributed_composes(self, rng):
        """Chebyshev is pure SpMV -> works on DistCsr operands directly."""
        import jax as _jax

        from spalinalg.linalg import chebyshev
        from spalinalg.parallel.partition import (
            make_row_mesh,
            partition_csr,
        )
        from spalinalg.parallel.spmv import shard_vector, unshard_vector

        A = _laplacian_2d(8)
        n = A.nrows
        b = rng.normal(size=n)
        ref = np.asarray(cg(A, b, tol=1e-10,
                            precondition=chebyshev(A, degree=6,
                                                   lmin=0.2, lmax=8.0)).x)
        dist = partition_csr(A, make_row_mesh(8))
        M = chebyshev(dist, degree=6, lmin=0.2, lmax=8.0)
        bs = shard_vector(b, dist)
        res = cg(dist, bs, tol=1e-10, precondition=M)
        x = np.asarray(unshard_vector(res.x, dist))
        np.testing.assert_allclose(x, ref, atol=1e-6)

    def test_validation(self):
        from spalinalg.linalg import chebyshev

        A = _laplacian_2d(4)
        with pytest.raises(ValueError):
            chebyshev(A, degree=0)
        with pytest.raises(ValueError):
            chebyshev(A, lmin=5.0, lmax=1.0)


class TestNativeParity:
    """Native C++ ilu0/ic0 sweeps vs the pure-Python reference path."""

    def test_ilu0_native_matches_python(self, rng):
        from spalinalg.native import lib as native

        if not native.available():
            pytest.skip("native library unavailable")
        A = _nonsym(rng, 48)
        import spalinalg.linalg.precond as P

        ref = ilu0(A)                 # native path
        orig = native.available
        native.available = lambda: False
        try:
            py = ilu0(A)              # python path
        finally:
            native.available = orig
        np.testing.assert_allclose(np.asarray(ref.l_mat.to_dense()),
                                   np.asarray(py.l_mat.to_dense()),
                                   atol=1e-12)
        np.testing.assert_allclose(np.asarray(ref.u_mat.to_dense()),
                                   np.asarray(py.u_mat.to_dense()),
                                   atol=1e-12)

    def test_ic0_native_matches_python(self, rng):
        from spalinalg.native import lib as native

        if not native.available():
            pytest.skip("native library unavailable")
        A = _laplacian_2d(8)
        ref = ic0(A)
        orig = native.available
        native.available = lambda: False
        try:
            py = ic0(A)
        finally:
            native.available = orig
        np.testing.assert_allclose(np.asarray(ref.l_mat.to_dense()),
                                   np.asarray(py.l_mat.to_dense()),
                                   atol=1e-12)
