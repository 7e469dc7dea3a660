"""Factorization / solver tests (N5 + CG): banded Cholesky/LU panels,
level-scheduled triangular solve, RCM ordering, CG on Laplacians
(BASELINE config[3] shapes)."""

import numpy as np
import pytest

import jax.numpy as jnp

from spalinalg import CooMatrix, CsrMatrix
from spalinalg.linalg import (
    bandwidth,
    band_cholesky_factor,
    band_cholesky_solve,
    band_lu_factor,
    band_lu_solve,
    cg,
    cholesky,
    cholesky_solve,
    lu,
    lu_solve,
    permute_csr,
    plan_triangular,
    rcm_ordering,
    solve_triangular_csr,
)


def laplacian_1d(n):
    coo = CooMatrix(n, n)
    for i in range(n):
        coo.push(i, i, 2.0)
        if i > 0:
            coo.push(i, i - 1, -1.0)
        if i < n - 1:
            coo.push(i, i + 1, -1.0)
    return CsrMatrix.from_coo(coo)


def laplacian_2d(k):
    """5-point stencil on a k x k grid (SPD, n = k^2)."""
    n = k * k
    coo = CooMatrix(n, n)
    for i in range(k):
        for j in range(k):
            u = i * k + j
            coo.push(u, u, 4.0)
            for di, dj in ((1, 0), (-1, 0), (0, 1), (0, -1)):
                a, b = i + di, j + dj
                if 0 <= a < k and 0 <= b < k:
                    coo.push(u, a * k + b, -1.0)
    return CsrMatrix.from_coo(coo)


def csr_of_dense(d):
    n, m = d.shape
    coo = CooMatrix(n, m)
    for i, j in zip(*np.nonzero(d)):
        coo.push(int(i), int(j), float(d[i, j]))
    return CsrMatrix.from_coo(coo)


class TestOrdering:
    def test_rcm_reduces_bandwidth(self):
        # scrambled 1-D Laplacian: RCM should recover a narrow band
        n = 50
        rng = np.random.default_rng(0)
        p = rng.permutation(n)
        a = laplacian_1d(n)
        scrambled = permute_csr(a, p)
        assert bandwidth(scrambled) > 5
        perm = rcm_ordering(scrambled)
        assert bandwidth(permute_csr(scrambled, perm)) <= 2

    def test_permute_roundtrip(self, rng):
        d = np.where(rng.random((9, 9)) < 0.4, rng.normal(size=(9, 9)), 0)
        d = d + d.T
        a = csr_of_dense(d)
        p = rng.permutation(9)
        ap = permute_csr(a, p)
        np.testing.assert_allclose(np.asarray(ap.to_dense()),
                                   d[np.ix_(p, p)], rtol=1e-12)


class TestBandCholesky:
    @pytest.mark.parametrize("n,panel", [(10, 4), (37, 8), (64, 64), (100, 16)])
    def test_laplacian_1d(self, n, panel):
        a = laplacian_1d(n)
        fac = band_cholesky_factor(a, bandwidth=1, panel=panel)
        rng = np.random.default_rng(1)
        b = rng.normal(size=n)
        x = band_cholesky_solve(fac, b)
        expected = np.linalg.solve(np.asarray(a.to_dense()), b)
        np.testing.assert_allclose(np.asarray(x), expected, rtol=1e-10)

    def test_laplacian_2d(self):
        k = 8
        a = laplacian_2d(k)
        fac = band_cholesky_factor(a, bandwidth=k, panel=16)
        rng = np.random.default_rng(2)
        b = rng.normal(size=k * k)
        x = band_cholesky_solve(fac, b)
        expected = np.linalg.solve(np.asarray(a.to_dense()), b)
        np.testing.assert_allclose(np.asarray(x), expected, rtol=1e-9)

    def test_wide_band_spd(self, rng):
        n, bw = 40, 7
        d = np.zeros((n, n))
        for i in range(n):
            for j in range(max(0, i - bw), min(n, i + bw + 1)):
                d[i, j] = rng.normal()
        d = d @ d.T + n * np.eye(n)  # SPD, band 2*bw
        a = csr_of_dense(d)
        fac = band_cholesky_factor(a, bandwidth=2 * bw, panel=8)
        b = rng.normal(size=n)
        x = band_cholesky_solve(fac, b)
        np.testing.assert_allclose(np.asarray(x), np.linalg.solve(d, b),
                                   rtol=1e-8)


class TestCholeskyApi:
    def test_scrambled_laplacian_end_to_end(self):
        n = 60
        rng = np.random.default_rng(3)
        p = rng.permutation(n)
        a = permute_csr(laplacian_1d(n), p)  # scrambled SPD
        fac = cholesky(a)
        b = rng.normal(size=n)
        x = cholesky_solve(fac, b)
        np.testing.assert_allclose(
            np.asarray(x), np.linalg.solve(np.asarray(a.to_dense()), b),
            rtol=1e-9,
        )

    def test_dense_ish_goes_general(self, rng):
        # dense-ish SPD: RCM can't band it; the general supernodal path
        # handles it (one big front), replacing the r1 dense fallback
        d = rng.normal(size=(20, 20))
        d = d @ d.T + 20 * np.eye(20)
        a = csr_of_dense(d)
        fac = cholesky(a)
        assert fac.snf is not None and not fac.is_dense
        b = rng.normal(size=20)
        np.testing.assert_allclose(np.asarray(cholesky_solve(fac, b)),
                                   np.linalg.solve(d, b), rtol=1e-8)

    def test_dense_method_forced(self, rng):
        d = rng.normal(size=(16, 16))
        d = d @ d.T + 16 * np.eye(16)
        a = csr_of_dense(d)
        fac = cholesky(a, method="dense")
        assert fac.is_dense
        b = rng.normal(size=16)
        np.testing.assert_allclose(np.asarray(cholesky_solve(fac, b)),
                                   np.linalg.solve(d, b), rtol=1e-8)


class TestBandLu:
    def test_nonsymmetric_banded(self, rng):
        n, bw = 50, 3
        d = np.zeros((n, n))
        for i in range(n):
            for j in range(max(0, i - bw), min(n, i + bw + 1)):
                d[i, j] = rng.normal()
            d[i, i] += 10.0  # diagonally dominant: no-pivot safe
        a = csr_of_dense(d)
        fac = band_lu_factor(a, bandwidth=bw, panel=8)
        b = rng.normal(size=n)
        x = band_lu_solve(fac, b)
        np.testing.assert_allclose(np.asarray(x), np.linalg.solve(d, b),
                                   rtol=1e-8)

    def test_lu_api_pivot_fallback(self, rng):
        d = rng.normal(size=(15, 15)) + 2 * np.eye(15)
        a = csr_of_dense(d)
        fac = lu(a, pivot=True)
        b = rng.normal(size=15)
        np.testing.assert_allclose(np.asarray(lu_solve(fac, b)),
                                   np.linalg.solve(d, b), rtol=1e-8)


class TestTriangular:
    def test_lower_solve(self, rng):
        n = 30
        d = np.tril(np.where(rng.random((n, n)) < 0.3,
                             rng.normal(size=(n, n)), 0))
        np.fill_diagonal(d, rng.normal(size=n) + 3.0)
        a = csr_of_dense(d)
        b = rng.normal(size=n)
        x = solve_triangular_csr(a, b, lower=True)
        np.testing.assert_allclose(np.asarray(x), np.linalg.solve(d, b),
                                   rtol=1e-9)

    def test_upper_solve(self, rng):
        n = 25
        d = np.triu(np.where(rng.random((n, n)) < 0.3,
                             rng.normal(size=(n, n)), 0))
        np.fill_diagonal(d, rng.normal(size=n) + 3.0)
        a = csr_of_dense(d)
        b = rng.normal(size=n)
        x = solve_triangular_csr(a, b, lower=False)
        np.testing.assert_allclose(np.asarray(x), np.linalg.solve(d, b),
                                   rtol=1e-9)

    def test_plan_reuse(self, rng):
        n = 20
        d = np.tril(rng.normal(size=(n, n)))
        np.fill_diagonal(d, 5.0)
        a = csr_of_dense(d)
        plan = plan_triangular(a, lower=True)
        for _ in range(2):
            b = rng.normal(size=n)
            x = solve_triangular_csr(a, b, lower=True, plan=plan)
            np.testing.assert_allclose(np.asarray(x), np.linalg.solve(d, b),
                                       rtol=1e-9)

    def test_deep_fallback_host(self):
        # 1-D Laplacian lower factor: n levels -> host fallback path
        n = 400
        d = np.tril(np.asarray(laplacian_1d(n).to_dense()))
        a = csr_of_dense(d)
        b = np.ones(n)
        x = solve_triangular_csr(a, b, lower=True)
        np.testing.assert_allclose(np.asarray(x), np.linalg.solve(d, b),
                                   rtol=1e-9)


class TestCg:
    def test_cg_laplacian_1d(self):
        n = 64
        a = laplacian_1d(n)
        rng = np.random.default_rng(4)
        b = rng.normal(size=n)
        res = cg(a, jnp.asarray(b), tol=1e-12)
        np.testing.assert_allclose(
            np.asarray(res.x), np.linalg.solve(np.asarray(a.to_dense()), b),
            rtol=1e-6, atol=1e-8,
        )

    def test_cg_distributed_parity(self):
        import jax
        from spalinalg.parallel.partition import make_row_mesh, partition_csr
        from spalinalg.parallel.spmv import shard_vector, unshard_vector

        n = 96
        a = laplacian_2d(int(np.sqrt(n) + 0.5)) if False else laplacian_1d(n)
        rng = np.random.default_rng(5)
        b = rng.normal(size=n)
        single = cg(a, jnp.asarray(b), tol=1e-12)

        mesh = make_row_mesh(8)
        dist = partition_csr(a, mesh)
        bs = shard_vector(b, dist, by="rows")
        res = cg(dist, bs, tol=1e-12)
        x = unshard_vector(res.x, dist)
        np.testing.assert_allclose(np.asarray(x), np.asarray(single.x),
                                   rtol=1e-6, atol=1e-8)


class TestPreconditionedCg:
    def test_jacobi_cg(self):
        n = 80
        a = laplacian_1d(n)
        # scale rows/cols to make Jacobi matter
        s = np.linspace(1.0, 100.0, n)
        d = np.asarray(a.to_dense()) * np.outer(np.sqrt(s), np.sqrt(s))
        aa = csr_of_dense(d)
        rng = np.random.default_rng(7)
        b = rng.normal(size=n)
        plain = cg(aa, jnp.asarray(b), tol=1e-12, maxiter=4000)
        pre = cg(aa, jnp.asarray(b), tol=1e-12, maxiter=4000,
                 precondition="jacobi")
        ref = np.linalg.solve(d, b)
        np.testing.assert_allclose(np.asarray(pre.x), ref, rtol=1e-5,
                                   atol=1e-7)
        assert int(pre.iterations) <= int(plain.iterations)

    def test_jacobi_cg_distributed(self):
        from spalinalg.parallel.partition import make_row_mesh, partition_csr
        from spalinalg.parallel.spmv import shard_vector, unshard_vector

        n = 96
        a = laplacian_1d(n)
        rng = np.random.default_rng(8)
        b = rng.normal(size=n)
        mesh = make_row_mesh(8)
        dist = partition_csr(a, mesh)
        bs_ = shard_vector(b, dist, by="rows")
        res = cg(dist, bs_, tol=1e-12, precondition="jacobi")
        x = unshard_vector(res.x, dist)
        ref = np.linalg.solve(np.asarray(a.to_dense()), b)
        np.testing.assert_allclose(np.asarray(x), ref, rtol=1e-6, atol=1e-8)
