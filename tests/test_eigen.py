"""Lanczos eigsh / svds (`linalg/eigen.py`). Oracle: dense numpy."""

import numpy as np
import pytest

import jax.numpy as jnp

from spalinalg import BsrMatrix, CooMatrix, CsrMatrix
from spalinalg.errors import ShapeError
from spalinalg.linalg import eigsh, lanczos, svds


def _sym(rng, n, density=0.1, shift=0.0):
    d = np.where(rng.random((n, n)) < density, rng.normal(size=(n, n)), 0)
    d = (d + d.T) / 2 + shift * np.eye(n)
    d = d.astype(np.float64)
    rows, cols = np.nonzero(d)
    coo = CooMatrix.with_triplets(n, n, rows.tolist(), cols.tolist(),
                                  d[rows, cols].tolist())
    return CsrMatrix.from_coo(coo), d


def test_lanczos_orthonormal_basis(rng):
    A, d = _sym(rng, 64)
    alpha, beta, V = lanczos(A, 20)
    Vn = np.asarray(V)
    np.testing.assert_allclose(Vn @ Vn.T, np.eye(20), atol=1e-8)
    # three-term recurrence reproduces A on the Krylov space: V A Vᵀ = T
    T = Vn @ d @ Vn.T
    np.testing.assert_allclose(np.diag(T), np.asarray(alpha), atol=1e-8)
    np.testing.assert_allclose(np.diag(T, 1), np.asarray(beta), atol=1e-8)


@pytest.mark.parametrize("which", ["LA", "SA"])
def test_eigsh_extremal(rng, which):
    A, d = _sym(rng, 96)
    w, v = eigsh(A, k=4, which=which, m=60)
    ew = np.linalg.eigvalsh(d)
    ref = ew[-4:] if which == "LA" else ew[:4]
    np.testing.assert_allclose(np.asarray(w), ref, atol=1e-7)
    # residual check: ||A v - w v|| small
    for j in range(4):
        vv = np.asarray(v[:, j])
        assert np.linalg.norm(d @ vv - float(w[j]) * vv) < 1e-6


def test_eigsh_spd_smallest(rng):
    A, d = _sym(rng, 64, shift=8.0)
    w, v = eigsh(A, k=2, which="SA", m=64)
    ref = np.linalg.eigvalsh(d)[:2]
    np.testing.assert_allclose(np.asarray(w), ref, atol=1e-7)


def test_eigsh_bsr_operand(rng):
    A, d = _sym(rng, 64)
    bsr = A.to_bsr(8)
    w, _ = eigsh(bsr, k=3, which="LA", m=48)
    np.testing.assert_allclose(
        np.asarray(w), np.linalg.eigvalsh(d)[-3:], atol=1e-5)


@pytest.mark.parametrize("shape", [(80, 40), (40, 80)])
def test_svds_matches_numpy(rng, shape):
    m, n = shape
    d = np.where(rng.random((m, n)) < 0.2, rng.normal(size=(m, n)), 0)
    rows, cols = np.nonzero(d)
    A = CsrMatrix.from_coo(CooMatrix.with_triplets(
        m, n, rows.tolist(), cols.tolist(), d[rows, cols].tolist()))
    u, s, vt = svds(A, k=3, m=60)
    ref = np.linalg.svd(d, compute_uv=False)[:3]
    np.testing.assert_allclose(np.asarray(s), ref, atol=1e-6)
    # triplet consistency: A v = s u
    for j in range(3):
        lhs = d @ np.asarray(vt)[j]
        rhs = float(s[j]) * np.asarray(u)[:, j]
        np.testing.assert_allclose(lhs, rhs, atol=1e-6)


def test_validation(rng):
    A, _ = _sym(rng, 16)
    with pytest.raises(ValueError):
        eigsh(A, k=0)
    with pytest.raises(ValueError):
        eigsh(A, k=16)
    with pytest.raises(ValueError):
        eigsh(A, k=2, which="LM")
    wide = CsrMatrix.from_coo(CooMatrix.with_entries(
        2, 5, [(0, 0, 1.0), (1, 4, 2.0)]))
    with pytest.raises(ShapeError):
        eigsh(wide, k=1)


class TestDistributed:
    def test_eigsh_dist_parity(self, rng):
        """eigsh on a DistCsr (first-class @ operand) matches single-chip."""
        from spalinalg.parallel.partition import (
            make_row_mesh,
            partition_csr,
        )

        A, d = _sym(rng, 96)
        w_ref, _ = eigsh(A, k=3, which="LA", m=60)
        dist = partition_csr(A, make_row_mesh(8))
        w, v = eigsh(dist, k=3, which="LA", m=60)
        np.testing.assert_allclose(np.asarray(w), np.asarray(w_ref),
                                   atol=1e-8)

    def test_expm_dist_parity(self, rng):
        from spalinalg.linalg import expm_multiply
        from spalinalg.parallel.partition import (
            make_row_mesh,
            partition_csr,
        )
        from spalinalg.parallel.spmv import shard_vector, unshard_vector

        A, d = _sym(rng, 64)
        A2 = CsrMatrix.from_coo(
            CooMatrix.with_triplets(
                64, 64, *[list(x) for x in zip(*[(r, c, v * 0.1)
                    for r, c, v in zip(*map(np.asarray, A._coo_arrays_host()))])]))
        b = rng.normal(size=64)
        ref = np.asarray(expm_multiply(A2, b, t=1.0, m=40))
        dist = partition_csr(A2, make_row_mesh(8))
        u = expm_multiply(dist, shard_vector(b, dist), t=1.0, m=40)
        np.testing.assert_allclose(
            np.asarray(unshard_vector(u, dist)), ref, atol=1e-8)


class TestBlockLanczos:
    def test_resolves_degenerate_cluster(self, rng):
        """2-D grid Laplacian: lambda_{p,q} = lambda_{q,p} (multiplicity 2).
        Single-vector Lanczos finds one copy; block=2 finds both."""
        from spalinalg.linalg import eigsh

        g = 12
        n = g * g
        ent = []
        for i in range(g):
            for j in range(g):
                kk = i * g + j
                ent.append((kk, kk, 4.0))
                for di, dj in ((1, 0), (-1, 0), (0, 1), (0, -1)):
                    a, b2 = i + di, j + dj
                    if 0 <= a < g and 0 <= b2 < g:
                        ent.append((kk, a * g + b2, -1.0))
        A = CsrMatrix.from_coo(CooMatrix.with_entries(n, n, ent))
        lam = lambda p, q: (4 - 2 * np.cos(p * np.pi / (g + 1))
                            - 2 * np.cos(q * np.pi / (g + 1)))
        ref = np.sort([lam(p, q) for p in range(1, 4)
                       for q in range(1, 4)])[:4]     # includes a pair
        w, v = eigsh(A, k=4, which="SA", block=2, m=40)
        np.testing.assert_allclose(np.asarray(w), ref, atol=1e-7)
        # eigenvectors orthonormal
        vv = np.asarray(v)
        np.testing.assert_allclose(vv.T @ vv, np.eye(4), atol=1e-7)

    def test_block_matches_single_on_simple_spectrum(self, rng):
        from spalinalg.linalg import eigsh

        A, d = _sym(rng, 80)
        w1, _ = eigsh(A, k=3, which="LA", m=50)
        w2, _ = eigsh(A, k=3, which="LA", block=3, m=18)
        ref = np.linalg.eigvalsh(d)[-3:]
        np.testing.assert_allclose(np.asarray(w1), ref, atol=1e-6)
        np.testing.assert_allclose(np.asarray(w2), ref, atol=1e-6)

    def test_basis_orthonormal(self, rng):
        from spalinalg.linalg import block_lanczos

        A, d = _sym(rng, 64)
        V = np.asarray(block_lanczos(A, 10, 3))
        np.testing.assert_allclose(V @ V.T, np.eye(30), atol=1e-8)


class TestShiftInvert:
    def test_smallest_laplacian_modes_exact(self):
        """sigma=0 shift-invert: machine-precision smallest modes incl.
        the degenerate pair (the exterior-Lanczos slow case)."""
        from spalinalg.linalg import eigsh

        g = 16
        n = g * g
        ent = []
        for i in range(g):
            for j in range(g):
                kk = i * g + j
                ent.append((kk, kk, 4.0))
                for di, dj in ((1, 0), (-1, 0), (0, 1), (0, -1)):
                    a, b2 = i + di, j + dj
                    if 0 <= a < g and 0 <= b2 < g:
                        ent.append((kk, a * g + b2, -1.0))
        A = CsrMatrix.from_coo(CooMatrix.with_entries(n, n, ent))
        lam = lambda p, q: (4 - 2 * np.cos(p * np.pi / (g + 1))
                            - 2 * np.cos(q * np.pi / (g + 1)))
        ref = np.sort([lam(p, q) for p in range(1, 5)
                       for q in range(1, 5)])[:4]
        w, v = eigsh(A, k=4, sigma=0.0, block=2, m=24)
        np.testing.assert_allclose(np.asarray(w), ref, atol=1e-10)
        # residuals ||A v - w v||
        d = np.asarray(A.to_dense())
        for j in range(4):
            vv = np.asarray(v[:, j])
            assert np.linalg.norm(d @ vv - float(w[j]) * vv) < 1e-5

    def test_interior_shift(self, rng):
        """sigma inside the spectrum returns the eigenvalues nearest it."""
        from spalinalg.linalg import eigsh

        A, d = _sym(rng, 60, shift=0.0)
        ew = np.linalg.eigvalsh(d)
        sigma = float((ew[29] + ew[30]) / 2)
        w, _ = eigsh(A, k=3, sigma=sigma, m=40)
        ref = ew[np.argsort(np.abs(ew - sigma))[:3]]
        np.testing.assert_allclose(np.sort(np.asarray(w)), np.sort(ref),
                                   atol=1e-7)


class TestLobpcg:
    """LOBPCG (`linalg/eigen.py::lobpcg`). Oracle: dense numpy / analytic."""

    def _grid_laplacian(self, g):
        n = g * g
        ent = []
        for i in range(g):
            for j in range(g):
                kk = i * g + j
                ent.append((kk, kk, 4.0))
                for di, dj in ((1, 0), (-1, 0), (0, 1), (0, -1)):
                    a, b2 = i + di, j + dj
                    if 0 <= a < g and 0 <= b2 < g:
                        ent.append((kk, a * g + b2, -1.0))
        return CsrMatrix.from_coo(CooMatrix.with_entries(n, n, ent))

    def test_smallest_cluster_2d_laplacian(self, rng):
        """Finds the smallest modes *including* the multiplicity-2 pair."""
        from spalinalg.linalg import lobpcg

        g = 12
        A = self._grid_laplacian(g)
        lam = lambda p, q: (4 - 2 * np.cos(p * np.pi / (g + 1))
                            - 2 * np.cos(q * np.pi / (g + 1)))
        ref = np.sort([lam(p, q) for p in range(1, 4)
                       for q in range(1, 4)])[:4]
        w, X, resid = lobpcg(A, k=4, maxiter=80, seed=3)
        np.testing.assert_allclose(np.asarray(w), ref, atol=1e-5)
        assert np.all(np.asarray(resid) < 1e-3)
        Xn = np.asarray(X)
        np.testing.assert_allclose(Xn.T @ Xn, np.eye(4), atol=1e-5)

    def test_largest(self, rng):
        from spalinalg.linalg import lobpcg

        A, d = _sym(rng, 96, shift=0.0)
        w, X, _ = lobpcg(A, k=3, which="LA", maxiter=80, seed=5)
        ref = np.linalg.eigvalsh(d)[-3:]
        np.testing.assert_allclose(np.asarray(w), ref, atol=1e-5)

    def test_preconditioned_converges_faster(self, rng):
        """IC(0) preconditioning reduces the residual at equal maxiter."""
        from spalinalg.linalg import ic0, lobpcg

        A = self._grid_laplacian(14)
        M = ic0(A)
        w_p, _, r_p = lobpcg(A, k=2, maxiter=15, M=M, seed=2)
        w_u, _, r_u = lobpcg(A, k=2, maxiter=15, seed=2)
        assert float(np.max(np.asarray(r_p))) < float(np.max(np.asarray(r_u)))

    def test_callable_preconditioner_and_x0(self, rng):
        from spalinalg.linalg import lobpcg

        A, d = _sym(rng, 60, shift=8.0)   # SPD-ish via diagonal shift
        diag = np.asarray([d[i, i] for i in range(60)])
        M = lambda r: r / jnp.asarray(diag, r.dtype)
        X0 = rng.normal(size=(60, 2)).astype(np.float32)
        w, X, _ = lobpcg(A, X0=X0, which="SA", maxiter=80, M=M)
        ref = np.linalg.eigvalsh(d)[:2]
        np.testing.assert_allclose(np.asarray(w), ref, atol=1e-4)

    def test_validation(self, rng):
        from spalinalg.linalg import lobpcg

        A, _ = _sym(rng, 30)
        with pytest.raises(ValueError):
            lobpcg(A)                      # neither X0 nor k
        with pytest.raises(ValueError):
            lobpcg(A, k=11)                # 3k > n
        with pytest.raises(ValueError):
            lobpcg(A, k=2, which="SM")
        with pytest.raises(TypeError):
            lobpcg(A, k=2, M=3.0)
        rect = CsrMatrix.from_coo(
            CooMatrix.with_entries(4, 5, [(0, 0, 1.0)]))
        with pytest.raises(ShapeError):
            lobpcg(rect, k=1)

    def test_dist_parity(self, rng):
        """lobpcg on a DistCsr matches the single-chip result."""
        from spalinalg.linalg import lobpcg
        from spalinalg.parallel.partition import (make_row_mesh,
                                                      partition_csr)

        A = self._grid_laplacian(12)
        mesh = make_row_mesh(8)
        dA = partition_csr(A, mesh)
        w1, _, _ = lobpcg(A, k=3, maxiter=50, seed=4)
        w8, X8, r8 = lobpcg(dA, k=3, maxiter=50, seed=4)
        np.testing.assert_allclose(np.asarray(w8), np.asarray(w1),
                                   atol=1e-6)
        assert np.all(np.asarray(r8) < 1e-3)
        # pad rows of the sharded Ritz block stay exactly zero
        n = A.shape[0]
        assert np.all(np.asarray(X8)[n:] == 0.0)

    def test_dist_rejects_single_chip_preconditioner(self, rng):
        from spalinalg.linalg import ic0, lobpcg
        from spalinalg.parallel.partition import (make_row_mesh,
                                                      partition_csr)

        A = self._grid_laplacian(8)
        dA = partition_csr(A, make_row_mesh(8))
        with pytest.raises(ValueError):
            lobpcg(dA, k=2, M=ic0(A))
