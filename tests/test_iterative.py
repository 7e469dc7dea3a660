"""GMRES + BiCGSTAB (`linalg/iterative.py`). Oracle: dense solves."""

import numpy as np
import pytest

import jax

from spalinalg import CooMatrix, CsrMatrix
from spalinalg.linalg import bicgstab, cg, gmres


def _nonsym(rng, n, density=0.05, shift=4.0):
    """Diagonally-dominant nonsymmetric sparse matrix (solver-friendly)."""
    nnz = int(n * n * density)
    rows = np.concatenate([rng.integers(0, n, nnz), np.arange(n)])
    cols = np.concatenate([rng.integers(0, n, nnz), np.arange(n)])
    vals = np.concatenate([rng.normal(size=nnz) * 0.5,
                           np.full(n, shift + 0.1 * n * density)])
    coo = CooMatrix.with_triplets(n, n, rows.tolist(), cols.tolist(),
                                  vals.tolist())
    return CsrMatrix.from_coo(coo)


@pytest.mark.parametrize("solver", [gmres, bicgstab])
def test_solves_nonsymmetric(rng, solver):
    n = 96
    A = _nonsym(rng, n)
    x_true = rng.normal(size=n)
    b = np.asarray(A.to_dense()) @ x_true
    res = solver(A, b, tol=1e-10)
    assert float(res.residual) < 1e-8 * np.linalg.norm(b) + 1e-8
    np.testing.assert_allclose(np.asarray(res.x), x_true, atol=1e-6)


@pytest.mark.parametrize("solver", [gmres, bicgstab])
def test_matches_cg_on_spd(rng, solver):
    """On an SPD operand all three Krylov solvers agree."""
    n = 64
    # SPD: A = B Bᵀ + n I via the dense oracle, loaded back as CSR
    B = rng.normal(size=(n, n)) * 0.2
    dense = B @ B.T + np.eye(n) * 2.0
    rows, cols = np.nonzero(dense)
    A = CsrMatrix.from_coo(CooMatrix.with_triplets(
        n, n, rows.tolist(), cols.tolist(), dense[rows, cols].tolist()))
    b = rng.normal(size=n)
    x_ref = np.asarray(cg(A, b, tol=1e-12).x)
    x = np.asarray(solver(A, b, tol=1e-12).x)
    np.testing.assert_allclose(x, x_ref, atol=1e-8)


def test_gmres_restart_sizes(rng):
    """Small restart must still converge (just more cycles)."""
    n = 80
    A = _nonsym(rng, n)
    b = rng.normal(size=n)
    ref = np.linalg.solve(np.asarray(A.to_dense()), b)
    for m in (4, 16, 64):
        res = gmres(A, b, tol=1e-10, restart=m)
        np.testing.assert_allclose(np.asarray(res.x), ref, atol=1e-6)


def test_gmres_exact_in_n_steps(rng):
    """Unrestarted GMRES is exact after n Arnoldi steps."""
    n = 24
    A = _nonsym(rng, n, density=0.3)
    b = rng.normal(size=n)
    res = gmres(A, b, tol=1e-12, restart=n)
    assert int(res.iterations) <= n + 1
    np.testing.assert_allclose(
        np.asarray(res.x), np.linalg.solve(np.asarray(A.to_dense()), b),
        atol=1e-8)


@pytest.mark.parametrize("solver", [gmres, bicgstab])
def test_jittable(rng, solver):
    n = 48
    A = _nonsym(rng, n)
    b = rng.normal(size=n)
    f = jax.jit(lambda rhs: solver(A, rhs, tol=1e-10, maxiter=20 * n).x)
    np.testing.assert_allclose(
        np.asarray(f(b)),
        np.linalg.solve(np.asarray(A.to_dense()), b), atol=1e-6)


def test_x0_warm_start(rng):
    n = 48
    A = _nonsym(rng, n)
    b = rng.normal(size=n)
    x_ref = np.linalg.solve(np.asarray(A.to_dense()), b)
    res = gmres(A, b, x0=x_ref + 1e-6 * rng.normal(size=n), tol=1e-10)
    assert int(res.iterations) <= 40
    np.testing.assert_allclose(np.asarray(res.x), x_ref, atol=1e-6)


class TestDistributed:
    @pytest.fixture
    def mesh(self):
        from spalinalg.parallel.partition import make_row_mesh

        return make_row_mesh(8)

    @pytest.mark.parametrize("solver", [gmres, bicgstab])
    def test_dist_parity(self, rng, mesh, solver):
        from spalinalg.parallel.partition import partition_csr
        from spalinalg.parallel.spmv import shard_vector, unshard_vector

        n = 96
        A = _nonsym(rng, n)
        b = rng.normal(size=n)
        ref = np.asarray(solver(A, b, tol=1e-10).x)
        dist = partition_csr(A, mesh)
        bs = shard_vector(b, dist)
        res = solver(dist, bs, tol=1e-10)
        x = np.asarray(unshard_vector(res.x, dist))
        np.testing.assert_allclose(x, ref, atol=1e-6)
