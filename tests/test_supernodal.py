"""General-sparsity supernodal Cholesky.

The reference documents factorization intent only
(/root/reference/src/csr.rs:16-17); this is north-star N5's general
path: AMD ordering + elimination tree + postorder + relaxed supernodes,
batched multifrontal numeric phase on device, matching scipy to 1e-9.
"""

import jax
import numpy as np
import pytest
import scipy.sparse as sps
from scipy.sparse.linalg import spsolve

import jax.numpy as jnp

from spalinalg import CsrMatrix
from spalinalg.dtypes import INDEX_DTYPE
from spalinalg.linalg.cholesky import cholesky, cholesky_solve
from spalinalg.linalg.symbolic import (
    amd_ordering,
    chol_symbolic,
    etree,
    postorder,
)


def lap2d(k):
    T = sps.diags([-1.0, 4.0, -1.0], [-1, 0, 1], shape=(k, k))
    I = sps.eye(k)
    D = sps.diags([-1.0, -1.0], [-1, 1], shape=(k, k))
    return (sps.kron(I, T) + sps.kron(D, I)).tocsr()


def lap3d(k):
    T = sps.diags([-1.0, 6.0, -1.0], [-1, 0, 1], shape=(k, k))
    I = sps.eye(k)
    D = sps.diags([-1.0, -1.0], [-1, 1], shape=(k, k))
    return (sps.kron(sps.kron(I, I), T) + sps.kron(sps.kron(I, D), I)
            + sps.kron(sps.kron(D, I), I)).tocsr()


def _csr(A):
    A = A.tocsr()
    A.sort_indices()
    n = A.shape[0]
    return CsrMatrix._from_parts(
        n, n,
        jnp.asarray(A.indptr, dtype=INDEX_DTYPE),
        jnp.asarray(A.indices, dtype=INDEX_DTYPE),
        jnp.asarray(A.data))


def _check_solve(A, *, method, rng, tol=1e-9):
    A = A.tocsr()
    A.sort_indices()
    n = A.shape[0]
    csr = _csr(A)
    b = rng.normal(size=n)
    fac = cholesky(csr, method=method)
    x = np.asarray(cholesky_solve(fac, jnp.asarray(b)))
    xref = spsolve(A.tocsc(), b)
    np.testing.assert_allclose(x, xref, rtol=tol,
                               atol=tol * np.abs(xref).max())
    return fac


class TestSymbolic:
    def test_etree_property(self):
        A = lap2d(10)
        A.sort_indices()
        parent = etree(A.indptr.astype(np.int64),
                       A.indices.astype(np.int64), A.shape[0])
        # parent strictly above the column; roots -1
        for j, p in enumerate(parent):
            assert p == -1 or p > j

    def test_etree_matches_dense_cholesky_structure(self, rng):
        # parent[j] = min row > j of L's column j (dense oracle)
        n = 40
        B = sps.random(n, n, 0.1, random_state=3)
        A = (B @ B.T + n * sps.eye(n)).tocsr()
        A.sort_indices()
        L = np.linalg.cholesky(A.toarray())
        parent = etree(A.indptr.astype(np.int64),
                       A.indices.astype(np.int64), n)
        for j in range(n):
            below = np.flatnonzero(np.abs(L[:, j]) > 1e-12)
            below = below[below > j]
            expect = below.min() if below.size else -1
            assert parent[j] == expect

    def test_postorder_children_first(self):
        A = lap2d(8)
        A.sort_indices()
        parent = etree(A.indptr.astype(np.int64),
                       A.indices.astype(np.int64), A.shape[0])
        post = postorder(parent)
        assert sorted(post) == list(range(A.shape[0]))
        pos = np.empty(A.shape[0], dtype=np.int64)
        pos[post] = np.arange(A.shape[0])
        for j, p in enumerate(parent):
            if p >= 0:
                assert pos[j] < pos[p]

    def test_amd_is_permutation_and_reduces_fill(self):
        A = lap2d(20)
        A.sort_indices()
        n = A.shape[0]
        perm = amd_ordering(_csr(A))
        assert sorted(perm) == list(range(n))

    def test_supernode_columns_partition(self):
        A = lap2d(12)
        A.sort_indices()
        sym = chol_symbolic(A.indptr.astype(np.int64),
                            A.indices.astype(np.int64), A.shape[0])
        assert sym.snode_ptr[0] == 0
        assert sym.snode_ptr[-1] == A.shape[0]
        assert np.all(np.diff(sym.snode_ptr) >= 1)
        # each snode's structure starts with its own columns
        for s in range(sym.nsn):
            struct = sym.rows_idx[sym.rows_ptr[s]:sym.rows_ptr[s + 1]]
            w = sym.snode_ptr[s + 1] - sym.snode_ptr[s]
            np.testing.assert_array_equal(
                struct[:w], np.arange(sym.snode_ptr[s],
                                      sym.snode_ptr[s + 1]))
            assert np.all(np.diff(struct) > 0)


class TestSupernodalCholesky:
    def test_lap2d(self, rng):
        fac = _check_solve(lap2d(16), method="supernodal", rng=rng)
        assert fac.snf is not None

    def test_lap3d(self, rng):
        _check_solve(lap3d(8), method="supernodal", rng=rng)

    def test_random_spd(self, rng):
        B = sps.random(300, 300, 0.02, random_state=1)
        A = (B @ B.T + 10 * sps.eye(300)).tocsr()
        _check_solve(A, method="supernodal", rng=rng)

    def test_no_reorder(self, rng):
        _check_solve(lap2d(12), method="supernodal", rng=rng)
        A = lap2d(12).tocsr()
        csr = _csr(A)
        fac = cholesky(csr, method="supernodal", reorder=False)
        b = rng.normal(size=A.shape[0])
        x = np.asarray(cholesky_solve(fac, jnp.asarray(b)))
        xref = spsolve(A.tocsc(), b)
        np.testing.assert_allclose(x, xref, rtol=1e-9,
                                   atol=1e-9 * np.abs(xref).max())

    def test_multiple_rhs_reuse(self, rng):
        A = lap3d(6).tocsr()
        csr = _csr(A)
        fac = cholesky(csr, method="supernodal")
        for seed in (1, 2):
            b = np.random.default_rng(seed).normal(size=A.shape[0])
            x = np.asarray(cholesky_solve(fac, jnp.asarray(b)))
            xref = spsolve(A.tocsc(), b)
            np.testing.assert_allclose(x, xref, rtol=1e-9,
                                       atol=1e-9 * np.abs(xref).max())

    def test_auto_dispatch_still_correct(self, rng):
        # auto may pick banded or supernodal; answer must match either way
        _check_solve(lap3d(6), method="auto", rng=rng)

    def test_f32_values(self, rng):
        A = lap2d(10).tocsr()
        A.sort_indices()
        n = A.shape[0]
        csr = CsrMatrix._from_parts(
            n, n,
            jnp.asarray(A.indptr, dtype=INDEX_DTYPE),
            jnp.asarray(A.indices, dtype=INDEX_DTYPE),
            jnp.asarray(A.data.astype(np.float32)))
        b = rng.normal(size=n).astype(np.float32)
        fac = cholesky(csr, method="supernodal")
        x = np.asarray(cholesky_solve(fac, jnp.asarray(b)))
        xref = spsolve(A.tocsc(), b.astype(np.float64))
        np.testing.assert_allclose(x, xref, rtol=2e-3,
                                   atol=2e-3 * np.abs(xref).max())


def test_sharded_factor_solve_parity(rng):
    """Distributed numeric factorization (fronts sharded over an
    8-device mesh, GSPMD collectives for the extend-add) must match
    the single-device factor and solve exactly.
    """
    from jax.sharding import Mesh

    from spalinalg.linalg.cholesky import cholesky, permute_csr
    from spalinalg.linalg import supernodal as sn

    k = 20
    n = k * k
    rows, cols, vals = [], [], []
    for i in range(k):
        for j in range(k):
            r = i * k + j
            for (ii, jj, v) in ((i, j, 4.0), (i - 1, j, -1.0),
                                (i + 1, j, -1.0), (i, j - 1, -1.0),
                                (i, j + 1, -1.0)):
                if 0 <= ii < k and 0 <= jj < k:
                    rows.append(r)
                    cols.append(ii * k + jj)
                    vals.append(v)
    order = np.lexsort((cols, rows))
    rowptr = np.zeros(n + 1, np.int64)
    np.add.at(rowptr, np.asarray(rows)[order] + 1, 1)
    np.cumsum(rowptr, out=rowptr)
    csr = CsrMatrix._from_parts(
        n, n, jnp.asarray(rowptr, dtype=INDEX_DTYPE),
        jnp.asarray(np.asarray(cols)[order], dtype=INDEX_DTYPE),
        jnp.asarray(np.asarray(vals, np.float32)[order]))
    fac = cholesky(csr, method="supernodal")
    plan = fac.snf.plan
    pm = permute_csr(csr, fac.perm) if fac.perm is not None else csr
    mesh = Mesh(np.array(jax.devices("cpu")[:8]), ("d",))
    f1 = sn.supernodal_factor(plan, pm.values)
    f2 = sn.supernodal_factor_sharded(plan, pm.values, mesh)
    for key in f1.panels:
        np.testing.assert_allclose(np.asarray(f1.panels[key]),
                                   np.asarray(f2.panels[key]),
                                   rtol=1e-5, atol=1e-5)
    b = rng.normal(size=n).astype(np.float32)
    x1 = np.asarray(sn.supernodal_solve(f1, jnp.asarray(b)))
    x2 = np.asarray(sn.supernodal_solve(f2, jnp.asarray(b)))
    np.testing.assert_allclose(x1, x2, rtol=1e-5, atol=1e-6)


def test_table_views_find_each_plan_array_by_identity():
    """The flat index-table argument is sliced by which plan array is
    asked for, not by the order of the asks: reversed order gives the
    same tables, and an array that is not in the plan is refused."""
    from spalinalg.linalg import supernodal as sn

    A = lap3d(4)
    fac = cholesky(_csr(A), method="supernodal")
    plan = fac.snf.plan
    arrays = list(sn._plan_index_arrays(plan))
    cv = sn._table_views(plan, sn._plan_tables(plan))
    for a in reversed(arrays):
        np.testing.assert_array_equal(np.asarray(cv(a)), np.asarray(a))
    with pytest.raises(KeyError):
        cv(np.zeros(3, np.int64))
