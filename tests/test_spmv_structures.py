"""CSR/CSC SpMV and SpMM against scipy over structures that stress the
row reduction: skewed, empty, wide and single-column rows, wide column
ranges, heavy overflow of the bucket plan's widest bucket. Each case runs
the host-planned bucket path (concrete structure) and the ``segment_sum``
path (structure traced under a user jit), in f32 and f64."""

import numpy as np
import pytest
import scipy.sparse as sps

import jax
import jax.numpy as jnp

from spalinalg import CsrMatrix
from spalinalg.dtypes import INDEX_DTYPE
from spalinalg.ops import matvec as mv


def _random(rng):
    return sps.random(700, 900, 0.02, random_state=7)


def _uniform_rows(rng):
    n = 2048
    cols = np.sort(rng.integers(0, n, size=(n, 16)), axis=1)
    return sps.csr_matrix((rng.normal(size=n * 16), cols.reshape(-1),
                           np.arange(n + 1) * 16), shape=(n, n))


def _banded(rng):
    return sps.diags([-1.0, 4.0, -1.0], [-1, 0, 1], shape=(3000, 3000))


def _skewed(rng):
    lens = np.minimum(rng.zipf(1.7, size=1000), 500)
    ind = [np.sort(rng.choice(1200, size=int(k), replace=False))
           for k in lens]
    ptr = np.concatenate([[0], np.cumsum([len(i) for i in ind])])
    return sps.csr_matrix((rng.normal(size=ptr[-1]), np.concatenate(ind),
                           ptr), shape=(1000, 1200))


def _overflow_heavy(rng):
    # rows far past the plan's widest bucket (512): chunked and reduced
    # over two levels
    n, m = 1024, 32768
    lens = np.minimum(rng.zipf(1.6, size=n) * 4, 2000)
    ind = [np.sort(rng.choice(m, size=int(k), replace=False)) for k in lens]
    ptr = np.concatenate([[0], np.cumsum([len(i) for i in ind])])
    return sps.csr_matrix((rng.normal(size=ptr[-1]), np.concatenate(ind),
                           ptr), shape=(n, m))


def _hot_column(rng):
    return sps.csr_matrix((np.ones(800), (np.arange(800),
                                          np.zeros(800, int))),
                          shape=(800, 60))


def _wide_columns(rng):
    return sps.random(600, 40000, 0.001, random_state=3)


def _empty(rng):
    return sps.csr_matrix((64, 64))


def _shared_columns(rng):
    cols = np.sort(rng.integers(0, 4, size=(500, 3)) + np.arange(3) * 4,
                   axis=1)
    return sps.csr_matrix((rng.normal(size=1500), cols.reshape(-1),
                           np.arange(501) * 3), shape=(500, 16))


def _one_wide_row(rng):
    rows = np.concatenate([np.full(5000, 7), np.arange(0, 200, 3)])
    cols = np.concatenate([rng.choice(6000, 5000, replace=False),
                           np.arange(0, 200, 3)])
    return sps.csr_matrix((rng.normal(size=rows.size), (rows, cols)),
                          shape=(200, 6000))


STRUCTURES = {
    "random": _random, "uniform_rows": _uniform_rows, "banded": _banded,
    "skewed": _skewed, "overflow_heavy": _overflow_heavy,
    "hot_column": _hot_column, "wide_columns": _wide_columns,
    "empty": _empty, "shared_columns": _shared_columns,
    "one_wide_row": _one_wide_row,
}
TOL = {np.float32: 2e-5, np.float64: 1e-12}


def _case(name, dtype, seed=0):
    rng = np.random.default_rng(seed)
    A = STRUCTURES[name](rng).tocsr().astype(dtype)
    A.sum_duplicates()
    A.sort_indices()
    csr = CsrMatrix(*A.shape, A.indptr, A.indices, A.data)
    return A, csr, rng


def _close(got, ref, dtype):
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    scale = max(float(np.abs(ref).max(initial=0.0)), 1.0)
    np.testing.assert_allclose(got / scale, ref / scale, atol=TOL[dtype])


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("name", sorted(STRUCTURES))
def test_spmv_bucket_plan(name, dtype):
    A, csr, rng = _case(name, dtype)
    x = rng.normal(size=A.shape[1]).astype(dtype)
    assert mv.csr_path(csr) == "bucket_plan"
    y = csr @ jnp.asarray(x)
    assert y.dtype == dtype
    _close(y, A.astype(np.float64) @ x.astype(np.float64), dtype)


@pytest.mark.parametrize("name", sorted(STRUCTURES))
def test_spmm_bucket_plan(name):
    A, csr, rng = _case(name, np.float32)
    X = rng.normal(size=(A.shape[1], 8)).astype(np.float32)
    _close(csr @ jnp.asarray(X), A.astype(np.float64) @ X, np.float32)


@pytest.mark.parametrize("name", sorted(STRUCTURES))
def test_csc_spmv(name):
    A, csr, rng = _case(name, np.float64)
    x = rng.normal(size=A.shape[1])
    _close(csr.to_csc() @ jnp.asarray(x), A @ x, np.float64)


@pytest.mark.parametrize("name", sorted(STRUCTURES))
def test_spmv_traced_structure(name):
    """Under a user jit the structure is a tracer: the ``segment_sum``
    formulation runs and must agree with scipy."""
    A, csr, rng = _case(name, np.float32)
    x = rng.normal(size=A.shape[1]).astype(np.float32)
    paths = []

    @jax.jit
    def f(m, v):
        paths.append(mv.csr_path(m))
        return m @ v

    _close(f(csr, jnp.asarray(x)), A.astype(np.float64) @ x, np.float32)
    assert paths == ["segment_sum"]


def _small(rng, n=400):
    A = sps.random(n, n, 0.02, random_state=21).tocsr()
    A.sort_indices()
    return A


def test_values_update_reuses_plan(rng):
    A = _small(rng)
    csr = CsrMatrix(400, 400, A.indptr, A.indices, A.data.astype(np.float32))
    x = jnp.ones(400, jnp.float32)
    _ = csr @ x
    n_plans = len(mv._ROW_PLAN_CACHE)
    v2 = rng.normal(size=A.nnz).astype(np.float32)
    y2 = np.asarray(csr.with_values(jnp.asarray(v2)) @ x)
    assert len(mv._ROW_PLAN_CACHE) == n_plans      # same structure
    A2 = sps.csr_matrix((v2, A.indices, A.indptr), shape=(400, 400))
    np.testing.assert_allclose(y2, A2 @ np.ones(400), rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("K", [None, 4])
def test_grad_through_values_and_x(rng, K):
    A = _small(rng, 300)
    rows = np.repeat(np.arange(300), np.diff(A.indptr))
    shape = (300,) if K is None else (300, K)
    x = jnp.asarray(rng.normal(size=shape))
    w = jnp.asarray(rng.normal(size=shape))

    def loss(vals, xx):
        m = CsrMatrix._from_parts(
            300, 300, jnp.asarray(A.indptr, dtype=INDEX_DTYPE),
            jnp.asarray(A.indices, dtype=INDEX_DTYPE), vals)
        return jnp.sum(w * (m @ xx))

    gv, gx = jax.grad(loss, argnums=(0, 1))(jnp.asarray(A.data), x)
    wx = np.asarray(w)[rows] * np.asarray(x)[A.indices]
    gv_ref = wx if K is None else wx.sum(axis=1)
    np.testing.assert_allclose(np.asarray(gv), gv_ref, atol=1e-12)
    np.testing.assert_allclose(np.asarray(gx), A.T @ np.asarray(w),
                               atol=1e-12)


def test_plans_stay_concrete_under_outer_trace(rng):
    """Building the cached row plan while an outer jit traces must not
    capture that trace's tracers in the cache."""
    A = _small(rng, 300)
    csr = CsrMatrix(300, 300, A.indptr, A.indices, A.data.astype(np.float32))
    mv._ROW_PLAN_CACHE.clear()
    built = {}

    def f(x):
        built["row"] = mv._row_plan(csr)
        return csr @ x

    jax.make_jaxpr(f)(jnp.ones(300, jnp.float32))
    for leaf in jax.tree_util.tree_leaves(
            [lvl.inv_perm for lvl in built["row"].levels]
            + [g for lvl in built["row"].levels for _, g in lvl.buckets]):
        assert not isinstance(leaf, jax.core.Tracer)
    x = rng.normal(size=300).astype(np.float32)
    np.testing.assert_allclose(np.asarray(csr @ jnp.asarray(x)),
                               A @ x, rtol=2e-4, atol=2e-5)
