"""SpGEMM numeric phase (XLA gather + sorted segment_sum) against scipy:
random and power-law structures, wide output rows, value updates on a
fixed plan, and gradients through both operands' values."""

import numpy as np
import pytest
import scipy.sparse as sps

import jax
import jax.numpy as jnp

from spalinalg import CsrMatrix, spgemm_apply, spgemm_plan


def _csr(A):
    A = A.tocsr()
    A.sum_duplicates()
    A.sort_indices()
    return CsrMatrix(*A.shape, A.indptr, A.indices, A.data)


def _ref_values(A, B, plan):
    """scipy's product scattered onto the plan's structure (the plan keeps
    cancellation zeros that scipy drops)."""
    C = (A @ B).tocsr()
    C.sort_indices()
    rp = np.asarray(plan.rowptr)
    ci = np.asarray(plan.colind)
    dense_rows = np.repeat(np.arange(plan.nrows), np.diff(rp))
    return np.asarray(C[dense_rows, ci]).ravel()


@pytest.mark.parametrize("dtype,tol", [(np.float32, 2e-5),
                                       (np.float64, 1e-12)])
@pytest.mark.parametrize("n,seed", [(64, 0), (200, 1), (500, 2)])
def test_random_product_matches_scipy(n, seed, dtype, tol):
    A = sps.random(n, n, 0.05, random_state=seed, dtype=np.float64)
    B = sps.random(n, n, 0.05, random_state=seed + 10, dtype=np.float64)
    A, B = A.astype(dtype), B.astype(dtype)
    a, b = _csr(A), _csr(B)
    c = a * b
    ref = (A.astype(np.float64) @ B.astype(np.float64)).tocsr()
    ref.sort_indices()
    np.testing.assert_array_equal(np.asarray(c.rowptr), ref.indptr)
    np.testing.assert_array_equal(np.asarray(c.colind)[: c.nnz],
                                  ref.indices)
    scale = np.abs(ref.data).max()
    np.testing.assert_allclose(np.asarray(c.values)[: c.nnz] / scale,
                               ref.data / scale, atol=tol)


@pytest.mark.parametrize("dtype,tol", [(np.float32, 2e-5),
                                       (np.float64, 1e-12)])
def test_power_law_square(rng, dtype, tol):
    n = 2048
    deg = np.minimum(rng.zipf(1.8, size=n), 256)
    rows = np.repeat(np.arange(n), deg)
    cols = rng.integers(0, n, size=rows.size)
    A = sps.csr_matrix((rng.normal(size=rows.size), (rows, cols)),
                       shape=(n, n)).astype(dtype)
    a = _csr(A)
    plan = spgemm_plan(a, a)
    vals = np.asarray(spgemm_apply(plan, a.values, a.values))
    ref = _ref_values(A.astype(np.float64), A.astype(np.float64), plan)
    np.testing.assert_allclose(vals / np.abs(ref).max(),
                               ref / np.abs(ref).max(), atol=tol)


def test_wide_output_rows(rng):
    """A dense row times a dense column block: output rows thousands
    wide, reduced from many terms each."""
    n = 1500
    A = sps.lil_matrix((n, n))
    A[3, :] = rng.normal(size=n)
    A[:, 5] = rng.normal(size=(n, 1))
    A = A.tocsr()
    a = _csr(A)
    c = a * a
    ref = (A @ A).toarray()
    np.testing.assert_allclose(np.asarray(c.to_dense()), ref, atol=1e-10)
    assert int(np.diff(np.asarray(c.rowptr)).max()) >= n - 1


def test_fresh_values_reuse_plan(rng):
    A = sps.random(300, 300, 0.03, random_state=5)
    a = _csr(A)
    plan = spgemm_plan(a, a)
    v2 = jnp.asarray(rng.normal(size=a.nnz))
    got = np.asarray(spgemm_apply(plan, v2, v2))
    A2 = sps.csr_matrix((np.asarray(v2), A.tocsr().indices,
                         A.tocsr().indptr), shape=A.shape)
    np.testing.assert_allclose(got, _ref_values(A2, A2, plan), atol=1e-12)


def test_grad_through_values(rng):
    A = sps.random(120, 90, 0.08, random_state=8).tocsr()
    B = sps.random(90, 110, 0.08, random_state=9).tocsr()
    a, b = _csr(A), _csr(B)
    plan = spgemm_plan(a, b)
    w = jnp.asarray(rng.normal(size=plan.n_out))

    def loss(av, bv):
        return jnp.vdot(w, spgemm_apply(plan, av, bv))

    ga, gb = jax.grad(loss, argnums=(0, 1))(a.values, b.values)
    # d loss / d A[i,k] = sum_j W[i,j] B[k,j]  (W on C's structure)
    rp = np.asarray(plan.rowptr)
    W = sps.csr_matrix((np.asarray(w), np.asarray(plan.colind), rp),
                       shape=(120, 110)).toarray()
    dA = W @ B.toarray().T
    dB = A.toarray().T @ W
    ar = np.repeat(np.arange(120), np.diff(A.indptr))
    br = np.repeat(np.arange(90), np.diff(B.indptr))
    np.testing.assert_allclose(np.asarray(ga), dA[ar, A.indices],
                               atol=1e-12)
    np.testing.assert_allclose(np.asarray(gb), dB[br, B.indices],
                               atol=1e-12)
