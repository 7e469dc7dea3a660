"""BSR structural ops: transpose, add/sub, scalar mul. Oracle: scipy."""

import numpy as np
import pytest
import scipy.sparse as sps

import jax.numpy as jnp

from spalinalg import BsrMatrix, CooMatrix, CsrMatrix
from spalinalg.errors import ShapeError


def _bsr(rng, n=32, m=48, bs=8, density=0.15):
    d = np.where(rng.random((n, m)) < density, rng.normal(size=(n, m)), 0)
    d = d.astype(np.float64)
    rows, cols = np.nonzero(d)
    csr = CsrMatrix.from_coo(CooMatrix.with_triplets(
        n, m, rows.tolist(), cols.tolist(), d[rows, cols].tolist()))
    return csr.to_bsr(bs), d


def test_transpose(rng):
    a, d = _bsr(rng)
    t = a.transpose()
    assert t.shape == (48, 32)
    assert t.blocksize == (8, 8)
    np.testing.assert_allclose(np.asarray(t.to_dense()), d.T, atol=1e-12)
    np.testing.assert_allclose(np.asarray(a.T.T.to_dense()), d, atol=1e-12)


def test_transpose_rect_blocks(rng):
    a, d = _bsr(rng, 32, 64, bs=8)
    # build a (8, 16) blocked version through from_csr? blocksize must be
    # square there; exercise rectangular via transpose of transpose shape
    t = a.transpose()
    y = np.asarray(t @ np.ones(32))
    np.testing.assert_allclose(y, d.T @ np.ones(32), atol=1e-10)


def test_add_sub_union(rng):
    a, da = _bsr(rng)
    b, db = _bsr(rng)
    s = a + b
    np.testing.assert_allclose(np.asarray(s.to_dense()), da + db,
                               atol=1e-12)
    np.testing.assert_allclose(np.asarray((a - b).to_dense()), da - db,
                               atol=1e-12)
    # union pattern: block count bounded by sum
    assert s.n_blocks <= a.n_blocks + b.n_blocks


def test_add_matches_scipy_bsr(rng):
    a, da = _bsr(rng)
    b, db = _bsr(rng)
    ref = (sps.bsr_matrix(da, blocksize=(8, 8))
           + sps.bsr_matrix(db, blocksize=(8, 8))).toarray()
    np.testing.assert_allclose(np.asarray((a + b).to_dense()), ref,
                               atol=1e-12)


def test_scalar_mul(rng):
    a, d = _bsr(rng)
    np.testing.assert_allclose(np.asarray((a * 2.5).to_dense()), d * 2.5,
                               atol=1e-12)
    np.testing.assert_allclose(np.asarray((0.5 * a).to_dense()), d * 0.5,
                               atol=1e-12)


def test_validation(rng):
    a, _ = _bsr(rng, 32, 48, bs=8)
    b, _ = _bsr(rng, 48, 32, bs=8)
    with pytest.raises(ShapeError):
        a + b
    c, _ = _bsr(rng, 32, 48, bs=16)
    with pytest.raises(ShapeError):
        a + c
