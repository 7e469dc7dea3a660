"""Reductions/diagonal/multiply/norm (`ops/reduce_api.py`). Oracle: scipy."""

import numpy as np
import pytest
import scipy.sparse as sps

from spalinalg import CooMatrix, CsrMatrix
from spalinalg.errors import ShapeError
from spalinalg.io import from_scipy
from spalinalg.ops.reduce_api import (
    diagonal,
    mat_mean,
    mat_sum,
    multiply,
    norm,
)


def _pair(rng, n=7, m=9, density=0.3):
    d = np.where(rng.random((n, m)) < density, rng.normal(size=(n, m)), 0)
    return from_scipy(sps.csr_matrix(d)), d


def test_sum_axes(rng):
    a, d = _pair(rng)
    np.testing.assert_allclose(float(mat_sum(a)), d.sum(), atol=1e-10)
    np.testing.assert_allclose(np.asarray(a.sum(axis=1)), d.sum(axis=1),
                               atol=1e-10)
    np.testing.assert_allclose(np.asarray(a.sum(axis=0)), d.sum(axis=0),
                               atol=1e-10)
    with pytest.raises(ShapeError):
        mat_sum(a, axis=2)


def test_mean(rng):
    a, d = _pair(rng)
    np.testing.assert_allclose(float(mat_mean(a)), d.mean(), atol=1e-10)
    np.testing.assert_allclose(np.asarray(a.mean(axis=1)), d.mean(axis=1),
                               atol=1e-10)


@pytest.mark.parametrize("k", [0, 1, -2, 3])
def test_diagonal(rng, k):
    a, d = _pair(rng, 6, 8)
    np.testing.assert_allclose(np.asarray(diagonal(a, k)), np.diag(d, k),
                               atol=1e-12)


def test_diagonal_out_of_range(rng):
    a, _ = _pair(rng, 3, 3)
    with pytest.raises(ShapeError):
        diagonal(a, 5)


def test_multiply_matches_scipy(rng):
    a, da = _pair(rng)
    b, db = _pair(rng)
    h = multiply(a, b)
    ref = da * db
    np.testing.assert_allclose(np.asarray(h.to_dense()), ref, atol=1e-12)
    # pattern is the intersection: nnz <= min
    assert h.nnz <= min(a.nnz, b.nnz)


def test_multiply_method_and_formats(rng):
    a, da = _pair(rng)
    b, db = _pair(rng)
    np.testing.assert_allclose(
        np.asarray(a.multiply(b.to_csc()).to_dense()), da * db, atol=1e-12)
    with pytest.raises(ShapeError):
        a.multiply(_pair(rng, 3, 3)[0])


def test_norms(rng):
    a, d = _pair(rng)
    np.testing.assert_allclose(float(norm(a)),
                               np.linalg.norm(d, "fro"), atol=1e-10)
    np.testing.assert_allclose(float(a.norm(1)),
                               np.abs(d).sum(axis=0).max(), atol=1e-10)
    np.testing.assert_allclose(float(a.norm(np.inf)),
                               np.abs(d).sum(axis=1).max(), atol=1e-10)
    with pytest.raises(ValueError):
        norm(a, 2)


def test_works_on_all_formats(rng):
    a, d = _pair(rng, 8, 8)
    for m in (a, a.to_csc(), a.to_coo(), a.to_dok(), a.to_bsr(2)):
        np.testing.assert_allclose(float(mat_sum(m)), d.sum(), atol=1e-10)
