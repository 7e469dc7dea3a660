"""Row/column selection and slicing — the `scipy.sparse` indexing
surface (beyond-reference completeness; the reference offers only
whole-matrix iteration).

Discipline: index plans are host NumPy (structure work, once), the value
movement is one device gather. ``row_slice`` on a concrete CSR is pure
pointer arithmetic + array slicing — no copy of untouched rows.

Examples
--------
>>> import numpy as np
>>> from spalinalg import CsrMatrix
>>> from spalinalg.ops.indexing import row_slice, select_rows, submatrix
>>> a = CsrMatrix(3, 3, [0, 2, 3, 5], [0, 2, 1, 0, 2],
...               [1.0, 2.0, 3.0, 4.0, 5.0])
>>> r = row_slice(a, 1, 3)
>>> r.shape, r.nnz
((2, 3), 3)
>>> sel = select_rows(a, [2, 0])            # reorder + select
>>> np.asarray(sel.to_dense()).tolist()[0]
[4.0, 0.0, 5.0]
>>> sub = submatrix(a, [0, 2], [0, 2])
>>> np.asarray(sub.to_dense()).tolist()
[[1.0, 2.0], [4.0, 5.0]]
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

import jax.numpy as jnp

from ..dtypes import INDEX_DTYPE
from ..errors import IndexError_, ShapeError

__all__ = ["row_slice", "select_rows", "select_cols", "submatrix",
           "getrow", "getcol"]


def _csr_of(mat):
    from ..formats.compressed import CsrMatrix

    if isinstance(mat, CsrMatrix):
        return mat
    if hasattr(mat, "to_csr"):
        return mat.to_csr()
    raise ShapeError(f"unsupported operand {type(mat).__name__}")


def row_slice(mat, start: int, stop: int):
    """Rows ``[start, stop)`` as a new CSR — pointer arithmetic only."""
    csr = _csr_of(mat)
    n = csr.nrows
    if not (0 <= start <= stop <= n):
        raise IndexError_(
            f"row slice [{start}, {stop}) out of range for {n} rows")
    ptr = np.asarray(csr._ptr, dtype=np.int64)
    lo, hi = int(ptr[start]), int(ptr[stop])
    new_ptr = ptr[start: stop + 1] - lo
    from ..formats.compressed import CsrMatrix

    return CsrMatrix._from_parts(
        stop - start, csr.ncols,
        jnp.asarray(new_ptr, dtype=INDEX_DTYPE),
        csr._minor[lo:hi],
        csr._values[lo:hi])


def select_rows(mat, rows: Sequence[int]):
    """Rows in the given order (duplicates allowed) — ``A[rows, :]``."""
    csr = _csr_of(mat)
    rows = np.asarray(rows, dtype=np.int64)
    if rows.ndim != 1:
        raise ShapeError("rows must be a 1-D index sequence")
    if rows.size and (rows.min() < 0 or rows.max() >= csr.nrows):
        raise IndexError_(
            f"row index out of range for {csr.nrows} rows")
    ptr = np.asarray(csr._ptr, dtype=np.int64)
    lens = np.diff(ptr)[rows]
    new_ptr = np.concatenate([[0], np.cumsum(lens)])
    # entry gather: for each selected row, its contiguous slot range
    gather = np.concatenate(
        [np.arange(ptr[r], ptr[r + 1]) for r in rows]
    ) if rows.size else np.empty(0, dtype=np.int64)
    g = jnp.asarray(gather, dtype=INDEX_DTYPE)
    from ..formats.compressed import CsrMatrix

    return CsrMatrix._from_parts(
        rows.size, csr.ncols,
        jnp.asarray(new_ptr, dtype=INDEX_DTYPE),
        csr._minor[g],
        csr._values[g])


def select_cols(mat, cols: Sequence[int]):
    """Columns in the given order (duplicates allowed) — ``A[:, cols]``."""
    csr = _csr_of(mat)
    return select_rows(csr.transpose(), cols).transpose()


def submatrix(mat, rows: Sequence[int], cols: Sequence[int]):
    """``A[np.ix_(rows, cols)]`` — row selection then column selection."""
    return select_cols(select_rows(mat, rows), cols)


def getrow(mat, i: int):
    """Row ``i`` as a ``1×ncols`` CSR."""
    return row_slice(mat, i, i + 1)


def getcol(mat, j: int):
    """Column ``j`` as an ``nrows×1`` CSR."""
    csr = _csr_of(mat)
    if not 0 <= j < csr.ncols:
        raise IndexError_(f"column {j} out of range for {csr.ncols}")
    return select_cols(csr, [j])
