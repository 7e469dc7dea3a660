"""Structural composition ops: ``kron``, ``hstack``, ``vstack``,
``block_diag``, ``bmat`` — the `scipy.sparse` construction toolkit
(beyond-reference completeness; the reference builds matrices only
entry-by-entry).

All are **index arithmetic on host COO views** followed by one pass
through the device conversion engine — O(nnz) vectorised NumPy, no
Python-per-entry loops. Outputs are CSR (the compute-format default);
convert as needed.

Examples
--------
>>> import numpy as np
>>> from spalinalg import CsrMatrix
>>> from spalinalg.ops.structure import block_diag, hstack, kron, vstack
>>> a = CsrMatrix.eye(2)
>>> b = CsrMatrix(1, 2, [0, 2], [0, 1], [3.0, 4.0])
>>> vstack([a, b]).shape
(3, 2)
>>> hstack([a, a]).shape
(2, 4)
>>> block_diag([a, b]).shape
(3, 4)
>>> k = kron(a, b)                    # I_2 (x) b
>>> k.shape, k.nnz
((2, 4), 4)
>>> np.asarray(k.to_dense())[0].tolist()
[3.0, 4.0, 0.0, 0.0]
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

import jax.numpy as jnp

from ..dtypes import INDEX_DTYPE
from ..errors import ShapeError

__all__ = ["kron", "hstack", "vstack", "block_diag", "bmat", "tril", "triu"]


def _coo_view(mat):
    """(rows, cols, vals) int64/np view of any format's true entries."""
    from ..formats.compressed import CscMatrix, CsrMatrix
    from ..formats.coo import CooMatrix
    from ..formats.dok import DokMatrix
    from ..formats.bsr import BsrMatrix

    if isinstance(mat, BsrMatrix):
        mat = mat.to_csr()
    if isinstance(mat, (CsrMatrix, CscMatrix)):
        r, c, v = mat._coo_arrays_host()
    elif isinstance(mat, (CooMatrix, DokMatrix)):
        r, c, v = mat.to_arrays()
    else:
        raise ShapeError(f"unsupported operand {type(mat).__name__}")
    return (np.asarray(r, dtype=np.int64), np.asarray(c, dtype=np.int64),
            np.asarray(v))


def _build_csr(nrows, ncols, rows, cols, vals, *, dedup=False):
    from ..convert.engine import compress_host
    from ..formats.compressed import CsrMatrix

    ptr, minor, values = compress_host(
        rows, cols, vals, nrows, dedup=dedup, drop_zeros=False)
    return CsrMatrix._from_parts(
        nrows, ncols,
        jnp.asarray(ptr, dtype=INDEX_DTYPE),
        jnp.asarray(minor, dtype=INDEX_DTYPE),
        jnp.asarray(values))


def kron(a, b):
    """Kronecker product ``a ⊗ b`` (CSR output).

    nnz = nnz_a · nnz_b; index arithmetic is fully vectorised
    (outer-sum of scaled indices), matching `scipy.sparse.kron`.
    """
    ar, ac, av = _coo_view(a)
    br, bc, bv = _coo_view(b)
    am, an = a.shape
    bm, bn = b.shape
    rows = (ar[:, None] * bm + br[None, :]).ravel()
    cols = (ac[:, None] * bn + bc[None, :]).ravel()
    vals = (av[:, None] * bv[None, :]).ravel()
    # duplicate (row,col) pairs are possible iff a or b holds COO
    # duplicates; dedup-sum keeps scipy semantics
    return _build_csr(am * bm, an * bn, rows, cols, vals, dedup=True)


def vstack(mats: Sequence):
    """Stack matrices vertically (matching column counts)."""
    mats = list(mats)
    if not mats:
        raise ShapeError("vstack needs at least one matrix")
    ncols = mats[0].shape[1]
    rows_l, cols_l, vals_l = [], [], []
    off = 0
    for m in mats:
        if m.shape[1] != ncols:
            raise ShapeError(
                f"vstack column mismatch: {m.shape[1]} != {ncols}")
        r, c, v = _coo_view(m)
        rows_l.append(r + off)
        cols_l.append(c)
        vals_l.append(v)
        off += m.shape[0]
    return _build_csr(off, ncols, np.concatenate(rows_l),
                      np.concatenate(cols_l), np.concatenate(vals_l))


def hstack(mats: Sequence):
    """Stack matrices horizontally (matching row counts)."""
    mats = list(mats)
    if not mats:
        raise ShapeError("hstack needs at least one matrix")
    nrows = mats[0].shape[0]
    rows_l, cols_l, vals_l = [], [], []
    off = 0
    for m in mats:
        if m.shape[0] != nrows:
            raise ShapeError(
                f"hstack row mismatch: {m.shape[0]} != {nrows}")
        r, c, v = _coo_view(m)
        rows_l.append(r)
        cols_l.append(c + off)
        vals_l.append(v)
        off += m.shape[1]
    return _build_csr(nrows, off, np.concatenate(rows_l),
                      np.concatenate(cols_l), np.concatenate(vals_l))


def block_diag(mats: Sequence):
    """Block-diagonal composition."""
    mats = list(mats)
    if not mats:
        raise ShapeError("block_diag needs at least one matrix")
    rows_l, cols_l, vals_l = [], [], []
    roff = coff = 0
    for m in mats:
        r, c, v = _coo_view(m)
        rows_l.append(r + roff)
        cols_l.append(c + coff)
        vals_l.append(v)
        roff += m.shape[0]
        coff += m.shape[1]
    return _build_csr(roff, coff, np.concatenate(rows_l),
                      np.concatenate(cols_l), np.concatenate(vals_l))


def bmat(blocks):
    """Assemble from a 2-D grid of blocks (``None`` = zero block).

    Row heights / column widths are inferred from the present blocks;
    every position must be resolvable (matching `scipy.sparse.bmat`).
    """
    grid = [list(row) for row in blocks]
    if not grid or not grid[0]:
        raise ShapeError("bmat needs a non-empty 2-D grid")
    R, C = len(grid), len(grid[0])
    if any(len(row) != C for row in grid):
        raise ShapeError("bmat rows must have equal length")

    heights = [None] * R
    widths = [None] * C
    for i in range(R):
        for j in range(C):
            m = grid[i][j]
            if m is None:
                continue
            h, w = m.shape
            if heights[i] is None:
                heights[i] = h
            elif heights[i] != h:
                raise ShapeError(
                    f"bmat block ({i},{j}) height {h} != {heights[i]}")
            if widths[j] is None:
                widths[j] = w
            elif widths[j] != w:
                raise ShapeError(
                    f"bmat block ({i},{j}) width {w} != {widths[j]}")
    if any(h is None for h in heights) or any(w is None for w in widths):
        raise ShapeError("bmat has an all-None row or column")

    rowoff = np.concatenate([[0], np.cumsum(heights)])
    coloff = np.concatenate([[0], np.cumsum(widths)])
    rows_l, cols_l, vals_l = [], [], []
    for i in range(R):
        for j in range(C):
            m = grid[i][j]
            if m is None:
                continue
            r, c, v = _coo_view(m)
            rows_l.append(r + rowoff[i])
            cols_l.append(c + coloff[j])
            vals_l.append(v)
    return _build_csr(int(rowoff[-1]), int(coloff[-1]),
                      np.concatenate(rows_l), np.concatenate(cols_l),
                      np.concatenate(vals_l))


def tril(mat, k: int = 0):
    """Lower triangle: entries with ``col <= row + k`` (CSR output).

    `scipy.sparse.tril` semantics. A vectorised structural filter on the
    host COO view — one boolean mask, one conversion-engine pass. COO
    duplicate triplets are dedup-summed so the CSR invariants hold.

    >>> from spalinalg import CsrMatrix
    >>> from spalinalg.ops.structure import tril
    >>> a = CsrMatrix(2, 2, [0, 2, 4], [0, 1, 0, 1], [1., 2., 3., 4.])
    >>> tril(a).to_dense().tolist()
    [[1.0, 0.0], [3.0, 4.0]]
    >>> tril(a, k=-1).to_dense().tolist()
    [[0.0, 0.0], [3.0, 0.0]]
    """
    r, c, v = _coo_view(mat)
    keep = c <= r + int(k)
    return _build_csr(mat.shape[0], mat.shape[1],
                      r[keep], c[keep], v[keep], dedup=True)


def triu(mat, k: int = 0):
    """Upper triangle: entries with ``col >= row + k`` (CSR output).

    `scipy.sparse.triu` semantics; see :func:`tril`.

    >>> from spalinalg import CsrMatrix
    >>> from spalinalg.ops.structure import triu
    >>> a = CsrMatrix(2, 2, [0, 2, 4], [0, 1, 0, 1], [1., 2., 3., 4.])
    >>> triu(a, k=1).to_dense().tolist()
    [[0.0, 2.0], [0.0, 0.0]]
    """
    r, c, v = _coo_view(mat)
    keep = c >= r + int(k)
    return _build_csr(mat.shape[0], mat.shape[1],
                      r[keep], c[keep], v[keep], dedup=True)
