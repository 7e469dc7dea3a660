"""Constructors: ``diags``, ``sprandom`` — `scipy.sparse`-style builders
(beyond-reference completeness; the reference's only constructor sugar is
``eye``, mirrored on every format).

Examples
--------
>>> import numpy as np
>>> from spalinalg.ops.construct import diags, sprandom
>>> # 1-D Laplacian in one call
>>> L = diags([-1.0, 2.0, -1.0], offsets=[-1, 0, 1], shape=(4, 4))
>>> np.asarray(L.to_dense()).tolist()[1]
[-1.0, 2.0, -1.0, 0.0]
>>> r = sprandom(100, 80, density=0.05, seed=0)
>>> r.shape
(100, 80)
>>> 300 <= r.nnz <= 500          # ~400 expected
True
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import numpy as np

from ..errors import ShapeError
from .structure import _build_csr

__all__ = ["diags", "sprandom"]


def diags(diagonals, offsets: Union[int, Sequence[int]] = 0,
          shape: Optional[Tuple[int, int]] = None, *, dtype=np.float64):
    """Build a CSR matrix from diagonals (matching `scipy.sparse.diags`).

    ``diagonals``: one array per offset — scalars broadcast along their
    diagonal. Without ``shape``, the matrix is the smallest square that
    holds every diagonal.
    """
    if np.isscalar(offsets):
        offsets = [int(offsets)]
        diagonals = [diagonals]
    offsets = [int(o) for o in offsets]
    if len(diagonals) != len(offsets):
        raise ShapeError(
            f"{len(diagonals)} diagonals for {len(offsets)} offsets")
    diagonals = [np.atleast_1d(np.asarray(d, dtype=dtype))
                 for d in diagonals]

    if shape is None:
        n = max(len(d) + abs(o) if d.size > 1 else abs(o) + 1
                for d, o in zip(diagonals, offsets))
        shape = (n, n)
    nrows, ncols = shape
    if nrows <= 0 or ncols <= 0:
        raise ShapeError(f"matrix dimensions must be positive, got {shape}")

    rows_l, cols_l, vals_l = [], [], []
    for d, o in zip(diagonals, offsets):
        length = min(nrows + min(o, 0), ncols - max(o, 0))
        if length <= 0:
            raise ShapeError(
                f"offset {o} lies outside a {nrows}x{ncols} matrix")
        if d.size == 1:
            d = np.broadcast_to(d, (length,))
        elif d.size < length:
            raise ShapeError(
                f"diagonal for offset {o} has {d.size} < {length} entries")
        else:
            d = d[:length]
        r = np.arange(length, dtype=np.int64) - min(o, 0)
        c = np.arange(length, dtype=np.int64) + max(o, 0)
        rows_l.append(r)
        cols_l.append(c)
        vals_l.append(np.asarray(d, dtype=dtype))
    return _build_csr(nrows, ncols, np.concatenate(rows_l),
                      np.concatenate(cols_l), np.concatenate(vals_l),
                      dedup=True)


def sprandom(nrows: int, ncols: int, density: float = 0.01, *,
             seed: Optional[int] = None, rng=None, dtype=np.float64,
             values: str = "normal"):
    """Random sparse CSR matrix (matching `scipy.sparse.random`).

    Exactly ``round(density * nrows * ncols)`` distinct positions,
    sampled without replacement; ``values``: "normal" or "uniform".
    """
    if nrows <= 0 or ncols <= 0:
        raise ShapeError(
            f"matrix dimensions must be positive, got {nrows}x{ncols}")
    if not 0 <= density <= 1:
        raise ShapeError(f"density must be in [0, 1], got {density}")
    rng = rng if rng is not None else np.random.default_rng(seed)
    nnz = int(round(density * nrows * ncols))
    flat = rng.choice(nrows * ncols, size=nnz, replace=False)
    rows, cols = np.divmod(flat.astype(np.int64), ncols)
    if values == "normal":
        vals = rng.normal(size=nnz).astype(dtype)
    elif values == "uniform":
        vals = rng.random(size=nnz).astype(dtype)
    else:
        raise ValueError(f"values must be 'normal' or 'uniform', "
                         f"got {values!r}")
    return _build_csr(nrows, ncols, rows, cols, vals)
