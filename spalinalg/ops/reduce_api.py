"""Matrix reductions + elementwise products: ``sum``/``mean``/``norm``/
``diagonal``/``multiply`` — the `scipy.sparse` query surface
(beyond-reference completeness).

Device discipline: axis reductions are SpMV against a ones vector (the
row/column sums ARE matvecs — they ride the same scatter-free pipeline);
``diagonal`` is a host-planned gather; ``multiply`` (Hadamard) is a
host sort-merge intersection (structure work, like the conversion
engine's host path) with device-resident output values.

Examples
--------
>>> import numpy as np
>>> from spalinalg import CsrMatrix
>>> from spalinalg.ops.reduce_api import diagonal, mat_sum, multiply, norm
>>> a = CsrMatrix(2, 3, [0, 2, 3], [0, 2, 1], [1.0, 2.0, 3.0])
>>> float(mat_sum(a))
6.0
>>> [float(v) for v in mat_sum(a, axis=1)]
[3.0, 3.0]
>>> [float(v) for v in diagonal(a)]
[1.0, 3.0]
>>> b = CsrMatrix(2, 3, [0, 1, 3], [0, 0, 1], [10.0, 5.0, 4.0])
>>> h = multiply(a, b)              # Hadamard: intersection of patterns
>>> h.nnz, [float(v) for v in h.values]
(2, [10.0, 12.0])
>>> round(float(norm(a)), 6)        # Frobenius
3.741657
"""

from __future__ import annotations

from typing import Optional, Union

import numpy as np

import jax
import jax.numpy as jnp

from ..dtypes import INDEX_DTYPE
from ..errors import ShapeError

__all__ = ["mat_sum", "mat_mean", "diagonal", "multiply", "norm"]


def _as_csr(mat):
    from ..formats.compressed import CscMatrix, CsrMatrix
    from ..formats.coo import CooMatrix
    from ..formats.dok import DokMatrix
    from ..formats.bsr import BsrMatrix

    if isinstance(mat, CsrMatrix):
        return mat
    if isinstance(mat, CscMatrix):
        return mat.to_csr()
    if isinstance(mat, BsrMatrix):
        return mat.to_csr()
    if isinstance(mat, CooMatrix):
        return CsrMatrix.from_coo(mat)
    if isinstance(mat, DokMatrix):
        from ..convert.conversions import dok_to_csr

        return dok_to_csr(mat)
    raise ShapeError(f"unsupported operand {type(mat).__name__}")


def mat_sum(mat, axis: Optional[int] = None) -> jax.Array:
    """``sum(A)`` (axis None), row sums (axis 1) or column sums (axis 0).

    Axis reductions are SpMV against ones — the scatter-free pipeline.
    """
    csr = _as_csr(mat)
    if axis is None:
        return jnp.sum(csr.values)
    if axis == 1:
        return csr @ jnp.ones(csr.ncols, dtype=csr.values.dtype)
    if axis == 0:
        return csr.transpose() @ jnp.ones(csr.nrows, dtype=csr.values.dtype)
    raise ShapeError(f"axis must be None, 0 or 1, got {axis}")


def mat_mean(mat, axis: Optional[int] = None) -> jax.Array:
    """Mean over all positions (dense denominator, scipy semantics)."""
    csr = _as_csr(mat)
    s = mat_sum(csr, axis)
    if axis is None:
        return s / (csr.nrows * csr.ncols)
    return s / (csr.ncols if axis == 1 else csr.nrows)


def diagonal(mat, k: int = 0) -> jax.Array:
    """The ``k``-th diagonal as a dense device vector (scipy semantics:
    absent entries are zeros)."""
    csr = _as_csr(mat)
    nrows, ncols = csr.shape
    length = min(nrows + min(k, 0), ncols - max(k, 0))
    if length <= 0:
        raise ShapeError(f"diagonal {k} outside a {nrows}x{ncols} matrix")
    ptr = np.asarray(csr._ptr, dtype=np.int64)
    ind = np.asarray(csr._minor, dtype=np.int64)[: int(ptr[-1])]
    rows = np.repeat(np.arange(nrows, dtype=np.int64), np.diff(ptr))
    hit = ind - rows == k
    # host gather plan: slot per diagonal position (default -> zero pad)
    pos = rows[hit] - max(-k, 0)
    src = np.nonzero(hit)[0]
    gather = np.full(length, int(ptr[-1]), dtype=np.int64)  # pad slot
    gather[pos] = src
    vals = jnp.concatenate([
        csr.values[: int(ptr[-1])],
        jnp.zeros(1, dtype=csr.values.dtype)])
    return vals[jnp.asarray(gather, dtype=INDEX_DTYPE)]


def multiply(a, b):
    """Elementwise (Hadamard) product — pattern intersection, CSR output.

    Host sort-merge on linearised keys (structure work), device product
    of the matched value slices. Note the reference's ``*`` operator is
    SpGEMM (`csr/ops/mul.rs`); scipy's ``A.multiply(B)`` is this.
    """
    ca, cb = _as_csr(a), _as_csr(b)
    if ca.shape != cb.shape:
        raise ShapeError(f"shape mismatch {ca.shape} vs {cb.shape}")
    from ..formats.compressed import CsrMatrix

    def keys(c):
        ptr = np.asarray(c._ptr, dtype=np.int64)
        ind = np.asarray(c._minor, dtype=np.int64)[: int(ptr[-1])]
        rows = np.repeat(np.arange(c.nrows, dtype=np.int64), np.diff(ptr))
        return rows * c.ncols + ind, ptr

    ka, pa = keys(ca)
    kb, pb = keys(cb)
    common, ia, ib = np.intersect1d(ka, kb, assume_unique=True,
                                    return_indices=True)
    rows = (common // ca.ncols).astype(np.int64)
    cols = (common % ca.ncols).astype(np.int64)
    new_ptr = np.zeros(ca.nrows + 1, dtype=np.int64)
    np.add.at(new_ptr, rows + 1, 1)
    np.cumsum(new_ptr, out=new_ptr)
    vals = (ca.values[jnp.asarray(ia, dtype=INDEX_DTYPE)]
            * cb.values[jnp.asarray(ib, dtype=INDEX_DTYPE)])
    return CsrMatrix._from_parts(
        ca.nrows, ca.ncols,
        jnp.asarray(new_ptr, dtype=INDEX_DTYPE),
        jnp.asarray(cols, dtype=INDEX_DTYPE),
        vals)


def norm(mat, ord: Union[str, int, float] = "fro") -> jax.Array:
    """Matrix norm: "fro" (default), 1 (max column abs-sum) or
    ``inf`` (max row abs-sum) — `scipy.sparse.linalg.norm` semantics."""
    csr = _as_csr(mat)
    nnz = int(np.asarray(csr._ptr)[-1])
    vals = csr.values[:nnz]
    if ord in ("fro", "f"):
        return jnp.sqrt(jnp.sum(vals * vals))
    absmat = csr._from_parts(csr.nrows, csr.ncols, csr._ptr, csr._minor,
                             jnp.abs(csr.values))
    if ord == 1:
        return jnp.max(mat_sum(absmat, axis=0))
    if ord in (np.inf, float("inf"), "inf"):
        return jnp.max(mat_sum(absmat, axis=1))
    raise ValueError(f"unsupported norm ord {ord!r}")
