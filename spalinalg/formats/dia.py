"""DIA (diagonal) format — storage for banded/stencil matrices
(beyond-reference; `scipy.sparse.dia_matrix` peer).

SpMV needs **no indices at all**: ``y = Σ_d data[d] * shift(x, offset_d)``
— one elementwise multiply-add per stored diagonal with a statically
shifted operand window. Zero gathers, zero scatter, zero host planning;
XLA fuses the whole thing into one streaming pass that reads each
diagonal once, so banded SpMV needs no hand-written kernel.

Storage convention (row-aligned): ``data[k, i] = A[i, i + offsets[k]]``
for the in-range part of row ``i``; out-of-range slots are zero.
(`scipy.sparse.dia_matrix` aligns by column — converters translate.)

Examples
--------
>>> import numpy as np
>>> from spalinalg import CsrMatrix, DiaMatrix
>>> A = DiaMatrix.from_diagonals([-1.0, 2.0, -1.0], [-1, 0, 1], 4)
>>> np.asarray(A @ np.ones(4)).tolist()
[1.0, 0.0, 0.0, 1.0]
>>> A.shape, A.nnz
((4, 4), 10)
>>> csr = A.to_csr()
>>> back = DiaMatrix.from_csr(csr)
>>> np.allclose(np.asarray(back.to_dense()), np.asarray(A.to_dense()))
True
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

import jax
import jax.numpy as jnp

from ..dtypes import INDEX_DTYPE
from ..errors import ShapeError

__all__ = ["DiaMatrix"]


class DiaMatrix:
    """Diagonal-storage sparse matrix (square or rectangular)."""

    __slots__ = ("_nrows", "_ncols", "_offsets", "_data")

    def __init__(self, nrows: int, ncols: int, offsets: Sequence[int],
                 data: jax.Array):
        nrows, ncols = int(nrows), int(ncols)
        if nrows <= 0 or ncols <= 0:
            raise ShapeError(
                f"matrix dimensions must be positive, got {nrows}x{ncols}")
        offsets = np.asarray(offsets, dtype=np.int64).reshape(-1)
        if np.unique(offsets).size != offsets.size:
            raise ShapeError("duplicate diagonal offsets")
        data = jnp.asarray(data)
        if data.ndim != 2 or data.shape[0] != offsets.size:
            raise ShapeError(
                f"data must be ({offsets.size}, nrows), got {data.shape}")
        if data.shape[1] != nrows:
            raise ShapeError(
                f"row-aligned data needs {nrows} columns, got "
                f"{data.shape[1]}")
        if offsets.size and (offsets.min() <= -nrows
                             or offsets.max() >= ncols):
            raise ShapeError("diagonal offset outside the matrix")
        self._nrows, self._ncols = nrows, ncols
        self._offsets = offsets
        self._data = data

    # ---- constructors ----

    @classmethod
    def from_diagonals(cls, diagonals, offsets, n, *, ncols=None,
                       dtype=np.float64) -> "DiaMatrix":
        """Build from per-diagonal scalars/arrays (like ``diags``)."""
        ncols = int(ncols) if ncols is not None else int(n)
        if np.isscalar(offsets):
            offsets, diagonals = [int(offsets)], [diagonals]
        offs = [int(o) for o in offsets]
        if len(diagonals) != len(offs):
            raise ShapeError(
                f"{len(diagonals)} diagonals for {len(offs)} offsets")
        rows = []
        for d, o in zip(diagonals, offs):
            row = np.zeros(n, dtype=dtype)
            length = min(n + min(o, 0), ncols - max(o, 0))
            if length <= 0:
                raise ShapeError(
                    f"offset {o} outside a {n}x{ncols} matrix")
            lo = max(-o, 0)
            d = np.asarray(d, dtype=dtype)
            dv = (np.broadcast_to(d, (length,)) if d.size == 1
                  else d[:length])
            if dv.size < length:
                raise ShapeError(
                    f"diagonal for offset {o} has {dv.size} < {length} "
                    f"entries")
            row[lo: lo + length] = dv
            rows.append(row)
        return cls(n, ncols, offs, jnp.asarray(np.stack(rows)))

    @classmethod
    def from_csr(cls, csr) -> "DiaMatrix":
        """CSR → DIA (host structure pass; errors if impractically many
        distinct diagonals — over ``max(64, band)`` — would densify)."""
        ptr = np.asarray(csr._ptr, dtype=np.int64)
        ind = np.asarray(csr._minor, dtype=np.int64)[: int(ptr[-1])]
        val = np.asarray(csr._values)[: int(ptr[-1])]
        n, m = csr.shape
        rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(ptr))
        offs = np.unique(ind - rows)
        if offs.size > max(64, int(offs.max(initial=0)
                                   - offs.min(initial=0)) + 1):
            raise ShapeError("structure not diagonal-sparse")
        data = np.zeros((offs.size, n), dtype=val.dtype)
        k = np.searchsorted(offs, ind - rows)
        data[k, rows] = val
        return cls(n, m, offs, jnp.asarray(data))

    # ---- properties ----

    @property
    def shape(self) -> Tuple[int, int]:
        return (self._nrows, self._ncols)

    @property
    def nrows(self) -> int:
        return self._nrows

    @property
    def ncols(self) -> int:
        return self._ncols

    @property
    def offsets(self) -> np.ndarray:
        return self._offsets

    @property
    def data(self) -> jax.Array:
        return self._data

    @property
    def dtype(self):
        return self._data.dtype

    @property
    def nnz(self) -> int:
        """Stored slots that are structurally in range (incl. explicit
        zeros on the diagonals — DIA stores whole diagonals)."""
        total = 0
        for o in self._offsets:
            total += min(self._nrows + min(o, 0),
                         self._ncols - max(o, 0))
        return int(total)

    # ---- compute ----

    def _matvec(self, x: jax.Array) -> jax.Array:
        n, m = self._nrows, self._ncols
        lo = int(-min(self._offsets.min(initial=0), 0))
        hi = int(max(self._offsets.max(initial=0) + n - m, 0)) + n
        pad_spec = [(lo, max(hi - m, 0))] + [(0, 0)] * (x.ndim - 1)
        xp = jnp.pad(x, pad_spec)
        y = jnp.zeros((n,) + x.shape[1:],
                      dtype=jnp.result_type(self._data.dtype, x.dtype))
        for k, o in enumerate(self._offsets):
            seg = jax.lax.dynamic_slice_in_dim(xp, int(o) + lo, n, axis=0)
            d = self._data[k]
            y = y + (d[:, None] if x.ndim == 2 else d) * seg
        return y

    def __matmul__(self, other):
        other = jnp.asarray(other) if not isinstance(
            other, jax.core.Tracer) else other
        if other.ndim in (1, 2):
            if other.shape[0] != self._ncols:
                raise ShapeError(
                    f"operand length {other.shape[0]} != ncols "
                    f"{self._ncols}")
            from ..utils.metrics import instrument

            nnz = self.nnz
            itm = jnp.dtype(self.dtype).itemsize
            return instrument("dia_spmv", lambda: self._matvec(other),
                              nnz=nnz, flops=2 * nnz, bytes=itm * nnz)
        return NotImplemented

    # ---- conversions / export ----

    def to_csr(self):
        from ..convert.engine import compress_host
        from ..formats.compressed import CsrMatrix

        n, m = self._nrows, self._ncols
        data = np.asarray(self._data)
        rows_l, cols_l, vals_l = [], [], []
        for k, o in enumerate(self._offsets):
            i0 = max(-o, 0)
            length = min(n + min(o, 0), m - max(o, 0))
            r = np.arange(i0, i0 + length, dtype=np.int64)
            rows_l.append(r)
            cols_l.append(r + o)
            vals_l.append(data[k, i0: i0 + length])
        rows = np.concatenate(rows_l) if rows_l else np.empty(0, np.int64)
        cols = np.concatenate(cols_l) if cols_l else np.empty(0, np.int64)
        vals = (np.concatenate(vals_l) if vals_l
                else np.empty(0, data.dtype))
        ptr, minor, values = compress_host(rows, cols, vals, n,
                                           dedup=False, drop_zeros=False)
        return CsrMatrix._from_parts(
            n, m,
            jnp.asarray(ptr, dtype=INDEX_DTYPE),
            jnp.asarray(minor, dtype=INDEX_DTYPE),
            jnp.asarray(values))

    def to_dense(self) -> jax.Array:
        return self.to_csr().to_dense()

    def transpose(self) -> "DiaMatrix":
        """Transpose: offsets negate; row-aligned data re-aligns with a
        static shift per diagonal (no gathers)."""
        n, m = self._nrows, self._ncols
        data = np.asarray(self._data)
        new = np.zeros((self._offsets.size, m), dtype=data.dtype)
        for k, o in enumerate(self._offsets):
            i0 = max(-o, 0)
            length = min(n + min(o, 0), m - max(o, 0))
            # entry (i, i+o) -> row i+o of the transpose, offset -o
            new[k, i0 + o: i0 + o + length] = data[k, i0: i0 + length]
        return DiaMatrix(m, n, -self._offsets, jnp.asarray(new))

    @property
    def T(self) -> "DiaMatrix":
        return self.transpose()

    def __repr__(self) -> str:
        return (f"DiaMatrix(shape={self.shape}, "
                f"n_diags={self._offsets.size}, dtype={self.dtype})")
