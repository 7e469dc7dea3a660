"""BSR: block-sparse-row format (north-star N4; absent from the reference).

Nonzero structure is tracked at the granularity of dense ``(br, bc)``
blocks, so SpMV/SpMM decompose into batched dense block products — no
per-element gathers. The natural format for banded/stencil operators (BASELINE
config[1]/[3]) and the fast path for factorization panels.

Layout:
- ``indptr``  (n_block_rows + 1,) int32 — block-row pointer
- ``indices`` (n_blocks,)         int32 — block-column index per block
- ``data``    (n_blocks, br, bc)  values — dense blocks

Matrix dims must be divisible by the block size (callers pad; see
:meth:`from_csr` which zero-pads implicitly dropped fractional blocks is a
hard error instead — explicit is better than silent padding).

Examples
--------
>>> import numpy as np
>>> from spalinalg import BsrMatrix, CsrMatrix
>>> csr = CsrMatrix(4, 4, [0, 2, 4, 6, 8],
...                 [0, 1, 0, 1, 2, 3, 2, 3],
...                 [1., 2., 3., 4., 5., 6., 7., 8.])
>>> bsr = BsrMatrix.from_csr(csr, 2)
>>> bsr.n_blocks
2
>>> bsr.blocksize
(2, 2)
>>> [float(v) for v in bsr @ np.ones(4)]
[3.0, 7.0, 11.0, 15.0]
>>> eye = BsrMatrix.eye(4, blocksize=2)
>>> [float(v) for v in eye @ np.arange(4.0)]
[0.0, 1.0, 2.0, 3.0]
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

import jax
import jax.numpy as jnp

from ..dtypes import INDEX_DTYPE
from ..errors import ShapeError, StructureError

__all__ = ["BsrMatrix"]


@jax.tree_util.register_pytree_node_class
class BsrMatrix:
    """Block-sparse-row matrix (device pytree)."""

    __slots__ = ("_indptr", "_indices", "_data", "_nrows", "_ncols", "_br", "_bc")

    def __init__(self, nrows, ncols, blocksize, indptr, indices, data):
        nrows, ncols = int(nrows), int(ncols)
        br, bc = (blocksize, blocksize) if np.isscalar(blocksize) else blocksize
        br, bc = int(br), int(bc)
        if nrows <= 0 or ncols <= 0:
            raise ShapeError(f"matrix dimensions must be positive, got {nrows}x{ncols}")
        if nrows % br or ncols % bc:
            raise ShapeError(
                f"shape {nrows}x{ncols} not divisible by block size {br}x{bc}"
            )
        concrete = not any(
            isinstance(x, jax.core.Tracer) for x in (indptr, indices, data)
        )
        if concrete:
            ip = np.asarray(indptr)
            ix = np.asarray(indices)
            dt = np.asarray(data)
            if ip.size != nrows // br + 1 or ip[0] != 0:
                raise StructureError(
                    f"indptr must have length {nrows // br + 1} and start at 0"
                )
            if np.any(np.diff(ip) < 0):
                raise StructureError("indptr must be monotonically non-decreasing")
            if ix.size and (ix.min() < 0 or ix.max() >= ncols // bc):
                raise StructureError(
                    f"block column indices must be in [0, {ncols // bc})"
                )
            if dt.shape != (ix.size, br, bc):
                raise StructureError(
                    f"data must have shape {(ix.size, br, bc)}, got {dt.shape}"
                )
            indptr = jnp.asarray(ip, dtype=INDEX_DTYPE)
            indices = jnp.asarray(ix, dtype=INDEX_DTYPE)
            data = jnp.asarray(dt)
        self._nrows, self._ncols, self._br, self._bc = nrows, ncols, br, bc
        self._indptr, self._indices, self._data = indptr, indices, data

    # ---- pytree ----

    def tree_flatten(self):
        return (self._indptr, self._indices, self._data), (
            self._nrows, self._ncols, self._br, self._bc,
        )

    @classmethod
    def tree_unflatten(cls, aux, children):
        nrows, ncols, br, bc = aux
        obj = object.__new__(cls)
        obj._nrows, obj._ncols, obj._br, obj._bc = nrows, ncols, br, bc
        obj._indptr, obj._indices, obj._data = children
        return obj

    @classmethod
    def _from_parts(cls, nrows, ncols, br, bc, indptr, indices, data):
        obj = object.__new__(cls)
        obj._nrows, obj._ncols, obj._br, obj._bc = int(nrows), int(ncols), int(br), int(bc)
        obj._indptr, obj._indices, obj._data = indptr, indices, data
        return obj

    # ---- accessors ----

    @property
    def nrows(self) -> int:
        return self._nrows

    @property
    def ncols(self) -> int:
        return self._ncols

    @property
    def shape(self) -> Tuple[int, int]:
        return (self._nrows, self._ncols)

    @property
    def blocksize(self) -> Tuple[int, int]:
        return (self._br, self._bc)

    @property
    def indptr(self) -> jax.Array:
        return self._indptr

    @property
    def indices(self) -> jax.Array:
        return self._indices

    @property
    def data(self) -> jax.Array:
        return self._data

    @property
    def dtype(self):
        return self._data.dtype

    @property
    def n_blocks(self) -> int:
        return int(self._indices.shape[0])

    @property
    def nnz(self) -> int:
        """Stored scalar entries (block granularity: n_blocks * br * bc)."""
        return self.n_blocks * self._br * self._bc

    # ---- construction ----

    @classmethod
    def eye(cls, size: int, blocksize: int = 8, *, dtype=np.float64) -> "BsrMatrix":
        if size % blocksize:
            raise ShapeError(f"size {size} not divisible by blocksize {blocksize}")
        nb = size // blocksize
        indptr = jnp.arange(nb + 1, dtype=INDEX_DTYPE)
        indices = jnp.arange(nb, dtype=INDEX_DTYPE)
        data = jnp.broadcast_to(
            jnp.eye(blocksize, dtype=dtype), (nb, blocksize, blocksize)
        )
        return cls._from_parts(size, size, blocksize, blocksize, indptr, indices, data)

    @classmethod
    def from_csr(cls, csr, blocksize) -> "BsrMatrix":
        """Convert CSR → BSR on the host (structure work, once)."""
        br, bc = (blocksize, blocksize) if np.isscalar(blocksize) else blocksize
        if csr.nrows % br or csr.ncols % bc:
            raise ShapeError(
                f"shape {csr.shape} not divisible by block size {br}x{bc}"
            )
        rows, cols, vals = csr._coo_arrays_host()
        brow, bcol = rows // br, cols // bc
        key = brow * (csr.ncols // bc) + bcol
        order = np.argsort(key, kind="stable")
        key_s = key[order]
        uniq, first = np.unique(key_s, return_index=True)
        block_of = np.searchsorted(uniq, key)  # block slot per entry
        n_blocks = uniq.size
        data = np.zeros((n_blocks, br, bc), dtype=np.asarray(vals).dtype)
        data[block_of, rows % br, cols % bc] = vals
        ub_row = (uniq // (csr.ncols // bc)).astype(np.int64)
        ub_col = (uniq % (csr.ncols // bc)).astype(np.int64)
        indptr = np.zeros(csr.nrows // br + 1, dtype=np.int64)
        np.add.at(indptr, ub_row + 1, 1)
        np.cumsum(indptr, out=indptr)
        return cls._from_parts(
            csr.nrows, csr.ncols, br, bc,
            jnp.asarray(indptr, dtype=INDEX_DTYPE),
            jnp.asarray(ub_col, dtype=INDEX_DTYPE),
            jnp.asarray(data),
        )

    def to_csr(self):
        """BSR → CSR on host, dropping explicit zero fill inside blocks is
        NOT done (stored zeros stay stored, matching compressed-format
        conversion semantics elsewhere) — except fully absent blocks which
        were never stored."""
        from .compressed import CsrMatrix
        from ..convert.engine import compress_host

        ip = np.asarray(self._indptr, dtype=np.int64)
        ix = np.asarray(self._indices, dtype=np.int64)
        dat = np.asarray(self._data)
        br, bc = self._br, self._bc
        n_blocks = ix.size
        brow = np.repeat(np.arange(ip.size - 1, dtype=np.int64), np.diff(ip))
        rr = (brow[:, None, None] * br
              + np.arange(br, dtype=np.int64)[None, :, None])
        cc = (ix[:, None, None] * bc
              + np.arange(bc, dtype=np.int64)[None, None, :])
        rows = np.broadcast_to(rr, (n_blocks, br, bc)).ravel()
        cols = np.broadcast_to(cc, (n_blocks, br, bc)).ravel()
        vals = dat.ravel()
        ptr, minor, values = compress_host(
            rows, cols, vals, self._nrows, dedup=False, drop_zeros=False
        )
        return CsrMatrix._from_parts(
            self._nrows, self._ncols,
            jnp.asarray(ptr, dtype=INDEX_DTYPE),
            jnp.asarray(minor, dtype=INDEX_DTYPE),
            jnp.asarray(values),
        )

    def to_dense(self) -> jax.Array:
        nbr = self._nrows // self._br
        nbc = self._ncols // self._bc
        from ..convert.engine import major_ids_device

        brow = major_ids_device(self._indptr, self.n_blocks)
        valid = brow < nbr
        brow_c = jnp.where(valid, brow, 0)
        dense = jnp.zeros((nbr, nbc, self._br, self._bc), dtype=self.dtype)
        dense = dense.at[brow_c, self._indices].add(
            jnp.where(valid[:, None, None], self._data, 0)
        )
        return dense.transpose(0, 2, 1, 3).reshape(self._nrows, self._ncols)

    # ---- compute ----

    def __matmul__(self, other):
        from ..ops import bsr_ops

        other = jnp.asarray(other) if not isinstance(other, jax.core.Tracer) else other
        if other.ndim == 1:
            return bsr_ops.bsr_matvec(self, other)
        if other.ndim == 2:
            return bsr_ops.bsr_matmat(self, other)
        return NotImplemented

    def with_data(self, data: jax.Array) -> "BsrMatrix":
        if data.shape != self._data.shape:
            raise ShapeError(
                f"data shape must stay {self._data.shape}, got {data.shape}"
            )
        return BsrMatrix._from_parts(
            self._nrows, self._ncols, self._br, self._bc,
            self._indptr, self._indices, data,
        )

    def transpose(self) -> "BsrMatrix":
        """Block-level transpose: the block pattern transposes through a
        host lexsort (structure work, once) and the data moves with ONE
        device gather + per-block transpose (``(nb, br, bc) ->
        (nb, bc, br)``)."""
        nbr = self._nrows // self._br
        nbc = self._ncols // self._bc
        ip = np.asarray(self._indptr, dtype=np.int64)
        ic = np.asarray(self._indices, dtype=np.int64)
        brow = np.repeat(np.arange(nbr, dtype=np.int64), np.diff(ip))
        order = np.lexsort((brow, ic))           # sort by (bcol, brow)
        new_ptr = np.zeros(nbc + 1, dtype=np.int64)
        np.add.at(new_ptr, ic + 1, 1)
        np.cumsum(new_ptr, out=new_ptr)
        g = jnp.asarray(order, dtype=INDEX_DTYPE)
        return BsrMatrix._from_parts(
            self._ncols, self._nrows, self._bc, self._br,
            jnp.asarray(new_ptr, dtype=INDEX_DTYPE),
            jnp.asarray(brow[order], dtype=INDEX_DTYPE),
            self._data[g].transpose(0, 2, 1))

    @property
    def T(self) -> "BsrMatrix":
        return self.transpose()

    def _union_add(self, other: "BsrMatrix", sign: float) -> "BsrMatrix":
        """Block-pattern union merge; numeric phase is two gathers (each
        union slot pulls its source block or a zero pad) — scatter-free."""
        if self.shape != other.shape:
            raise ShapeError(
                f"shape mismatch {self.shape} vs {other.shape}")
        if self.blocksize != other.blocksize:
            raise ShapeError(
                f"blocksize mismatch {self.blocksize} vs {other.blocksize}")
        nbr = self._nrows // self._br

        def keys(m):
            ip = np.asarray(m._indptr, dtype=np.int64)
            ic = np.asarray(m._indices, dtype=np.int64)
            br_ = np.repeat(np.arange(nbr, dtype=np.int64), np.diff(ip))
            return br_ * (m._ncols // m._bc) + ic

        ka, kb = keys(self), keys(other)
        union = np.union1d(ka, kb)
        # source slot per union key (pad slot = own n_blocks)
        pos_a = np.searchsorted(union, ka)
        pos_b = np.searchsorted(union, kb)
        src_a = np.full(union.size, self.n_blocks, dtype=np.int64)
        src_b = np.full(union.size, other.n_blocks, dtype=np.int64)
        src_a[pos_a] = np.arange(ka.size)
        src_b[pos_b] = np.arange(kb.size)
        nbc = self._ncols // self._bc
        rows_u = union // nbc
        cols_u = union % nbc
        new_ptr = np.zeros(nbr + 1, dtype=np.int64)
        np.add.at(new_ptr, rows_u + 1, 1)
        np.cumsum(new_ptr, out=new_ptr)
        zpad = jnp.zeros((1, self._br, self._bc), dtype=self._data.dtype)
        da = jnp.concatenate([self._data, zpad])[
            jnp.asarray(src_a, dtype=INDEX_DTYPE)]
        db = jnp.concatenate([other._data.astype(self._data.dtype), zpad])[
            jnp.asarray(src_b, dtype=INDEX_DTYPE)]
        return BsrMatrix._from_parts(
            self._nrows, self._ncols, self._br, self._bc,
            jnp.asarray(new_ptr, dtype=INDEX_DTYPE),
            jnp.asarray(cols_u, dtype=INDEX_DTYPE),
            da + sign * db)

    def __add__(self, other):
        if isinstance(other, BsrMatrix):
            return self._union_add(other, +1.0)
        return NotImplemented

    def __sub__(self, other):
        if isinstance(other, BsrMatrix):
            return self._union_add(other, -1.0)
        return NotImplemented

    def __mul__(self, other):
        if np.isscalar(other):
            return self.with_data(self._data * other)
        return NotImplemented

    __rmul__ = __mul__

    def astype(self, dtype) -> "BsrMatrix":
        """Cast block storage (e.g. ``jnp.bfloat16`` to halve HBM value
        traffic — the streaming kernel accumulates in f32 regardless, so
        SpMV keeps f32-grade output up to the bf16 rounding of A)."""
        return self.with_data(self._data.astype(dtype))

    def __neg__(self) -> "BsrMatrix":
        return self.with_data(-self._data)

    def __repr__(self) -> str:
        return (
            f"BsrMatrix(shape={self.shape}, blocksize={self.blocksize}, "
            f"n_blocks={self.n_blocks}, dtype={self.dtype})"
        )
