"""Device-resident COO: the jit-side triplet representation.

``CooMatrix`` is the host builder (amortised pushes); ``DeviceCoo`` is its
frozen device image — three ``jax.Array`` leaves + static shape — used when
triplets must flow through jit (conversion engine inputs, distributed
scatter construction). Padding follows the engine convention: sentinel
``row == nrows``, zero values.

Examples
--------
>>> from spalinalg import CooMatrix, DeviceCoo
>>> coo = CooMatrix.with_entries(2, 2, [(0, 0, 1.0), (1, 1, 2.0),
...                                     (0, 0, 3.0)])
>>> dev = DeviceCoo.from_host(coo)
>>> dev.nse
3
>>> csr = dev.to_csr_device()        # dedups: (0,0) -> 4.0
>>> [float(v) for v in csr.values]   # static nse keeps a padding slot
[4.0, 2.0, 0.0]
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

import jax
import jax.numpy as jnp

from ..dtypes import INDEX_DTYPE
from ..errors import ShapeError

__all__ = ["DeviceCoo"]


@jax.tree_util.register_pytree_node_class
class DeviceCoo:
    """Immutable triplet matrix on device (pytree)."""

    __slots__ = ("_rows", "_cols", "_vals", "_nrows", "_ncols")

    def __init__(self, nrows, ncols, rows, cols, vals):
        if int(nrows) <= 0 or int(ncols) <= 0:
            raise ShapeError(
                f"matrix dimensions must be positive, got {nrows}x{ncols}"
            )
        self._nrows, self._ncols = int(nrows), int(ncols)
        concrete = not any(
            isinstance(a, jax.core.Tracer) for a in (rows, cols, vals)
        )
        if concrete:
            rows = jnp.asarray(rows, dtype=INDEX_DTYPE)
            cols = jnp.asarray(cols, dtype=INDEX_DTYPE)
            vals = jnp.asarray(vals)
        self._rows, self._cols, self._vals = rows, cols, vals

    def tree_flatten(self):
        return (self._rows, self._cols, self._vals), (self._nrows, self._ncols)

    @classmethod
    def tree_unflatten(cls, aux, children):
        obj = object.__new__(cls)
        obj._nrows, obj._ncols = aux
        obj._rows, obj._cols, obj._vals = children
        return obj

    @classmethod
    def from_host(cls, coo) -> "DeviceCoo":
        rows, cols, vals = coo.to_arrays()
        return cls(coo.nrows, coo.ncols, rows, cols, vals)

    # ---- accessors ----

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
    def rows(self) -> jax.Array:
        return self._rows

    @property
    def cols(self) -> jax.Array:
        return self._cols

    @property
    def values(self) -> jax.Array:
        return self._vals

    @property
    def nse(self) -> int:
        return int(self._rows.shape[0])

    def nnz_device(self) -> jax.Array:
        """Count of non-sentinel entries (trace-safe)."""
        return jnp.sum((self._rows < self._nrows).astype(jnp.int32))

    # ---- compute / conversion (jit-able) ----

    def to_csr_device(self, *, dedup: bool = True, drop_zeros: bool = True):
        """Compress on device (static nse, sentinel padding) — the jit-side
        equivalent of ``CsrMatrix.from_coo`` (reference semantics when
        ``dedup`` and ``drop_zeros`` are left on)."""
        from ..convert.engine import compress_device
        from .compressed import CsrMatrix

        ptr, minor, values = compress_device(
            self._rows, self._cols, self._vals,
            n_major=self._nrows, n_minor=self._ncols,
            dedup=dedup, drop_zeros=drop_zeros,
        )
        return CsrMatrix._from_parts(self._nrows, self._ncols, ptr, minor,
                                     values)

    def to_host(self):
        from .coo import CooMatrix

        rows = np.asarray(self._rows)
        cols = np.asarray(self._cols)
        vals = np.asarray(self._vals)
        keep = rows < self._nrows
        return CooMatrix.with_triplets(
            self._nrows, self._ncols, rows[keep], cols[keep], vals[keep],
            dtype=vals.dtype,
        )

    def __matmul__(self, x):
        """SpMV/SpMM straight off triplets (unsorted scatter — prefer
        converting to CSR for repeated products)."""
        acc = self._vals.dtype
        safe_r = jnp.clip(self._rows, 0, self._nrows - 1)
        safe_c = jnp.clip(self._cols, 0, self._ncols - 1)
        live = (self._rows < self._nrows)
        prod = jnp.where(live, self._vals, 0) * jnp.take(x, safe_c, axis=0).T
        if x.ndim == 1:
            return jnp.zeros(self._nrows, acc).at[safe_r].add(prod)
        return jnp.zeros((self._nrows, x.shape[1]), acc).at[safe_r].add(prod.T)

    def __repr__(self) -> str:
        return f"DeviceCoo(shape={self.shape}, nse={self.nse})"
