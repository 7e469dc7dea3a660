"""Elementwise ops on compressed formats: add, sub, neg (reference:
`src/csr/ops/{add,sub,neg}.rs`, `src/csc/ops/{add,sub,neg}.rs`).

The reference computes sorted-output sparse add/sub with a
transpose→Gustavson-merge→transpose sandwich plus a stamp-set workspace
(`csr/ops/add.rs:5-77`). Semantics to preserve (SURVEY.md §2.1):

- output = structural **union** of the operands' stored entries;
- a sum that cancels to exact zero stays as an explicit stored zero
  (the reference's dense accumulator writes it back);
- output indices sorted and unique;
- shapes must match (`csr/ops/add.rs:9-10`).

Design: concatenate the operands triplet-wise and run the sort/segment
engine with ``dedup=True, drop_zeros=False``. No transposes, no workspace.
The reference's leftover ``dbg!`` prints (`csr/ops/add.rs:14-15`) and the
CSC-sub workspace sizing bug (`csc/ops/sub.rs:22-23`) are, naturally, not
reproduced.

Eager (concrete) operands take the exact host path — output ``nse`` equals
the true union nnz, matching reference capacity exactness. Traced operands
take the static-shape device path with ``nse = nse_a + nse_b`` and sentinel
padding.

Examples
--------
>>> from spalinalg import CsrMatrix
>>> a = CsrMatrix.eye(2)
>>> b = CsrMatrix(2, 2, [0, 1, 2], [1, 0], [5.0, -6.0])
>>> s = a + b
>>> s.nnz                          # structural union
4
>>> [float(v) for v in (a - a).values]   # cancelled zeros are KEPT
[0.0, 0.0]
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp

from ..convert.engine import (
    compress_device,
    compress_host,
    major_ids_device,
)
from ..dtypes import INDEX_DTYPE
from ..errors import ShapeError

__all__ = ["compressed_add"]


def _is_concrete(mat) -> bool:
    return not any(
        isinstance(leaf, jax.core.Tracer)
        for leaf in (mat._ptr, mat._minor, mat._values)
    )


def compressed_add(a, b, *, sign: int):
    """``a + sign*b`` for CSR/CSC with reference union semantics."""
    if a.shape != b.shape:
        raise ShapeError(
            f"shape mismatch {a.shape} vs {b.shape} "
            "(reference: csr/ops/add.rs:9-10)"
        )
    cls = type(a)
    n_major = cls._major_dim(a.nrows, a.ncols)
    n_minor = cls._minor_dim(a.nrows, a.ncols)

    if _is_concrete(a) and _is_concrete(b):
        # Exact host path (eager API, reference-parity sizes).
        pa, ma, va = (np.asarray(a._ptr, dtype=np.int64),
                      np.asarray(a._minor, dtype=np.int64),
                      np.asarray(a._values))
        pb, mb, vb = (np.asarray(b._ptr, dtype=np.int64),
                      np.asarray(b._minor, dtype=np.int64),
                      np.asarray(b._values))
        nnz_a, nnz_b = int(pa[-1]), int(pb[-1])
        maj_a = np.repeat(np.arange(n_major, dtype=np.int64), np.diff(pa))
        maj_b = np.repeat(np.arange(n_major, dtype=np.int64), np.diff(pb))
        major = np.concatenate([maj_a, maj_b])
        minor = np.concatenate([ma[:nnz_a], mb[:nnz_b]])
        values = np.concatenate([va[:nnz_a], sign * vb[:nnz_b]])
        ptr, minor, values = compress_host(
            major, minor, values, n_major, dedup=True, drop_zeros=False
        )
        return cls._from_parts(
            a.nrows, a.ncols,
            jnp.asarray(ptr, dtype=INDEX_DTYPE),
            jnp.asarray(minor, dtype=INDEX_DTYPE),
            jnp.asarray(values),
        )

    # Device path: static nse_a + nse_b output with sentinel padding.
    maj_a = major_ids_device(a._ptr, a.nse)
    maj_b = major_ids_device(b._ptr, b.nse)
    major = jnp.concatenate([maj_a, maj_b])
    minor = jnp.concatenate([a._minor, b._minor])
    values = jnp.concatenate([a._values, sign * b._values])
    ptr, minor, values = compress_device(
        major, minor, values,
        n_major=n_major, n_minor=n_minor,
        dedup=True, drop_zeros=False,
    )
    return cls._from_parts(a.nrows, a.ncols, ptr, minor, values)
