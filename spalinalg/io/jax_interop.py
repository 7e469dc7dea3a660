"""`jax.experimental.sparse` bridges (BCOO/BCSR).

Ecosystem interop: lets spalinalg matrices flow into JAX's sparse
primitives (`sparsify`, BCOO-grad pipelines) and lets users bring BCOO
operands into this framework's kernel/solver tiers. Device-to-device —
the index/value buffers are reused or converted on device, no host
round-trip for already-sorted inputs.

Examples
--------
>>> import numpy as np
>>> from spalinalg import CsrMatrix
>>> from spalinalg.io import from_bcoo, to_bcoo
>>> m = CsrMatrix(2, 3, [0, 2, 3], [0, 2, 1], [1.0, 2.0, 3.0])
>>> bc = to_bcoo(m)
>>> bc.shape, int(bc.nse)
((2, 3), 3)
>>> back = from_bcoo(bc)
>>> type(back).__name__, back.nnz
('CsrMatrix', 3)
>>> np.allclose(np.asarray(back.to_dense()), np.asarray(m.to_dense()))
True
"""

from __future__ import annotations

import jax.numpy as jnp

from ..dtypes import INDEX_DTYPE
from ..errors import ShapeError

__all__ = ["from_bcoo", "to_bcoo", "to_bcsr"]


def to_bcoo(mat):
    """Any spalinalg format → ``jax.experimental.sparse.BCOO``.

    CSR/CSC expand their pointer arrays on device; COO/DOK go through
    their array views. The BCOO is marked unique (all formats guarantee
    unique indices except raw COO, which may hold duplicates and is
    exported as-is with ``unique_indices=False``).
    """
    from jax.experimental import sparse as jsparse

    from ..formats.compressed import CscMatrix, CsrMatrix
    from ..formats.coo import CooMatrix
    from ..formats.dok import DokMatrix
    from ..formats.bsr import BsrMatrix

    if isinstance(mat, DokMatrix):
        from ..convert.conversions import dok_to_coo

        mat = dok_to_coo(mat)
    if isinstance(mat, BsrMatrix):
        mat = mat.to_csr()
    if isinstance(mat, CooMatrix):
        rows, cols, vals = mat.to_arrays()
        idx = jnp.stack([jnp.asarray(rows, dtype=INDEX_DTYPE),
                         jnp.asarray(cols, dtype=INDEX_DTYPE)], axis=1)
        return jsparse.BCOO((jnp.asarray(vals), idx),
                            shape=mat.shape, unique_indices=False)
    if isinstance(mat, (CsrMatrix, CscMatrix)):
        from ..convert.engine import major_ids_device

        nse = mat._minor.shape[0]
        major = major_ids_device(mat._ptr, nse)
        if isinstance(mat, CsrMatrix):
            rows, cols = major, mat._minor
        else:
            rows, cols = mat._minor, major
        idx = jnp.stack([rows.astype(INDEX_DTYPE),
                         cols.astype(INDEX_DTYPE)], axis=1)
        return jsparse.BCOO(
            (mat._values, idx), shape=mat.shape,
            unique_indices=True,
            indices_sorted=isinstance(mat, CsrMatrix))
    raise ShapeError(f"cannot export {type(mat).__name__} to BCOO")


def to_bcsr(mat):
    """CSR → ``jax.experimental.sparse.BCSR`` (zero-copy index reuse)."""
    from jax.experimental import sparse as jsparse

    from ..formats.compressed import CsrMatrix

    if not isinstance(mat, CsrMatrix):
        raise ShapeError(
            f"to_bcsr takes a CsrMatrix, got {type(mat).__name__} "
            f"(convert first)")
    return jsparse.BCSR(
        (mat._values, mat._minor.astype(INDEX_DTYPE),
         mat._ptr.astype(INDEX_DTYPE)),
        shape=mat.shape)


def from_bcoo(bc, *, dedup: bool = True):
    """``BCOO`` → :class:`CsrMatrix` through the device conversion engine.

    Duplicate indices are summed when ``dedup`` (BCOO semantics for
    unsorted batches); explicit zeros are kept (matching DOK→CSR rather
    than COO→CSR semantics, since BCOO nse is structural).
    """
    from ..convert.engine import compress_device
    from ..formats.compressed import CsrMatrix

    if bc.ndim != 2 or getattr(bc, "n_batch", 0) or getattr(bc, "n_dense", 0):
        raise ShapeError(
            f"only plain 2-D BCOO supported, got ndim={bc.ndim}, "
            f"n_batch={getattr(bc, 'n_batch', 0)}, "
            f"n_dense={getattr(bc, 'n_dense', 0)}")
    nrows, ncols = bc.shape
    rows = bc.indices[:, 0].astype(INDEX_DTYPE)
    cols = bc.indices[:, 1].astype(INDEX_DTYPE)
    ptr, minor, values = compress_device(
        rows, cols, bc.data, n_major=nrows, n_minor=ncols,
        dedup=dedup, drop_zeros=False)
    return CsrMatrix._from_parts(nrows, ncols, ptr, minor, values)
