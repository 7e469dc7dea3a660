"""scipy.sparse bridges (oracle/testing interop, SURVEY.md §4: "numeric
oracle = reference semantics re-derived via scipy.sparse").

Gated: scipy is optional — importing this module works without it; calling
the functions raises a clear error if scipy is absent.

Examples
--------
>>> import scipy.sparse as sps
>>> from spalinalg.io import from_scipy, to_scipy
>>> s = sps.csr_matrix([[1.0, 0.0], [0.0, 2.0]])
>>> m = from_scipy(s)
>>> type(m).__name__, m.nnz
('CsrMatrix', 2)
>>> (to_scipy(m) != s).nnz       # round-trip: no differing entries
0
"""

from __future__ import annotations

import numpy as np

import jax.numpy as jnp

from ..dtypes import INDEX_DTYPE
from ..errors import SpalinalgError
from ..formats.compressed import CscMatrix, CsrMatrix
from ..formats.coo import CooMatrix

__all__ = ["from_scipy", "to_scipy"]


def _scipy_sparse():
    try:
        import scipy.sparse as sps  # noqa: PLC0415
        return sps
    except ImportError as e:  # pragma: no cover
        raise SpalinalgError(
            "scipy is not installed; scipy interop unavailable"
        ) from e


def from_scipy(mat):
    """Convert a scipy.sparse matrix to the matching spalinalg format."""
    sps = _scipy_sparse()
    if sps.issparse(mat):
        if mat.format == "csr":
            m = mat.sorted_indices()
            return CsrMatrix._from_parts(
                m.shape[0], m.shape[1],
                jnp.asarray(m.indptr, dtype=INDEX_DTYPE),
                jnp.asarray(m.indices, dtype=INDEX_DTYPE),
                jnp.asarray(m.data),
            )
        if mat.format == "csc":
            m = mat.sorted_indices()
            return CscMatrix._from_parts(
                m.shape[0], m.shape[1],
                jnp.asarray(m.indptr, dtype=INDEX_DTYPE),
                jnp.asarray(m.indices, dtype=INDEX_DTYPE),
                jnp.asarray(m.data),
            )
        m = mat.tocoo()
        return CooMatrix.with_triplets(
            m.shape[0], m.shape[1], m.row, m.col, m.data, dtype=m.data.dtype
        )
    raise SpalinalgError(f"not a scipy sparse matrix: {type(mat)}")


def to_scipy(mat):
    """Convert a spalinalg matrix to scipy.sparse."""
    sps = _scipy_sparse()
    if isinstance(mat, CsrMatrix):
        nnz = mat.nnz
        return sps.csr_matrix(
            (np.asarray(mat.values)[:nnz], np.asarray(mat.colind)[:nnz],
             np.asarray(mat.rowptr)),
            shape=mat.shape,
        )
    if isinstance(mat, CscMatrix):
        nnz = mat.nnz
        return sps.csc_matrix(
            (np.asarray(mat.values)[:nnz], np.asarray(mat.rowind)[:nnz],
             np.asarray(mat.colptr)),
            shape=mat.shape,
        )
    if isinstance(mat, CooMatrix):
        rows, cols, vals = mat.to_arrays()
        return sps.coo_matrix((vals, (rows, cols)), shape=mat.shape)
    if hasattr(mat, "to_coo"):
        return to_scipy(mat.to_coo())
    raise SpalinalgError(f"cannot convert {type(mat).__name__} to scipy")
