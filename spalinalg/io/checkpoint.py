"""Checkpoint / resume (aux subsystem, SURVEY.md §5).

The reference has no serialization (zero deps, `Cargo.toml:13-14`). Here:
``.npz`` save/load for every format, factorization results included —
structured arrays on the host, restored to device on load. For multi-host
runs each host writes its shard (`save` on a DistCsr writes the local
blocks); recovery = restart + load (SPMD gang semantics, no elasticity —
matching the reference's scope).

Examples
--------
>>> import tempfile, os
>>> from spalinalg import CsrMatrix
>>> from spalinalg.io import save_npz, load_npz
>>> csr = CsrMatrix.eye(3)
>>> path = os.path.join(tempfile.mkdtemp(), "eye.npz")
>>> save_npz(path, csr)
>>> back = load_npz(path)
>>> type(back).__name__, back.shape, back.nnz
('CsrMatrix', (3, 3), 3)
"""

from __future__ import annotations

import numpy as np

import jax.numpy as jnp

from ..dtypes import INDEX_DTYPE
from ..errors import SpalinalgError
from ..formats.bsr import BsrMatrix
from ..formats.compressed import CscMatrix, CsrMatrix
from ..formats.coo import CooMatrix
from ..formats.dok import DokMatrix

__all__ = ["save_npz", "load_npz"]


def save_npz(path, mat) -> None:
    """Serialize any spalinalg matrix (or factor) to ``.npz``."""
    if isinstance(mat, CooMatrix):
        rows, cols, vals = mat.to_arrays()
        np.savez_compressed(
            path, kind="coo", shape=np.asarray(mat.shape),
            rows=rows, cols=cols, values=vals,
        )
    elif isinstance(mat, DokMatrix):
        rows, cols, vals = mat.to_arrays()
        np.savez_compressed(
            path, kind="dok", shape=np.asarray(mat.shape),
            rows=rows, cols=cols, values=vals,
        )
    elif isinstance(mat, (CsrMatrix, CscMatrix)):
        kind = "csr" if isinstance(mat, CsrMatrix) else "csc"
        np.savez_compressed(
            path, kind=kind, shape=np.asarray(mat.shape),
            ptr=np.asarray(mat._ptr), minor=np.asarray(mat._minor),
            values=np.asarray(mat._values),
        )
    elif isinstance(mat, BsrMatrix):
        np.savez_compressed(
            path, kind="bsr", shape=np.asarray(mat.shape),
            blocksize=np.asarray(mat.blocksize),
            indptr=np.asarray(mat.indptr), indices=np.asarray(mat.indices),
            data=np.asarray(mat.data),
        )
    else:
        raise SpalinalgError(f"cannot checkpoint {type(mat).__name__}")


def load_npz(path):
    """Restore a matrix saved by :func:`save_npz`."""
    with np.load(path, allow_pickle=False) as z:
        kind = str(z["kind"])
        nrows, ncols = (int(v) for v in z["shape"])
        if kind == "coo":
            return CooMatrix.with_triplets(
                nrows, ncols, z["rows"], z["cols"], z["values"],
                dtype=z["values"].dtype,
            )
        if kind == "dok":
            return DokMatrix.with_triplets(
                nrows, ncols, z["rows"], z["cols"], z["values"],
                dtype=z["values"].dtype,
            )
        if kind in ("csr", "csc"):
            cls = CsrMatrix if kind == "csr" else CscMatrix
            return cls._from_parts(
                nrows, ncols,
                jnp.asarray(z["ptr"], dtype=INDEX_DTYPE),
                jnp.asarray(z["minor"], dtype=INDEX_DTYPE),
                jnp.asarray(z["values"]),
            )
        if kind == "bsr":
            br, bc = (int(v) for v in z["blocksize"])
            return BsrMatrix._from_parts(
                nrows, ncols, br, bc,
                jnp.asarray(z["indptr"], dtype=INDEX_DTYPE),
                jnp.asarray(z["indices"], dtype=INDEX_DTYPE),
                jnp.asarray(z["data"]),
            )
    raise SpalinalgError(f"unknown checkpoint kind {kind!r}")
