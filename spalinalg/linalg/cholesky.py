"""Sparse Cholesky factorization (north-star N5; reference has only the
documented intent, `csr.rs:16-17`).

Pipeline (SURVEY.md §7 phase 5, "supernodal blocking mapped to dense
panels"):

1. **Symbolic (host, once)**: RCM ordering compresses the band; the half
   bandwidth of the permuted matrix fixes the dense-panel window.
2. **Numeric (device)**: blocked banded Cholesky — dense ``nb×nb``
   Cholesky + ``b×nb`` triangular solve + ``b×b`` syrk per panel inside a
   ``lax.scan`` (`banded.py`), all dense matmuls.
3. **Solve (device)**: two panelled triangular sweeps.

For stencil Laplacians (BASELINE config[3]) RCM yields the natural
grid-width band and the panels are dense — exactly the structure dense
matmul units want. Matrices whose RCM band is a large fraction of n fall
back to a dense Cholesky (they are effectively dense after fill-in anyway).

Examples
--------
>>> import numpy as np
>>> from spalinalg import CsrMatrix
>>> from spalinalg.linalg import cholesky, cholesky_solve
>>> # 1-D Laplacian (SPD tridiagonal)
>>> n = 8
>>> rows, cols, vals = [], [], []
>>> for i in range(n):
...     for j, v in (((i - 1), -1.0), (i, 2.0), ((i + 1), -1.0)):
...         if 0 <= j < n:
...             rows.append(i); cols.append(j); vals.append(v)
>>> from spalinalg import CooMatrix, CsrMatrix
>>> A = CsrMatrix.from_coo(CooMatrix.with_triplets(n, n, rows, cols, vals))
>>> fac = cholesky(A)
>>> b = np.ones(n)
>>> x = cholesky_solve(fac, b)
>>> bool(np.allclose(A.to_dense() @ np.asarray(x), b, atol=1e-8))
True
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

import jax
import jax.numpy as jnp

from ..dtypes import INDEX_DTYPE
from ..convert.engine import compress_host
from ..errors import ShapeError
from .banded import BandCholeskyFactor, band_cholesky_factor, band_cholesky_solve
from .ordering import bandwidth as _bandwidth, rcm_ordering

__all__ = ["CholeskyFactor", "cholesky", "cholesky_solve", "permute_csr"]


def permute_csr(csr, perm: np.ndarray):
    """Symmetric permutation ``A[perm][:, perm]`` (host structure work)."""
    from ..formats.compressed import CsrMatrix

    perm = np.asarray(perm, dtype=np.int64)
    n = csr.nrows
    if perm.shape != (n,):
        raise ShapeError(f"permutation must have length {n}")
    iperm = np.empty(n, dtype=np.int64)
    iperm[perm] = np.arange(n)
    ptr = np.asarray(csr._ptr, dtype=np.int64)
    ind = np.asarray(csr._minor, dtype=np.int64)[: int(ptr[-1])]
    val = np.asarray(csr._values)[: int(ptr[-1])]
    rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(ptr))
    new_ptr, new_ind, new_val = compress_host(
        iperm[rows], iperm[ind], val, n, dedup=False, drop_zeros=False
    )
    return CsrMatrix._from_parts(
        n, csr.ncols,
        jnp.asarray(new_ptr, dtype=INDEX_DTYPE),
        jnp.asarray(new_ind, dtype=INDEX_DTYPE),
        jnp.asarray(new_val),
    )


@dataclass(frozen=True, eq=False)
class CholeskyFactor:
    """Factorization result: ordering + banded/supernodal/dense factor."""

    n: int
    perm: Optional[np.ndarray]          # None -> natural order
    band: Optional[BandCholeskyFactor]  # panelled banded factor
    dense_l: Optional[jax.Array]        # dense fallback factor
    snf: Optional[object] = None        # SupernodalFactor (general case)

    @property
    def is_dense(self) -> bool:
        return self.dense_l is not None


def _supernodal_symbolic_cached(csr, reorder: bool):
    """(perm, SupernodalPlan) for this structure — the whole host
    symbolic pipeline (AMD, etree, postorder, column counts, bucketed
    assembly/extend-add index plans), persisted in the structure-hashed
    disk cache. Cold `cholesky()` then costs one npz load + the numeric
    phase instead of seconds of host planning."""
    from ..utils.plandisk import load_or_build
    from .supernodal import build_supernodal_plan
    from .symbolic import amd_ordering, chol_symbolic, etree, postorder

    n = csr.nrows
    ptr0 = np.asarray(csr._ptr, dtype=np.int64)
    ind0 = np.asarray(csr._minor, dtype=np.int64)[: int(ptr0[-1])]

    def build():
        if reorder:
            p1 = amd_ordering(csr)
        else:
            p1 = np.arange(n, dtype=np.int64)
        m1 = permute_csr(csr, p1)
        ptr = np.asarray(m1._ptr, dtype=np.int64)
        ind = np.asarray(m1._minor, dtype=np.int64)[: int(ptr[-1])]
        post = postorder(etree(ptr, ind, n))
        perm = p1[post]
        mat = permute_csr(csr, perm)
        ptr = np.asarray(mat._ptr, dtype=np.int64)
        ind = np.asarray(mat._minor, dtype=np.int64)[: int(ptr[-1])]
        sym = chol_symbolic(ptr, ind, n)
        plan = build_supernodal_plan(sym, ptr, ind)
        return (perm, plan)

    perm, plan = load_or_build("snchol", (ptr0, ind0),
                               (n, int(bool(reorder))), build)
    return np.asarray(perm), plan


def _supernodal_cholesky(csr, *, reorder: bool) -> CholeskyFactor:
    """General-sparsity path: AMD + postorder, supernodal multifrontal."""
    from .supernodal import supernodal_factor

    n = csr.nrows
    perm, plan = _supernodal_symbolic_cached(csr, reorder)
    mat = permute_csr(csr, perm)
    nnz = int(np.asarray(mat._ptr, dtype=np.int64)[-1])
    snf = supernodal_factor(plan, mat._values[:nnz])
    return CholeskyFactor(n=n, perm=perm, band=None, dense_l=None, snf=snf)


def cholesky(csr, *, reorder: bool = True, panel: int = 64,
             band_threshold: float = 0.12,
             method: str = "auto") -> CholeskyFactor:
    """Factor an SPD CSR matrix ``A = L Lᵀ``.

    ``method``: "auto" picks the banded dense-panel pipeline when an RCM
    band is tight (band work ~ n·b² stays near the true fill) and the
    general supernodal multifrontal path (AMD ordering, elimination
    tree, batched dense fronts) otherwise; "banded" / "supernodal"
    force a path. ``reorder=False`` keeps the natural ordering.
    """
    if csr.nrows != csr.ncols:
        raise ShapeError(f"Cholesky needs a square matrix, got {csr.shape}")
    n = csr.nrows

    if method not in ("auto", "banded", "supernodal", "dense"):
        raise ValueError(f"unknown cholesky method {method!r}")
    if method == "supernodal":
        return _supernodal_cholesky(csr, reorder=reorder)

    perm = None
    mat = csr
    bw = _bandwidth(csr)
    if reorder:
        p = rcm_ordering(csr)
        pm = permute_csr(csr, p)
        pbw = _bandwidth(pm)
        if pbw < bw:
            perm, mat, bw = p, pm, pbw

    if n <= 2 or method == "dense":
        dense = mat.to_dense()
        return CholeskyFactor(n=n, perm=perm,
                              band=None, dense_l=jnp.linalg.cholesky(dense))

    if method == "auto":
        # band too wide for the O(n·b²) panel pipeline, or the (P, m, m)
        # slab stack would not fit: general supernodal path instead
        nb = max(1, min(panel, n))
        itemsize = jnp.dtype(mat._values.dtype).itemsize
        slab_bytes = -(-n // nb) * (nb + bw) ** 2 * itemsize
        if (bw >= max(2, int(band_threshold * n))
                or slab_bytes > 1_500_000_000):
            return _supernodal_cholesky(csr, reorder=reorder)

    fac = band_cholesky_factor(mat, bandwidth=bw, panel=panel)
    return CholeskyFactor(n=n, perm=perm, band=fac, dense_l=None)


def cholesky_solve(fac: CholeskyFactor, b) -> jax.Array:
    """Solve ``A x = b`` given a :func:`cholesky` factor."""
    b = jnp.asarray(b)
    if fac.snf is not None:
        # one fused program incl. permutations (not 3 dispatches)
        from .supernodal import supernodal_solve

        return supernodal_solve(fac.snf, b, perm=fac.perm)
    bp = b[jnp.asarray(fac.perm)] if fac.perm is not None else b
    if fac.is_dense:
        from jax.scipy.linalg import solve_triangular

        y = solve_triangular(fac.dense_l, bp, lower=True)
        xp = solve_triangular(fac.dense_l.T, y, lower=False)
    else:
        xp = band_cholesky_solve(fac.band, bp)
    if fac.perm is not None:
        iperm = np.empty(fac.n, dtype=np.int64)
        iperm[fac.perm] = np.arange(fac.n)
        return xp[jnp.asarray(iperm)]
    return xp
