"""Sparse LU factorization with triangular solve (north-star N5).

Three paths, mirroring `cholesky.py`:

- **banded** (RCM → panelled band LU in a ``lax.scan``, no pivoting):
  diagonally-dominant stencil operators with a tight RCM band.
- **supernodal** (general sparsity): AMD on the symmetrized structure
  ``struct(A + Aᵀ)``, elimination tree + postorder, batched multifrontal
  LU with restricted partial pivoting inside each supernode's diagonal
  block (`supernodal_lu.py`) — no densification, batched dense fronts.
- **dense** partial-pivoting fallback (``jax.scipy.linalg.lu_factor``)
  for tiny systems or when full GEPP is explicitly requested
  (``pivot=True``).

Reference scope: lu is documented intent only (`csr.rs:16-17`,
`csc.rs:16-17`).

Examples
--------
>>> import numpy as np
>>> from spalinalg import CsrMatrix
>>> from spalinalg.linalg import lu, lu_solve
>>> A = CsrMatrix(3, 3, [0, 2, 4, 6], [0, 1, 0, 1, 1, 2],
...               [4.0, 1.0, 1.0, 3.0, 1.0, 2.0])
>>> fac = lu(A)
>>> x = lu_solve(fac, np.array([5.0, 4.0, 3.0]))
>>> bool(np.allclose(A.to_dense() @ np.asarray(x), [5.0, 4.0, 3.0]))
True
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

import jax
import jax.numpy as jnp

from ..errors import ShapeError
from .banded import BandLuFactor, band_lu_factor, band_lu_solve
from .cholesky import permute_csr
from .ordering import bandwidth as _bandwidth, rcm_ordering

__all__ = ["LuFactor", "lu", "lu_solve"]


@dataclass(frozen=True, eq=False)
class LuFactor:
    n: int
    perm: Optional[np.ndarray]
    band: Optional[BandLuFactor]
    dense_lu: Optional[tuple]  # (lu, piv) from jax.scipy.linalg.lu_factor
    snlu: Optional[object] = None  # SupernodalLuFactor (general case)
    a: Optional[object] = None  # original CsrMatrix (for refinement)


def _supernodal_lu(csr, *, reorder: bool, perturb: bool) -> LuFactor:
    """General-sparsity path: AMD + postorder on struct(A+Aᵀ), batched
    multifrontal LU with restricted pivoting (`supernodal_lu.py`)."""
    from ..dtypes import INDEX_DTYPE
    from ..formats.compressed import CsrMatrix
    from .supernodal_lu import (build_supernodal_lu_plan,
                                map_values_to_structure,
                                supernodal_lu_factor, symmetrize_structure)
    from .symbolic import amd_ordering, chol_symbolic, etree, postorder

    n = csr.nrows
    ptr = np.asarray(csr._ptr, dtype=np.int64)
    ind = np.asarray(csr._minor, dtype=np.int64)[: int(ptr[-1])]
    s_ptr, s_ind = symmetrize_structure(ptr, ind, n)
    S0 = CsrMatrix._from_parts(
        n, n,
        jnp.asarray(s_ptr, dtype=INDEX_DTYPE),
        jnp.asarray(s_ind, dtype=INDEX_DTYPE),
        jnp.zeros(s_ind.size, csr._values.dtype))
    if reorder:
        p1 = amd_ordering(S0)
        S1 = permute_csr(S0, p1)
    else:
        p1 = np.arange(n, dtype=np.int64)
        S1 = S0
    ptr1 = np.asarray(S1._ptr, dtype=np.int64)
    ind1 = np.asarray(S1._minor, dtype=np.int64)[: int(ptr1[-1])]
    post = postorder(etree(ptr1, ind1, n))
    perm = p1[post]
    Sp = permute_csr(S0, perm)
    Ap = permute_csr(csr, perm)
    sptr = np.asarray(Sp._ptr, dtype=np.int64)
    sind = np.asarray(Sp._minor, dtype=np.int64)[: int(sptr[-1])]
    sym = chol_symbolic(sptr, sind, n)
    plan = build_supernodal_lu_plan(sym, sptr, sind)
    vpos = map_values_to_structure(
        np.asarray(Ap._ptr, dtype=np.int64),
        np.asarray(Ap._minor, dtype=np.int64), sptr, sind, n)
    nnz_a = int(np.asarray(Ap._ptr)[-1])
    svals = (jnp.zeros(sind.size, Ap._values.dtype)
             .at[jnp.asarray(vpos)].set(Ap._values[:nnz_a]))
    fac = supernodal_lu_factor(plan, svals, perturb=perturb)
    return LuFactor(n=n, perm=perm, band=None, dense_lu=None, snlu=fac,
                    a=csr)


def lu(csr, *, reorder: bool = True, panel: int = 64,
       band_threshold: float = 0.12, pivot: bool = False,
       method: str = "auto", perturb: bool = True) -> LuFactor:
    """Factor ``A = L U``.

    ``method``: "auto" picks the banded dense-panel pipeline when an RCM
    band is tight and the general supernodal multifrontal path (AMD on
    struct(A+Aᵀ), restricted partial pivoting per supernode block)
    otherwise; "banded" / "supernodal" / "dense" force a path.
    ``pivot=True`` forces full dense partial pivoting (GEPP) — the
    numerically safest choice for small ill-conditioned systems; the
    supernodal path pivots within supernode diagonal blocks and (with
    ``perturb``, default on) lifts near-zero pivots SuperLU-DIST-style,
    which is robust for the diagonally-dominant and graph-Laplacian
    classes this framework targets (pair with iterative refinement for
    hard cases).
    """
    if csr.nrows != csr.ncols:
        raise ShapeError(f"LU needs a square matrix, got {csr.shape}")
    n = csr.nrows

    if method not in ("auto", "banded", "supernodal", "dense"):
        raise ValueError(f"unknown lu method {method!r}")
    if method == "supernodal":
        if pivot:
            raise ValueError(
                "pivot=True requests full partial pivoting (GEPP), which "
                "the supernodal path does not provide (it pivots within "
                "supernode blocks); drop pivot=True or use method='dense'")
        return _supernodal_lu(csr, reorder=reorder, perturb=perturb)
    if pivot or n <= 2 or method == "dense":
        from jax.scipy.linalg import lu_factor

        return LuFactor(n=n, perm=None, band=None,
                        dense_lu=lu_factor(csr.to_dense()))

    perm = None
    mat = csr
    bw = _bandwidth(csr)
    if reorder:
        p = rcm_ordering(csr)
        pm = permute_csr(csr, p)
        pbw = _bandwidth(pm)
        if pbw < bw:
            perm, mat, bw = p, pm, pbw

    if method == "auto" and bw >= max(2, int(band_threshold * n)):
        return _supernodal_lu(csr, reorder=reorder, perturb=perturb)

    fac = band_lu_factor(mat, bandwidth=bw, panel=panel)
    return LuFactor(n=n, perm=perm, band=fac, dense_lu=None)


def _lu_solve_once(fac: LuFactor, b) -> jax.Array:
    if fac.snlu is not None:
        # fused program incl. permutations (one dispatch)
        from .supernodal_lu import supernodal_lu_solve

        return supernodal_lu_solve(fac.snlu, b, perm=fac.perm)
    bp = b[jnp.asarray(fac.perm)] if fac.perm is not None else b
    if fac.dense_lu is not None:
        from jax.scipy.linalg import lu_solve as _dense_solve

        xp = _dense_solve(fac.dense_lu, bp)
    else:
        xp = band_lu_solve(fac.band, bp)
    if fac.perm is not None:
        iperm = np.empty(fac.n, dtype=np.int64)
        iperm[fac.perm] = np.arange(fac.n)
        return xp[jnp.asarray(iperm)]
    return xp


def lu_solve(fac: LuFactor, b, *, refine: Optional[int] = None) -> jax.Array:
    """Solve ``A x = b`` given an :func:`lu` factor.

    ``refine``: iterative-refinement steps against the original matrix.
    Defaults to 1 for the supernodal path — it pivots only within
    supernode diagonal blocks (plus the static perturbation safeguard),
    so a refinement sweep restores accuracy on non-diagonally-dominant
    inputs — and 0 for the fully-pivoted paths."""
    b = jnp.asarray(b)
    x = _lu_solve_once(fac, b)
    steps = refine if refine is not None else (
        1 if (fac.snlu is not None and fac.a is not None) else 0)
    if steps and fac.a is not None:
        # residual via the bucketed-plan SpMV (structure is concrete on
        # this path)
        from ..ops.matvec import _plan_spmv_jit, _row_plan

        plan = _row_plan(fac.a)
        for _ in range(steps):
            r = b - _plan_spmv_jit(plan, fac.a.colind, fac.a.values,
                                   x.astype(fac.a.values.dtype))
            x = x + _lu_solve_once(fac, r)
    return x
