"""Incomplete-factorization preconditioners: ILU(0) and IC(0).

Production accelerators for the Krylov tier (`cg`/`gmres`/`bicgstab`) —
the reference has no solvers at all, so the design contract here is the
standard sparse-solver expectation (`scipy.sparse.linalg.spilu`-class).

Split follows the framework discipline: the **factorization is host-side
setup** (once per structure+values, vectorised NumPy row sweep over the
existing CSR arrays — the same class of work as AMD ordering), while the
**application is device-side** — two level-scheduled triangular solves
through precomputed :class:`~spalinalg.linalg.triangular.TriangularPlan`s,
fully jittable so preconditioned solvers stay inside ``lax.while_loop``
with zero host round-trips per iteration.

Cost model: the level-scheduled solve unrolls one slab per dependency
level into the XLA graph, so compile time scales with the level count
(a 2-D g×g stencil has ~2g levels). Amortise by jitting the whole
preconditioned solver once per structure — warm solves are then
milliseconds (measured: 10 s compile / 19 ms warm for a 64×64 Laplacian
IC(0)-PCG on CPU).

Examples
--------
>>> import numpy as np
>>> from spalinalg import CooMatrix, CsrMatrix
>>> from spalinalg.linalg import cg, ic0, ilu0
>>> n = 16
>>> ent = [(i, i, 4.0) for i in range(n)]
>>> ent += [(i, i + 1, -1.0) for i in range(n - 1)]
>>> ent += [(i + 1, i, -1.0) for i in range(n - 1)]
>>> A = CsrMatrix.from_coo(CooMatrix.with_entries(n, n, ent))
>>> M = ic0(A)
>>> res = cg(A, np.ones(n), precondition=M, tol=1e-12)
>>> bool(res.residual < 1e-10)
True
>>> M = ilu0(A)                     # general (nonsymmetric) variant
>>> r = np.ones(n)
>>> z = M.solve(r)                  # z = U^-1 L^-1 r, device-side
>>> z.shape
(16,)
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

import jax
import jax.numpy as jnp

from ..dtypes import INDEX_DTYPE
from ..errors import ShapeError, StructureError
from .triangular import TriangularPlan, plan_triangular

__all__ = ["Ilu0Precond", "ilu0", "ic0", "chebyshev", "ChebyshevPrecond"]


@dataclass(frozen=True, eq=False)
class Ilu0Precond:
    """``M⁻¹ r = U⁻¹ (L⁻¹ r)`` with level-scheduled device solves."""

    n: int
    l_mat: object               # CsrMatrix, unit lower (diag stored = 1)
    u_mat: object               # CsrMatrix, upper with diagonal
    l_plan: TriangularPlan
    u_plan: TriangularPlan
    kind: str = "ilu0"

    def solve(self, r: jax.Array) -> jax.Array:
        from .triangular import _solve_device

        y = _solve_device(self.l_plan, self.l_mat.values, jnp.asarray(r))
        return _solve_device(self.u_plan, self.u_mat.values, y)

    __call__ = solve


def _csr_host(csr):
    ptr = np.asarray(csr._ptr, dtype=np.int64)
    ind = np.asarray(csr._minor, dtype=np.int64)[: int(ptr[-1])]
    val = np.asarray(csr._values)[: int(ptr[-1])].copy()
    return ptr, ind, val


def _split_lu(n, ptr, ind, val, dtype):
    """Split factored in-place values into unit-L and U CSR matrices."""
    from ..formats.compressed import CsrMatrix

    rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(ptr))
    lower = ind < rows
    upper = ~lower                     # includes the diagonal

    def build(mask, add_unit_diag):
        r, c, v = rows[mask], ind[mask], val[mask]
        if add_unit_diag:
            r = np.concatenate([r, np.arange(n)])
            c = np.concatenate([c, np.arange(n)])
            v = np.concatenate([v, np.ones(n, dtype=v.dtype)])
            o = np.lexsort((c, r))
            r, c, v = r[o], c[o], v[o]
        new_ptr = np.zeros(n + 1, dtype=np.int64)
        np.add.at(new_ptr, r + 1, 1)
        np.cumsum(new_ptr, out=new_ptr)
        return CsrMatrix._from_parts(
            n, n,
            jnp.asarray(new_ptr, dtype=INDEX_DTYPE),
            jnp.asarray(c, dtype=INDEX_DTYPE),
            jnp.asarray(v.astype(dtype, copy=False)))

    return build(lower, True), build(upper, False)


def ilu0(csr) -> Ilu0Precond:
    """ILU(0): incomplete LU restricted to A's sparsity pattern.

    Classic IKJ row sweep (Saad, Alg. 10.4) over the CSR arrays; raises
    :class:`StructureError` on a zero pivot (no pivoting — permute first
    if needed, e.g. with :func:`~spalinalg.linalg.rcm_ordering`).
    """
    if csr.nrows != csr.ncols:
        raise ShapeError(f"ilu0 needs a square matrix, got {csr.shape}")
    n = csr.nrows
    ptr, ind, val = _csr_host(csr)

    from ..native import lib as native

    if native.available():
        new_val, bad = native.ilu0_values(ptr, ind, val, n)
        if bad >= 0:
            # distinguish missing-diagonal from zero pivot for the message
            has_diag = np.any(ind[ptr[bad]: ptr[bad + 1]] == bad)
            raise StructureError(
                f"ilu0 zero pivot at row {bad}" if has_diag
                else "ilu0 needs every diagonal entry present")
        val = new_val.astype(val.dtype, copy=False)
        l_mat, u_mat = _split_lu(n, ptr, ind, val, csr.values.dtype)
        return Ilu0Precond(
            n=n, l_mat=l_mat, u_mat=u_mat,
            l_plan=plan_triangular(l_mat, lower=True, unit_diag=True),
            u_plan=plan_triangular(u_mat, lower=False))

    diag_pos = np.full(n, -1, dtype=np.int64)
    for i in range(n):
        for k in range(int(ptr[i]), int(ptr[i + 1])):
            if ind[k] == i:
                diag_pos[i] = k
    if np.any(diag_pos < 0):
        raise StructureError("ilu0 needs every diagonal entry present")

    # per-row column->position maps for the pattern-restricted update
    colmap = [dict() for _ in range(n)]
    for i in range(n):
        for k in range(int(ptr[i]), int(ptr[i + 1])):
            colmap[i][int(ind[k])] = k

    for i in range(n):
        lo, hi = int(ptr[i]), int(ptr[i + 1])
        for kk in range(lo, hi):
            k = int(ind[kk])
            if k >= i:
                break                      # columns are sorted
            piv = val[diag_pos[k]]
            if piv == 0:
                raise StructureError(f"ilu0 zero pivot at row {k}")
            lik = val[kk] / piv
            val[kk] = lik
            krow = colmap[k]
            for jj in range(kk + 1, hi):
                j = int(ind[jj])
                pos = krow.get(j)
                if pos is not None and j > k:
                    val[jj] -= lik * val[pos]
        if val[diag_pos[i]] == 0:
            raise StructureError(f"ilu0 zero pivot at row {i}")

    l_mat, u_mat = _split_lu(n, ptr, ind, val, csr.values.dtype)
    return Ilu0Precond(
        n=n, l_mat=l_mat, u_mat=u_mat,
        l_plan=plan_triangular(l_mat, lower=True, unit_diag=True),
        u_plan=plan_triangular(u_mat, lower=False))


def ic0(csr) -> Ilu0Precond:
    """IC(0): incomplete Cholesky on the lower pattern of an SPD matrix.

    ``M = L Lᵀ``; applied as a forward + backward level-scheduled solve.
    Raises :class:`StructureError` when a pivot goes non-positive (the
    matrix is not SPD enough for zero fill — shift the diagonal or use
    :func:`ilu0`).
    """
    if csr.nrows != csr.ncols:
        raise ShapeError(f"ic0 needs a square matrix, got {csr.shape}")
    n = csr.nrows
    ptr, ind, val = _csr_host(csr)
    rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(ptr))

    # lower-triangle pattern (incl. diagonal) in CSR
    keep = ind <= rows
    lr, lc, lv = rows[keep], ind[keep], val[keep].copy()
    lptr = np.zeros(n + 1, dtype=np.int64)
    np.add.at(lptr, lr + 1, 1)
    np.cumsum(lptr, out=lptr)

    from ..native import lib as native

    if native.available():
        new_lv, bad = native.ic0_values(lptr, lc, lv, n)
        if bad >= 0:
            hi = int(lptr[bad + 1])
            has_diag = hi > int(lptr[bad]) and int(lc[hi - 1]) == bad
            raise StructureError(
                f"ic0 non-positive pivot at row {bad} (matrix not SPD "
                f"under zero fill)" if has_diag
                else "ic0 needs every diagonal entry present")
        return _ic0_wrap(csr, n, lptr, lc,
                         new_lv.astype(lv.dtype, copy=False))

    colmap = [dict() for _ in range(n)]
    for k in range(lc.size):
        colmap[int(lr[k])][int(lc[k])] = k

    for i in range(n):
        lo, hi = int(lptr[i]), int(lptr[i + 1])
        if int(lc[hi - 1]) != i:
            raise StructureError("ic0 needs every diagonal entry present")
        irow = colmap[i]
        for kk in range(lo, hi):
            j = int(lc[kk])
            jrow = colmap[j]
            s = lv[kk]
            # s -= sum_k L[i,k] L[j,k] over shared columns k < j
            for col, pos_i in irow.items():
                if col >= j:
                    continue
                pos_j = jrow.get(col)
                if pos_j is not None:
                    s -= lv[pos_i] * lv[pos_j]
            if j < i:
                djj = lv[int(lptr[j + 1]) - 1]
                lv[kk] = s / djj
            else:                          # diagonal
                if s <= 0:
                    raise StructureError(
                        f"ic0 non-positive pivot at row {i} "
                        f"(matrix not SPD under zero fill)")
                lv[kk] = np.sqrt(s)

    return _ic0_wrap(csr, n, lptr, lc, lv)


def _ic0_wrap(csr, n, lptr, lc, lv) -> Ilu0Precond:
    from ..formats.compressed import CsrMatrix

    dtype = csr.values.dtype
    l_mat = CsrMatrix._from_parts(
        n, n,
        jnp.asarray(lptr, dtype=INDEX_DTYPE),
        jnp.asarray(lc, dtype=INDEX_DTYPE),
        jnp.asarray(lv.astype(dtype, copy=False)))
    lt_mat = l_mat.transpose()
    return Ilu0Precond(
        n=n, l_mat=l_mat, u_mat=lt_mat,
        l_plan=plan_triangular(l_mat, lower=True),
        u_plan=plan_triangular(lt_mat, lower=False),
        kind="ic0")


@dataclass(frozen=True, eq=False)
class ChebyshevPrecond:
    """Polynomial preconditioner: ``M⁻¹r ≈ p_k(A) r ≈ A⁻¹r``.

    The accelerator-friendly preconditioner: its application is ``degree`` SpMVs and
    axpys — no triangular solves, no level scheduling, no per-level graph
    unrolling — so it rides the same roofline as the operator itself and
    composes with ANY operand (CSR/BSR/DistCsr: the SpMV dispatch decides).
    Spectrum bounds ``(lmin, lmax)`` must bracket A's eigenvalues (SPD).
    """

    lmin: float
    lmax: float
    degree: int
    a: object

    @property
    def supports_dist(self) -> bool:
        """Pure-SpMV application: sharding-aware iff its operand is."""
        from ..parallel.partition import DistCsr

        return isinstance(self.a, DistCsr)

    def _matvec(self, v):
        from ..parallel.partition import DistCsr

        if isinstance(self.a, DistCsr):
            from ..parallel.spmv import dist_spmv

            return dist_spmv(self.a, v)
        return self.a @ v

    def solve(self, r: jax.Array) -> jax.Array:
        """Chebyshev iteration for ``A z = r`` from ``z0 = 0`` (Saad §12.3)."""
        theta = (self.lmax + self.lmin) / 2.0
        delta = (self.lmax - self.lmin) / 2.0
        r = jnp.asarray(r)
        # first step: z1 = r / theta
        z = r / theta
        if self.degree == 1:
            return z
        rho_prev = delta / theta
        resid = r - self._matvec(z)
        d = z                                  # z_k - z_{k-1}
        for _ in range(self.degree - 1):
            rho = 1.0 / (2.0 * theta / delta - rho_prev)
            d = rho * rho_prev * d + (2.0 * rho / delta) * resid
            z = z + d
            resid = resid - self._matvec(d)
            rho_prev = rho
        return z

    __call__ = solve


def chebyshev(A, *, degree: int = 8, lmin: float = None,
              lmax: float = None, power_iters: int = 20) -> ChebyshevPrecond:
    """Build a Chebyshev preconditioner for an SPD operand.

    Missing spectrum bounds are estimated once at setup: ``lmax`` by
    power iteration (inflated 5 %), ``lmin`` defaults to ``lmax / 30``
    (clustering the polynomial on the high end — the standard choice when
    the small eigenvalues are unknown).
    """
    from ..parallel.partition import DistCsr

    is_dist = isinstance(A, DistCsr)
    shape = (A.nrows, A.ncols) if is_dist else A.shape
    if shape[0] != shape[1]:
        raise ShapeError(f"chebyshev needs a square operand, got {shape}")
    if degree < 1:
        raise ValueError(f"degree must be >= 1, got {degree}")
    if lmax is None:
        if is_dist:
            raise ValueError(
                "pass explicit (lmin, lmax) for DistCsr operands — the "
                "setup-time power iteration is single-chip only")
        n = shape[0]
        rng = np.random.default_rng(0)
        v = jnp.asarray(rng.normal(size=n))
        v = v / jnp.linalg.norm(v)

        def body(_, v):
            w = A @ v
            return w / jnp.maximum(jnp.linalg.norm(w), 1e-300)

        v = jax.lax.fori_loop(0, power_iters, body, v)
        lmax = 1.05 * float(jnp.vdot(v, A @ v))
    if lmin is None:
        lmin = lmax / 30.0
    if not 0 < lmin < lmax:
        raise ValueError(f"need 0 < lmin < lmax, got {lmin}, {lmax}")
    return ChebyshevPrecond(lmin=float(lmin), lmax=float(lmax),
                            degree=int(degree), a=A)
