"""Conjugate-gradient solver — the canonical SpMV consumer and the
framework's flagship end-to-end pipeline (COO build → CSR convert → repeated
SpMV under jit).

Works on single-chip CSR/BSR matrices and on row-partitioned
:class:`~spalinalg.parallel.partition.DistCsr` (SpMV via halo/all-gather
collectives, dot products via ``psum``). The whole iteration runs inside one
``lax.while_loop`` — no host round-trips per step.

Examples
--------
>>> import numpy as np
>>> from spalinalg import CsrMatrix
>>> from spalinalg.linalg import cg
>>> A = CsrMatrix(2, 2, [0, 2, 4], [0, 1, 0, 1], [4.0, 1.0, 1.0, 3.0])
>>> res = cg(A, np.array([1.0, 2.0]), tol=1e-10)
>>> bool(res.residual < 1e-10)
True
>>> [round(float(v), 6) for v in res.x]
[0.090909, 0.636364]
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

__all__ = ["cg", "CgResult"]


class CgResult(NamedTuple):
    x: jax.Array
    iterations: jax.Array   # device scalar
    residual: jax.Array     # final ||r||


def _cg_loop(matvec, dot, b, x0, tol, maxiter, precond=None):
    """(Preconditioned) CG inside one ``lax.while_loop``."""
    psolve = precond if precond is not None else (lambda r: r)
    r0 = b - matvec(x0)
    z0 = psolve(r0)

    def cond(state):
        x, r, z, p, rz, rr, k = state
        return jnp.logical_and(k < maxiter, rr > tol * tol)

    def body(state):
        x, r, z, p, rz, rr, k = state
        ap = matvec(p)
        alpha = rz / dot(p, ap)
        x = x + alpha * p
        r = r - alpha * ap
        z = psolve(r)
        rz_new = dot(r, z)
        beta = rz_new / rz
        p = z + beta * p
        return (x, r, z, p, rz_new, dot(r, r), k + 1)

    rz0 = dot(r0, z0)
    rr0 = dot(r0, r0)
    x, r, z, p, rz, rr, k = jax.lax.while_loop(
        cond, body, (x0, r0, z0, z0, rz0, rr0, jnp.zeros((), jnp.int32))
    )
    return CgResult(x=x, iterations=k, residual=jnp.sqrt(rr))


def _jacobi_precond(A):
    """Inverse-diagonal preconditioner from a CSR/BSR matrix (host setup)."""
    import numpy as np

    from ..formats.compressed import CsrMatrix

    if not isinstance(A, CsrMatrix):
        A = A.to_csr() if hasattr(A, "to_csr") else A
    ptr = np.asarray(A._ptr, dtype=np.int64)
    minor = np.asarray(A._minor, dtype=np.int64)[: int(ptr[-1])]
    vals = np.asarray(A._values)[: int(ptr[-1])]
    rows = np.repeat(np.arange(A.nrows, dtype=np.int64), np.diff(ptr))
    diag = np.ones(A.nrows, dtype=vals.dtype)
    m = rows == minor
    diag[rows[m]] = vals[m]
    inv = jnp.asarray(np.where(diag != 0, 1.0 / diag, 1.0))
    return lambda r: inv * r


def cg(
    A,
    b: jax.Array,
    x0: Optional[jax.Array] = None,
    *,
    tol: float = 1e-10,
    maxiter: Optional[int] = None,
    precondition=None,
) -> CgResult:
    """Solve SPD ``A x = b`` by (optionally preconditioned) CG.

    ``precondition``: ``"jacobi"``, a callable ``r -> M⁻¹r``, or a
    preconditioner object with a ``.solve`` method (e.g.
    :func:`~spalinalg.linalg.ic0`).

    ``A`` may be a ``CsrMatrix``/``BsrMatrix`` (single chip) or a
    ``DistCsr`` (``b`` then must be a row-sharded padded vector from
    :func:`~spalinalg.parallel.spmv.shard_vector`; the result is sharded
    the same way). ``precondition="jacobi"`` applies the inverse diagonal —
    elementwise, so it composes with any sharding.
    """
    from ..parallel.partition import DistCsr

    if isinstance(A, DistCsr):
        from ..parallel.spmv import dist_dot, dist_spmv

        n = A.nrows
        maxiter = maxiter if maxiter is not None else 10 * n

        def matvec(v):
            return dist_spmv(A, v)

        def dot(u, v):
            return dist_dot(u, v, A)

        precond = None
        if precondition is not None and precondition != "jacobi":
            # incomplete-factorization objects hold single-chip plans;
            # only sharding-aware callables are usable here
            if hasattr(precondition, "solve"):
                if not getattr(precondition, "supports_dist", False):
                    raise ValueError(
                        "this preconditioner is single-chip; build it on "
                        "the DistCsr operand (chebyshev) or pass a "
                        "sharding-aware callable")
                precond = precondition.solve
            else:
                precond = precondition
        if precondition == "jacobi":
            import numpy as np

            # per-shard diagonal from the stacked blocks (host setup)
            rp = np.asarray(A.rowptr, dtype=np.int64)
            ci = np.asarray(A.colind, dtype=np.int64)
            vv = np.asarray(A.values)
            P_, rows_per = rp.shape[0], A.rows_per_shard
            diag = np.ones(P_ * rows_per, dtype=vv.dtype)
            for p in range(P_):
                rows = np.repeat(np.arange(rows_per), np.diff(rp[p]))
                grow = rows + p * rows_per
                m = ci[p][: rp[p, -1]] == grow
                diag[grow[m]] = vv[p][: rp[p, -1]][m]
            inv = jax.device_put(
                jnp.asarray(np.where(diag != 0, 1.0 / diag, 1.0)),
                b.sharding,
            )
            precond = lambda r: inv * r  # noqa: E731

        x0 = jnp.zeros_like(b) if x0 is None else x0
        return _cg_loop(matvec, dot, b, x0, tol, maxiter, precond)

    n = A.ncols
    maxiter = maxiter if maxiter is not None else 10 * n
    x0 = jnp.zeros(n, dtype=b.dtype) if x0 is None else x0

    def matvec(v):
        return A @ v

    def dot(u, v):
        return jnp.vdot(u, v, precision=jax.lax.Precision.HIGHEST)

    if precondition == "jacobi":
        precond = _jacobi_precond(A)
    elif precondition is None:
        precond = None
    elif hasattr(precondition, "solve"):
        precond = precondition.solve
    elif callable(precondition):
        precond = precondition
    else:
        raise ValueError(
            f"precondition must be 'jacobi', a callable or a "
            f"preconditioner object, got {precondition!r}")
    return _cg_loop(matvec, dot, b, x0, tol, maxiter, precond)
