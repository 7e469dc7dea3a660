"""Iterative solvers for general (non-SPD) systems: GMRES + BiCGSTAB.

Peers of :mod:`~spalinalg.linalg.cg` (the reference implements no
solvers at all — intent only, `csr.rs:16-17`); together the three cover
the standard Krylov triangle: CG for SPD, GMRES for general
nonsymmetric with strong convergence theory, BiCGSTAB for general
nonsymmetric at two SpMV per step and O(1) basis memory.

Shape (everything inside ``lax.while_loop`` / ``fori_loop``,
zero host round-trips per iteration):

- GMRES keeps the Krylov basis as one dense ``(m+1, n)`` array; the
  Arnoldi orthogonalisation step is a full-basis matmul pair
  (``h = V w``, ``w -= Vᵀ h``) — rows beyond the current step are zero,
  so no masking or dynamic slicing is needed and the work is two
  clean GEMVs. The small ``(m+1, m)`` least-squares problem
  is solved on device per restart.
- BiCGSTAB is a pure vector recurrence (two SpMVs + axpys per step).

Both accept single-chip CSR/CSC/BSR operands and row-partitioned
:class:`~spalinalg.parallel.partition.DistCsr` (SpMV via the
partition's halo/all-gather plan, reductions via ``psum``).

Examples
--------
>>> import numpy as np
>>> from spalinalg import CsrMatrix
>>> from spalinalg.linalg import gmres, bicgstab
>>> A = CsrMatrix(2, 2, [0, 2, 4], [0, 1, 0, 1], [4.0, 1.0, -1.0, 3.0])
>>> res = gmres(A, np.array([1.0, 2.0]), tol=1e-10)
>>> [round(float(v), 6) for v in res.x]
[0.076923, 0.692308]
>>> res = bicgstab(A, np.array([1.0, 2.0]), tol=1e-10)
>>> bool(res.residual < 1e-8)
True
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

# f32 products ask for full precision: on a GPU the default may be TF32
_HIGHEST = jax.lax.Precision.HIGHEST

__all__ = ["gmres", "bicgstab", "IterResult"]


class IterResult(NamedTuple):
    x: jax.Array
    iterations: jax.Array   # device scalar: matvec count
    residual: jax.Array     # final ||r||


def _operator(A, b, x0, maxiter_default):
    """Shared operand plumbing: (matvec, dot, x0, maxiter_scale)."""
    from ..parallel.partition import DistCsr

    if isinstance(A, DistCsr):
        from ..parallel.spmv import dist_dot, dist_spmv

        matvec = lambda v: dist_spmv(A, v)            # noqa: E731
        dot = lambda u, v: dist_dot(u, v, A)          # noqa: E731
        x0 = jnp.zeros_like(b) if x0 is None else x0
        return matvec, dot, x0, A.nrows
    matvec = lambda v: A @ v                          # noqa: E731
    dot = lambda u, v: jnp.vdot(u, v, precision=_HIGHEST)  # noqa: E731
    x0 = jnp.zeros(A.ncols, dtype=b.dtype) if x0 is None else x0
    return matvec, dot, x0, A.ncols


def _resolve_precond(M, A):
    """``M`` -> callable ``r -> M⁻¹r`` (identity when None)."""
    from ..parallel.partition import DistCsr

    if M is None:
        return None
    if hasattr(M, "solve"):
        if isinstance(A, DistCsr) and not getattr(M, "supports_dist", False):
            raise ValueError(
                "this preconditioner is single-chip; build it on the "
                "DistCsr operand (chebyshev) or pass a sharding-aware "
                "callable")
        return M.solve
    if callable(M):
        return M
    raise ValueError(f"M must be a callable or preconditioner object, "
                     f"got {M!r}")


def gmres(
    A,
    b,
    x0=None,
    *,
    tol: float = 1e-8,
    restart: int = 32,
    maxiter: Optional[int] = None,
    M=None,
) -> IterResult:
    """Restarted GMRES(m) for a general square system ``A x = b``.

    ``restart`` is the Krylov cycle length m (basis memory = ``(m+1)·n``);
    ``maxiter`` bounds the total matvec count (default ``10·n``).
    ``M`` right-preconditions (``A M⁻¹ u = b``, ``x = M⁻¹u`` — the
    reported residual stays the TRUE residual): a callable ``r -> M⁻¹r``
    or an object with ``.solve`` (:func:`~spalinalg.linalg.ilu0`).
    """
    b = jnp.asarray(b)
    matvec, dot, x, n = _operator(A, b, x0, None)
    psolve = _resolve_precond(M, A)
    if psolve is not None:
        inner_matvec = lambda v: matvec(psolve(v))    # noqa: E731
    else:
        inner_matvec = matvec
    maxiter = maxiter if maxiter is not None else 10 * n
    m = max(1, min(int(restart), maxiter))
    dtype = b.dtype
    bnorm = jnp.sqrt(jnp.real(dot(b, b)))
    atol = jnp.maximum(tol * bnorm, jnp.asarray(tol, dtype))

    def cycle(x):
        """One restart cycle: m Arnoldi steps + small dense LS solve."""
        r = b - matvec(x)
        beta = jnp.sqrt(jnp.real(dot(r, r)))
        v0 = jnp.where(beta > 0, 1.0 / jnp.maximum(beta, 1e-300), 0.0) * r
        V = jnp.zeros((m + 1,) + r.shape, dtype).at[0].set(v0)
        H = jnp.zeros((m + 1, m), dtype)

        def arnoldi(i, carry):
            V, H = carry
            w = inner_matvec(V[i])
            # rows > i of V are zero -> plain full-basis products suffice
            if V.ndim == 2:
                h = jnp.einsum("kn,n->k", V, w, precision=_HIGHEST)
                w = w - jnp.einsum("kn,k->n", V, h, precision=_HIGHEST)
                # one re-orthogonalisation pass (classical GS is unstable
                # unrepeated; twice is enough — Giraud et al.)
                h2 = jnp.einsum("kn,n->k", V, w, precision=_HIGHEST)
                w = w - jnp.einsum("kn,k->n", V, h2, precision=_HIGHEST)
                h = h + h2
            else:  # sharded operand: same algebra via the dist dot
                h = jax.vmap(lambda vk: dot(vk, w))(V)
                w = w - jnp.einsum("k,k...->...", h, V, precision=_HIGHEST)
                h2 = jax.vmap(lambda vk: dot(vk, w))(V)
                w = w - jnp.einsum("k,k...->...", h2, V, precision=_HIGHEST)
                h = h + h2
            wnorm = jnp.sqrt(jnp.real(dot(w, w)))
            H = H.at[:, i].set(h).at[i + 1, i].set(wnorm)
            vnext = jnp.where(wnorm > 1e-300, 1.0 / jnp.maximum(wnorm, 1e-300), 0.0) * w
            return V.at[i + 1].set(vnext), H

        V, H = jax.lax.fori_loop(0, m, arnoldi, (V, H))
        # min_y || beta e1 - H y ||  (m+1 x m, dense, on device)
        e1 = jnp.zeros(m + 1, dtype).at[0].set(beta)
        y = jnp.linalg.lstsq(H, e1)[0]
        corr = jnp.einsum("k,k...->...", y, V[:m], precision=_HIGHEST)
        if psolve is not None:
            corr = psolve(corr)           # right precond: x += M⁻¹ V y
        return x + corr

    def cond(state):
        x, res, it = state
        return jnp.logical_and(res > atol, it < maxiter)

    def body(state):
        x, _, it = state
        x = cycle(x)
        r = b - matvec(x)
        return x, jnp.sqrt(jnp.real(dot(r, r))), it + m + 1

    r0 = b - matvec(x)
    res0 = jnp.sqrt(jnp.real(dot(r0, r0)))
    x, res, it = jax.lax.while_loop(cond, body, (x, res0, jnp.asarray(0)))
    return IterResult(x=x, iterations=it, residual=res)


def bicgstab(
    A,
    b,
    x0=None,
    *,
    tol: float = 1e-8,
    maxiter: Optional[int] = None,
    M=None,
) -> IterResult:
    """BiCGSTAB for a general square system (two SpMVs per iteration).

    ``M`` right-preconditions (the reported residual stays the true
    residual): a callable or a ``.solve`` object (:func:`ilu0`)."""
    b = jnp.asarray(b)
    matvec, dot, x, n = _operator(A, b, x0, None)
    psolve = _resolve_precond(M, A) or (lambda r: r)
    maxiter = maxiter if maxiter is not None else 10 * n
    dtype = b.dtype
    bnorm = jnp.sqrt(jnp.real(dot(b, b)))
    atol = jnp.maximum(tol * bnorm, jnp.asarray(tol, dtype))
    eps = jnp.asarray(1e-300, dtype)

    r0 = b - matvec(x)
    rhat = r0

    def cond(state):
        x, r, p, v, rho, alpha, omega, it, res = state
        return jnp.logical_and(res > atol, it < maxiter)

    def body(state):
        x, r, p, v, rho, alpha, omega, it, res = state
        rho_new = dot(rhat, r)
        beta = (rho_new / jnp.where(jnp.abs(rho) > 0, rho, eps)) * (
            alpha / jnp.where(jnp.abs(omega) > 0, omega, eps))
        p = r + beta * (p - omega * v)
        phat = psolve(p)
        v = matvec(phat)
        denom = dot(rhat, v)
        alpha = rho_new / jnp.where(jnp.abs(denom) > 0, denom, eps)
        s = r - alpha * v
        shat = psolve(s)
        t = matvec(shat)
        tt = dot(t, t)
        omega = dot(t, s) / jnp.where(jnp.abs(tt) > 0, tt, eps)
        x = x + alpha * phat + omega * shat
        r = s - omega * t
        res = jnp.sqrt(jnp.real(dot(r, r)))
        return x, r, p, v, rho_new, alpha, omega, it + 2, res

    z = jnp.zeros_like(b)
    one = jnp.asarray(1.0, dtype)
    res0 = jnp.sqrt(jnp.real(dot(r0, r0)))
    state = (x, r0, z, z, one, one, one, jnp.asarray(0), res0)
    x, r, *_, it, res = jax.lax.while_loop(cond, body, state)
    return IterResult(x=x, iterations=it, residual=res)
