"""Krylov matrix functions: ``expm_multiply`` (the `scipy.sparse.linalg`
action-of-exponential, re-shaped for an accelerator).

``exp(tA) b`` is approximated on an m-dimensional Krylov space: one
Arnoldi sweep (the same full-basis GEMV orthogonalisation as
`iterative.gmres` — zero rows need no masking), then a *small* dense
``expm`` on the projected ``(m, m)`` Hessenberg matrix on device:

    exp(tA) b  ≈  β · V_mᵀ · expm(t H_m) e₁,   β = ‖b‖.

The SpMVs dominate; the m×m ``expm`` (`jax.scipy.linalg.expm`) is dense
device work. Everything jit-compatible — fixed m, no host round-trips.

Examples
--------
>>> import numpy as np
>>> from spalinalg import CooMatrix, CsrMatrix
>>> from spalinalg.linalg import expm_multiply
>>> # heat equation on a ring graph: exp(-tL) smooths a spike
>>> n = 16
>>> ent = [(i, i, -2.0) for i in range(n)]
>>> ent += [(i, (i + 1) % n, 1.0) for i in range(n)]
>>> ent += [((i + 1) % n, i, 1.0) for i in range(n)]
>>> L = CsrMatrix.from_coo(CooMatrix.with_entries(n, n, ent))
>>> b = np.zeros(n); b[n // 2] = 1.0
>>> u = expm_multiply(L, b, t=0.5)
>>> bool(abs(float(u.sum()) - 1.0) < 1e-8)    # mass conserved
True
>>> bool(float(u[n // 2]) < 1.0)               # spike diffused
True
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp

__all__ = ["expm_multiply", "arnoldi"]


def arnoldi(A, v0, m: int):
    """``m``-step Arnoldi: returns ``(V, H)`` with ``V`` ((m+1, n))
    orthonormal and ``H`` ((m+1, m)) upper Hessenberg, ``A V_i = V H``.

    Full-basis classical Gram-Schmidt with one re-orthogonalisation pass
    (zero rows make the unmasked products exact) — two GEMVs per step.
    """
    v0 = jnp.asarray(v0)
    dtype = v0.dtype
    beta = jnp.linalg.norm(v0)
    v0n = v0 / jnp.maximum(beta, 1e-300)
    V = jnp.zeros((m + 1,) + v0.shape, dtype).at[0].set(v0n)
    H = jnp.zeros((m + 1, m), dtype)

    def step(i, carry):
        V, H = carry
        w = A @ V[i]
        h = V @ w
        w = w - V.T @ h
        h2 = V @ w
        w = w - V.T @ h2
        h = h + h2
        wnorm = jnp.linalg.norm(w)
        vnext = jnp.where(wnorm > 1e-300, 1.0, 0.0) * w / jnp.maximum(
            wnorm, 1e-300)
        H = H.at[:, i].set(h).at[i + 1, i].set(wnorm)
        return V.at[i + 1].set(vnext), H

    V, H = jax.lax.fori_loop(0, m, step, (V, H))
    return V, H


def expm_multiply(A, b, *, t: float = 1.0, m: Optional[int] = None
                  ) -> jax.Array:
    """``exp(t A) @ b`` via an m-dimensional Krylov projection.

    ``m`` defaults to ``min(n, 32)``; raise it when ``‖tA‖`` is large
    (rule of thumb: ``m ≳ ‖tA‖`` for full accuracy — or split ``t`` into
    steps). Works for any square operand supporting ``A @ v``.
    """
    b = jnp.asarray(b)
    n = A.shape[0]
    if A.shape[0] != A.shape[1]:
        from ..errors import ShapeError

        raise ShapeError(f"expm_multiply needs a square operator, "
                         f"got {A.shape}")
    m = int(m) if m is not None else min(n, 32)
    beta = jnp.linalg.norm(b)
    V, H = arnoldi(A, b, m)
    Hm = H[:m, :m] * jnp.asarray(t, b.dtype)
    e1 = jnp.zeros(m, b.dtype).at[0].set(1.0)
    y = jax.scipy.linalg.expm(Hm) @ e1
    return beta * (V[:m].T @ y)
