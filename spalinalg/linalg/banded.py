"""Blocked banded factorizations: the dense-panel core of the N5 tier.

Sparse direct factorization is mapped to **dense panel work inside a
``lax.scan``** (SURVEY.md §7 phase 5): after a bandwidth-reducing ordering
(RCM, `ordering.py`), an SPD/banded matrix factors panel-by-panel where each
step is dense Cholesky/LU of an ``nb × nb`` block, a triangular solve of the
``b × nb`` sub-panel, and a ``b × b`` Schur (syrk) update — all dense
matmuls. Sequential depth is ``n/nb`` instead of ``n``.

Window invariant: when factoring panel columns ``[j, j+nb)`` of a matrix
with half-bandwidth ``b``, all affected entries live in the ``m × m`` window
``m = nb + b`` starting at ``j`` — band fill never escapes it. The scan
carries the window Schur complement; per-panel "new border" slabs of the
original matrix are precomputed host-side.

This replaces nothing in the reference — factorization there is documented
intent only (`csr.rs:16-17`).
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import Tuple

import numpy as np

import jax
import jax.numpy as jnp
from jax.scipy.linalg import solve_triangular

# f32 products ask for full precision: on a GPU the default may be TF32
_mm = partial(jnp.matmul, precision=jax.lax.Precision.HIGHEST)

__all__ = [
    "BandCholeskyFactor",
    "BandLuFactor",
    "band_cholesky_factor",
    "band_cholesky_solve",
    "band_lu_factor",
    "band_lu_solve",
]


def _band_slabs(csr, b: int, nb: int):
    """Host-side: per-panel (m, m) dense border slabs + padded size.

    Slab ``p`` holds the window ``A[j:j+m, j:j+m]`` (``j = p*nb``) with the
    region already covered by the previous window zeroed (rows & cols both
    ``< m - nb``); slab 0 is the full first window. Padding rows get a unit
    diagonal so Cholesky stays defined.
    """
    n = csr.nrows
    m = nb + b
    P = -(-n // nb)
    n_pad = P * nb

    ptr = np.asarray(csr._ptr, dtype=np.int64)
    ind = np.asarray(csr._minor, dtype=np.int64)[: int(ptr[-1])]
    val = np.asarray(csr._values)[: int(ptr[-1])]
    rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(ptr))

    slabs = np.zeros((P, m, m), dtype=val.dtype)
    # Scatter every entry into every window that contains it.
    # Entry (i, j_) lives in window p iff p*nb <= i,j_ < p*nb + m.
    p_lo = np.maximum(0, (np.maximum(rows, ind) - m) // nb + 1)
    p_hi = np.minimum(P - 1, np.minimum(rows, ind) // nb)
    for p in range(P):
        sel = (p_lo <= p) & (p <= p_hi)
        r = rows[sel] - p * nb
        c = ind[sel] - p * nb
        v = val[sel]
        if p > 0:
            new = (r >= m - nb) | (c >= m - nb)
            r, c, v = r[new], c[new], v[new]
        slabs[p, r, c] = v
    # Unit diagonal on padding rows (indices >= n), each added exactly once:
    # window 0 owns [0, m), window p >= 1 owns its fresh [m-nb, m) slice.
    for p in range(P):
        local = np.arange(m)
        is_pad = local + p * nb >= n
        if p > 0:
            is_pad &= local >= m - nb
        slabs[p, local[is_pad], local[is_pad]] = 1.0
    return slabs, P, n_pad, m


@dataclass(frozen=True, eq=False)
class BandCholeskyFactor:
    """Panelled banded Cholesky factor: ``panels[p] = [L11; L21]`` (m × nb)."""

    panels: jax.Array  # (P, m, nb)
    n: int
    n_pad: int
    nb: int
    b: int

    @property
    def m(self) -> int:
        return self.nb + self.b


@partial(jax.jit, static_argnames=("nb", "b"))
def _chol_scan(slabs, *, nb: int, b: int):
    m = nb + b

    def step(S, N):
        S = S + N
        L11 = jnp.linalg.cholesky(S[:nb, :nb])
        L21 = solve_triangular(L11, S[nb:, :nb].T, lower=True).T
        S22 = S[nb:, nb:] - _mm(L21, L21.T)
        S_next = jnp.zeros_like(S).at[:b, :b].set(S22)
        return S_next, jnp.concatenate([jnp.tril(L11), L21], axis=0)

    _, panels = jax.lax.scan(step, jnp.zeros((m, m), slabs.dtype), slabs)
    return panels


def band_cholesky_factor(csr, *, bandwidth: int, panel: int = 64
                         ) -> BandCholeskyFactor:
    """Factor a banded SPD CSR matrix: ``A = L Lᵀ`` with L banded."""
    nb = max(1, min(panel, csr.nrows))
    b = max(int(bandwidth), 1)
    slabs, P, n_pad, m = _band_slabs(csr, b, nb)
    panels = _chol_scan(jnp.asarray(slabs), nb=nb, b=b)
    return BandCholeskyFactor(panels=panels, n=csr.nrows, n_pad=n_pad,
                              nb=nb, b=b)


@partial(jax.jit, static_argnames=("nb", "b", "n_pad"))
def _chol_solve(panels, rhs, *, nb: int, b: int, n_pad: int):
    # forward: L y = rhs
    rhs = rhs.reshape(-1, nb)  # (P, nb)

    def fwd(acc, inp):
        Lp, r = inp
        L11, L21 = Lp[:nb], Lp[nb:]
        y1 = solve_triangular(L11, r - acc[:nb], lower=True)
        acc = jnp.concatenate([acc[nb:], jnp.zeros(nb, acc.dtype)])
        acc = acc.at[:b].add(_mm(L21, y1))
        return acc, y1

    m = nb + b
    _, y = jax.lax.scan(fwd, jnp.zeros(m, rhs.dtype), (panels, rhs))

    # backward: Lᵀ x = y
    def bwd(xnext, inp):
        Lp, yp = inp
        L11, L21 = Lp[:nb], Lp[nb:]
        x1 = solve_triangular(L11.T, yp - _mm(L21.T, xnext), lower=False)
        xnext = jnp.concatenate([x1, xnext])[:b]
        return xnext, x1

    _, x = jax.lax.scan(bwd, jnp.zeros(b, rhs.dtype), (panels, y),
                        reverse=True)
    return x.reshape(n_pad)


def band_cholesky_solve(fac: BandCholeskyFactor, rhs: jax.Array) -> jax.Array:
    """Solve ``A x = rhs`` from a banded Cholesky factor (two panelled
    triangular sweeps, forward + reverse scan)."""
    pad = fac.n_pad - fac.n
    r = jnp.pad(jnp.asarray(rhs), (0, pad))
    x = _chol_solve(fac.panels, r, nb=fac.nb, b=fac.b, n_pad=fac.n_pad)
    return x[: fac.n]


# ----------------------------------------------------------------------
# Banded LU (no pivoting — diagonally-dominant / RCM-ordered systems)
# ----------------------------------------------------------------------


@dataclass(frozen=True, eq=False)
class BandLuFactor:
    """Panelled banded LU (no pivoting): per panel ``[L11\\U11; L21]`` and
    ``U12`` strips."""

    panels: jax.Array  # (P, m, nb)  rows [:nb] hold L11 (unit) + U11, rows [nb:] hold L21
    u12: jax.Array     # (P, nb, b)  the U12 strip right of the diagonal block
    n: int
    n_pad: int
    nb: int
    b: int


def _lu_nopivot(M):
    """Dense in-window LU without pivoting via Doolittle steps."""
    nb = M.shape[0]

    def body(k, M):
        piv = M[k, k]
        factors = jnp.where(jnp.arange(nb) > k, M[:, k] / piv, 0.0)
        M = M - jnp.outer(factors, jnp.where(jnp.arange(nb) >= k, M[k, :], 0.0))
        M = M.at[:, k].set(jnp.where(jnp.arange(nb) > k, factors, M[:, k]))
        return M

    return jax.lax.fori_loop(0, nb, body, M)


@partial(jax.jit, static_argnames=("nb", "b"))
def _lu_scan(slabs, *, nb: int, b: int):
    m = nb + b

    def step(S, N):
        S = S + N
        LU11 = _lu_nopivot(S[:nb, :nb])
        L11 = jnp.tril(LU11, -1) + jnp.eye(nb, dtype=S.dtype)
        U11 = jnp.triu(LU11)
        L21 = solve_triangular(U11.T, S[nb:, :nb].T, lower=True).T
        U12 = solve_triangular(L11, S[:nb, nb:], lower=True)
        S22 = S[nb:, nb:] - _mm(L21, U12)
        S_next = jnp.zeros_like(S).at[:b, :b].set(S22)
        return S_next, (jnp.concatenate([LU11, L21], axis=0), U12)

    _, (panels, u12) = jax.lax.scan(step, jnp.zeros((m, m), slabs.dtype), slabs)
    return panels, u12


def band_lu_factor(csr, *, bandwidth: int, panel: int = 64) -> BandLuFactor:
    """Factor a banded CSR matrix ``A = L U`` (no pivoting)."""
    nb = max(1, min(panel, csr.nrows))
    b = max(int(bandwidth), 1)
    slabs, P, n_pad, m = _band_slabs(csr, b, nb)
    panels, u12 = _lu_scan(jnp.asarray(slabs), nb=nb, b=b)
    return BandLuFactor(panels=panels, u12=u12, n=csr.nrows, n_pad=n_pad,
                        nb=nb, b=b)


@partial(jax.jit, static_argnames=("nb", "b", "n_pad"))
def _lu_solve(panels, u12, rhs, *, nb: int, b: int, n_pad: int):
    rhs = rhs.reshape(-1, nb)
    m = nb + b

    def fwd(acc, inp):
        Lp, r = inp
        LU11, L21 = Lp[:nb], Lp[nb:]
        L11 = jnp.tril(LU11, -1) + jnp.eye(nb, dtype=LU11.dtype)
        y1 = solve_triangular(L11, r - acc[:nb], lower=True)
        acc = jnp.concatenate([acc[nb:], jnp.zeros(nb, acc.dtype)])
        acc = acc.at[:b].add(_mm(L21, y1))
        return acc, y1

    _, y = jax.lax.scan(fwd, jnp.zeros(m, rhs.dtype), (panels, rhs))

    def bwd(xnext, inp):
        Lp, U12p, yp = inp
        U11 = jnp.triu(Lp[:nb])
        x1 = solve_triangular(U11, yp - _mm(U12p, xnext), lower=False)
        xnext = jnp.concatenate([x1, xnext])[:b]
        return xnext, x1

    _, x = jax.lax.scan(bwd, jnp.zeros(b, rhs.dtype), (panels, u12, y),
                        reverse=True)
    return x.reshape(n_pad)


def band_lu_solve(fac: BandLuFactor, rhs: jax.Array) -> jax.Array:
    """Solve ``A x = rhs`` from a banded LU factor."""
    pad = fac.n_pad - fac.n
    r = jnp.pad(jnp.asarray(rhs), (0, pad))
    x = _lu_solve(fac.panels, fac.u12, r, nb=fac.nb, b=fac.b, n_pad=fac.n_pad)
    return x[: fac.n]
