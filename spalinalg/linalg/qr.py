"""Sparse QR / least squares (north-star N5; the reference documents the
intent for "matrix factorization (chol, qr, lu)" at `csr.rs:16-17` /
`csc.rs:16-17` without implementing it).

Design: rather than a row-by-row Givens/Householder sparse QR (deeply
sequential, scatter-heavy — the wrong shape for dense matmul units), the
factorization is the **corrected seminormal equations** form (Björck 1987):

1. ``AᵀA`` via the device-resident SpGEMM tier (one structure plan,
   device numeric phase);
2. ``AᵀA = RᵀR`` via the general sparse Cholesky pipeline (AMD ordering,
   elimination tree, supernodal multifrontal fronts batched on the device) —
   mathematically the same ``R`` as in ``A = QR``;
3. ``Q`` is kept **implicit**: ``Qᵀb = R(AᵀA)⁻¹Aᵀb`` and
   ``Qy = A R⁻¹y`` are applied through SpMV + the factor's triangular
   sweeps, so the (dense, m×n) ``Q`` never materializes.

Least-squares solves run one step of iterative refinement on the
seminormal equations (``RᵀR dx = Aᵀ(b - Ax)``), which restores
QR-grade accuracy for the well-scaled systems this framework targets;
pathologically ill-conditioned systems should use the dense Householder
fallback (``method="dense"``: `jnp.linalg.qr` on the device).

Examples
--------
>>> import numpy as np
>>> from spalinalg import CooMatrix, CsrMatrix
>>> from spalinalg.linalg import qr, qr_solve, lstsq
>>> # overdetermined 4x2 system
>>> A = CsrMatrix.from_coo(CooMatrix.with_entries(4, 2, [
...     (0, 0, 1.0), (1, 0, 1.0), (1, 1, 1.0),
...     (2, 1, 2.0), (3, 0, 3.0)]))
>>> b = np.array([1.0, 2.0, 2.0, 3.0])
>>> x = lstsq(A, b)
>>> ref = np.linalg.lstsq(A.to_dense(), b, rcond=None)[0]
>>> bool(np.allclose(np.asarray(x), ref, atol=1e-6))
True
>>> fac = qr(A)
>>> fac.shape
(4, 2)
>>> from spalinalg.linalg import qr_r_dense
>>> r = np.asarray(qr_r_dense(fac))       # R of A = QR (up to signs)
>>> bool(np.allclose(np.abs(r), np.abs(np.linalg.qr(A.to_dense())[1]),
...                  atol=1e-6))
True
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import jax
import jax.numpy as jnp

from ..errors import ShapeError
from .cholesky import CholeskyFactor, cholesky, cholesky_solve

__all__ = ["QrFactor", "qr", "qr_solve", "qr_q_apply", "qr_qt_apply",
           "qr_r_dense", "lstsq"]


@dataclass(frozen=True, eq=False)
class QrFactor:
    """Implicit sparse QR: ``R`` held as the Cholesky factor of ``AᵀA``.

    ``a`` is retained (structure + values reference, no copy) because the
    implicit ``Q = A R⁻¹`` is applied through it; ``gram`` (the sparse
    ``AᵀA``) is kept for on-demand explicit-``R`` extraction.
    """

    m: int
    n: int
    a: object                                # CsrMatrix (or format peer)
    chol: Optional[CholeskyFactor]           # RᵀR = AᵀA  (sparse path)
    at: Optional[object] = None              # cached Aᵀ (plan reuse)
    gram: Optional[object] = None            # sparse AᵀA
    dense_q: Optional[jax.Array] = None      # dense fallback factors
    dense_r: Optional[jax.Array] = None

    @property
    def shape(self):
        return (self.m, self.n)

    @property
    def is_dense(self) -> bool:
        return self.dense_r is not None


def qr(a, *, method: str = "auto", dense_threshold: int = 1024) -> QrFactor:
    """Factor ``A = QR`` (``m >= n``) with implicit ``Q``.

    ``method``: "auto" uses the sparse seminormal pipeline above
    ``dense_threshold`` columns and dense Householder below it;
    "sparse" / "dense" force a path. Raises :class:`ShapeError` for
    ``m < n`` (for minimum-norm underdetermined solves factor ``Aᵀ``).
    """
    m, n = a.shape
    if m < n:
        raise ShapeError(
            f"qr needs m >= n, got {m}x{n}; factor the transpose for "
            f"minimum-norm underdetermined solves"
        )
    if method not in ("auto", "sparse", "dense"):
        raise ValueError(f"unknown qr method {method!r}")
    if method == "dense" or (method == "auto" and n <= dense_threshold):
        q, r = jnp.linalg.qr(a.to_dense(), mode="reduced")
        return QrFactor(m=m, n=n, a=a, chol=None, dense_q=q, dense_r=r)
    at = a.transpose()
    gram = at * a                            # SpGEMM tier (ops/spgemm.py)
    return QrFactor(m=m, n=n, a=a, chol=cholesky(gram), at=at, gram=gram)


def _chol_solve(fac: CholeskyFactor, b) -> jax.Array:
    """``(RᵀR)⁻¹ b`` for 1-D or column-stacked 2-D ``b``."""
    if b.ndim == 1:
        return cholesky_solve(fac, b)
    return jnp.stack([cholesky_solve(fac, b[:, j])
                      for j in range(b.shape[1])], axis=1)


def qr_r_dense(fac: QrFactor) -> jax.Array:
    """The ``n×n`` upper-triangular ``R`` of ``A = QR`` (dense, device).

    Sparse path: one dense Cholesky of the retained sparse Gram matrix —
    ``R = chol(AᵀA)ᵀ``, unique given a positive diagonal. O(n²) memory;
    only materialized on request (matrix-free solves never need it).
    """
    if fac.is_dense:
        return fac.dense_r
    return jnp.linalg.cholesky(fac.gram.to_dense()).T


def qr_qt_apply(fac: QrFactor, b) -> jax.Array:
    """``Qᵀ b`` — projection coefficients, shape ``(n,)`` or ``(n, k)``.

    Sparse path: ``Qᵀb = R (RᵀR)⁻¹ Aᵀb`` (all factor applications, one
    SpMV, one dense triangular product)."""
    b = jnp.asarray(b)
    if fac.is_dense:
        return fac.dense_q.T @ b
    x = _chol_solve(fac.chol, fac.at @ b)
    return qr_r_dense(fac) @ x


def qr_q_apply(fac: QrFactor, y) -> jax.Array:
    """``Q y`` for coefficients ``y`` of shape ``(n,)``/``(n, k)`` → (m,…)."""
    y = jnp.asarray(y)
    if fac.is_dense:
        return fac.dense_q @ y
    from jax.scipy.linalg import solve_triangular

    x = solve_triangular(qr_r_dense(fac), y, lower=False)   # R⁻¹ y
    return fac.a @ x


def qr_solve(fac: QrFactor, b, *, refine: int = 1) -> jax.Array:
    """Least-squares solve ``min ‖Ax − b‖₂`` from a :func:`qr` factor.

    ``refine`` iterations of corrected seminormal refinement
    (``RᵀR dx = Aᵀ(b − Ax)``) recover QR-grade accuracy on the sparse
    path; the dense path solves ``Rx = Qᵀb`` directly.
    """
    b = jnp.asarray(b)
    if fac.is_dense:
        from jax.scipy.linalg import solve_triangular

        return solve_triangular(fac.dense_r, fac.dense_q.T @ b, lower=False)
    at = fac.at
    x = _chol_solve(fac.chol, at @ b)
    for _ in range(max(0, refine)):
        resid = b - fac.a @ x
        x = x + _chol_solve(fac.chol, at @ resid)
    return x


def lstsq(a, b, *, refine: int = 1) -> jax.Array:
    """One-shot least squares: ``qr_solve(qr(a), b)``."""
    return qr_solve(qr(a), b, refine=refine)
