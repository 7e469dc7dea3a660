"""Direct-solve front door: ``spsolve`` / ``factorized`` — the
`scipy.sparse.linalg` entry points, dispatching into the factorization
tier (banded/supernodal Cholesky for SPD, banded/dense LU otherwise).

Examples
--------
>>> import numpy as np
>>> from spalinalg import CooMatrix, CsrMatrix
>>> from spalinalg.linalg import factorized, spsolve
>>> A = CsrMatrix(3, 3, [0, 2, 4, 6], [0, 1, 0, 1, 1, 2],
...               [4.0, 1.0, 1.0, 3.0, 1.0, 2.0])
>>> x = spsolve(A, np.array([5.0, 4.0, 3.0]))
>>> bool(np.allclose(A.to_dense() @ np.asarray(x), [5.0, 4.0, 3.0]))
True
>>> solve = factorized(A)              # factor once, solve many
>>> x2 = solve(np.array([1.0, 0.0, 0.0]))
>>> bool(np.allclose(A.to_dense() @ np.asarray(x2), [1.0, 0.0, 0.0]))
True
"""

from __future__ import annotations

from typing import Callable

import numpy as np

import jax.numpy as jnp

from ..errors import ShapeError

__all__ = ["spsolve", "factorized", "is_symmetric"]


def is_symmetric(csr, tol: float = 0.0) -> bool:
    """Host structure+values symmetry check (O(nnz log nnz) once)."""
    if csr.nrows != csr.ncols:
        return False
    r, c, v = csr._coo_arrays_host()
    r = np.asarray(r, dtype=np.int64)
    c = np.asarray(c, dtype=np.int64)
    v = np.asarray(v)
    # canonical order of A and of A^T must agree
    ka = np.lexsort((c, r))
    kt = np.lexsort((r, c))
    if not (np.array_equal(r[ka], c[kt]) and np.array_equal(c[ka], r[kt])):
        return False
    return bool(np.max(np.abs(v[ka] - v[kt]), initial=0.0) <= tol)


def factorized(A, *, assume_a: str = "auto") -> Callable:
    """Factor once, return a jit-compatible ``solve(b)`` closure.

    ``assume_a``: "pos" (SPD → Cholesky), "gen" (LU), "auto"
    (symmetry-check then attempt Cholesky with an LU fallback on a
    non-finite probe solve — the SPD test you can afford).
    """
    from .cholesky import cholesky, cholesky_solve
    from .lu import lu, lu_solve

    if A.shape[0] != A.shape[1]:
        raise ShapeError(f"spsolve needs a square matrix, got {A.shape}")
    if assume_a not in ("auto", "pos", "gen"):
        raise ValueError(f"assume_a must be auto|pos|gen, got {assume_a!r}")

    if assume_a == "pos":
        fac = cholesky(A)
        return lambda b: cholesky_solve(fac, jnp.asarray(b))
    if assume_a == "gen" or not is_symmetric(A, tol=0.0):
        fac = lu(A)
        return lambda b: lu_solve(fac, jnp.asarray(b))
    # auto + symmetric: try Cholesky, validate with a probe solve
    try:
        fac = cholesky(A)
        probe = cholesky_solve(fac, jnp.ones(A.shape[0],
                                             dtype=A.values.dtype))
        if bool(jnp.all(jnp.isfinite(probe))):
            return lambda b: cholesky_solve(fac, jnp.asarray(b))
    except Exception:
        pass
    fac = lu(A)
    return lambda b: lu_solve(fac, jnp.asarray(b))


def spsolve(A, b, *, assume_a: str = "auto"):
    """Solve ``A x = b`` directly (factor + solve in one call)."""
    return factorized(A, assume_a=assume_a)(b)
