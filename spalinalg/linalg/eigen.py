"""Sparse eigensolvers + singular values: Lanczos ``eigsh`` and ``svds``.

Beyond-reference capability (the reference stops at arithmetic ops): the
standard sparse-linalg expectation set by `scipy.sparse.linalg`. Shape:
the Lanczos basis lives as one dense ``(m+1, n)`` array and each
step's full reorthogonalisation is two full-basis GEMVs (zero rows make
masking unnecessary — the same trick as GMRES in `iterative.py`), so the
hot loop is SpMV + dense GEMV work inside ``lax.fori_loop``. The small
``(m, m)`` tridiagonal eigenproblem solves on device with `jnp.linalg.eigh`.

Examples
--------
>>> import numpy as np
>>> from spalinalg import CooMatrix, CsrMatrix
>>> from spalinalg.linalg import eigsh
>>> # 1-D Laplacian: eigenvalues 2 - 2 cos(k pi / (n+1))
>>> n = 32
>>> ent = [(i, i, 2.0) for i in range(n)]
>>> ent += [(i, i + 1, -1.0) for i in range(n - 1)]
>>> ent += [(i + 1, i, -1.0) for i in range(n - 1)]
>>> A = CsrMatrix.from_coo(CooMatrix.with_entries(n, n, ent))
>>> w, v = eigsh(A, k=3, which="LA")
>>> expected = 2 - 2 * np.cos(np.arange(n, n - 3, -1) * np.pi / (n + 1))
>>> bool(np.allclose(np.asarray(w), np.sort(expected), atol=1e-6))
True
"""

from __future__ import annotations

from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp

# f32 products ask for full precision: on a GPU the default may be TF32
_HIGHEST = jax.lax.Precision.HIGHEST
_mm = partial(jnp.matmul, precision=_HIGHEST)

__all__ = ["eigsh", "svds", "lanczos", "block_lanczos", "lobpcg"]


def block_lanczos(A, m: int, b: int, *, seed: int = 0):
    """``m``-step block Lanczos with block size ``b`` and full
    reorthogonalisation. Returns an orthonormal basis ``V`` of shape
    ``(m*b, n)`` spanning the block-Krylov space.

    Block size ``b`` resolves eigenvalue clusters of multiplicity ≤ b —
    the single-vector caveat documented on :func:`eigsh`. Each step is
    one SpMM (``A`` on a ``(n, b)`` block), two full-basis
    GEMM orthogonalisations, and one thin QR.
    """
    n = A.shape[1] if hasattr(A, "shape") else A.ncols
    dt = jnp.float64 if _wants_x64(A) else jnp.float32
    v0 = jax.random.normal(jax.random.PRNGKey(seed), (n, b), dtype=dt)
    q0, _ = jnp.linalg.qr(v0, mode="reduced")              # (n, b)

    M = m * b
    V = jnp.zeros((M + b, n), dt).at[:b].set(q0.T)

    def step(i, V):
        lo = i * b
        blk = jax.lax.dynamic_slice_in_dim(V, lo, b, axis=0)   # (b, n)
        W = (A @ blk.T)                                        # (n, b) SpMM
        # full reorthogonalisation, twice (rows beyond lo+b are zero)
        W = W - _mm(V.T, _mm(V, W))
        W = W - _mm(V.T, _mm(V, W))
        Q, _ = jnp.linalg.qr(W, mode="reduced")
        return jax.lax.dynamic_update_slice_in_dim(V, Q.T, lo + b, axis=0)

    V = jax.lax.fori_loop(0, m, step, V)
    return V[:M]


def lanczos(A, m: int, *, v0=None, seed: int = 0):
    """``m``-step Lanczos with full reorthogonalisation.

    Returns ``(alpha, beta, V)``: the tridiagonal coefficients
    (``alpha`` (m,), ``beta`` (m-1,)) and the orthonormal basis
    ``V`` ((m, n)). ``A`` is any operand supporting ``A @ v`` (CSR, CSC,
    BSR, dense). Fixed iteration count — jit-static shapes.
    """
    n = A.shape[1] if hasattr(A, "shape") else A.ncols
    if v0 is None:
        dt = jnp.float64 if _wants_x64(A) else jnp.float32
        v0 = jax.random.normal(jax.random.PRNGKey(seed), (n,), dtype=dt)
        from ..parallel.partition import DistCsr

        if isinstance(A, DistCsr):
            # padded sharded operand vector (pads zero: they stay zero
            # through SpMV and orthogonalisation, so norms are exact)
            from ..parallel.spmv import shard_vector

            v0 = shard_vector(v0, A)
    v0 = jnp.asarray(v0)
    dtype = v0.dtype
    v0 = v0 / jnp.linalg.norm(v0)

    # basis length follows the operand vector (padded for DistCsr)
    V = jnp.zeros((m + 1, v0.shape[0]), dtype).at[0].set(v0)
    alpha = jnp.zeros(m, dtype)
    beta = jnp.zeros(m, dtype)

    def step(i, carry):
        V, alpha, beta = carry
        w = A @ V[i]
        a = jnp.vdot(V[i], w, precision=_HIGHEST)
        # full reorthogonalisation: project out the WHOLE current basis
        # (rows > i are zero so plain products are safe), twice.
        h = _mm(V, w)
        w = w - _mm(V.T, h)
        h2 = _mm(V, w)
        w = w - _mm(V.T, h2)
        b = jnp.linalg.norm(w)
        vnext = jnp.where(b > 1e-12, 1.0, 0.0) * w / jnp.maximum(b, 1e-300)
        return (V.at[i + 1].set(vnext),
                alpha.at[i].set(jnp.real(a)),
                beta.at[i].set(jnp.real(b)))

    V, alpha, beta = jax.lax.fori_loop(0, m, step, (V, alpha, beta))
    return alpha, beta[: m - 1], V[:m]


def _wants_x64(A) -> bool:
    try:
        return jnp.dtype(A.dtype) == jnp.float64
    except Exception:
        return False


class _ShiftInvertOp:
    """``(A - σI)⁻¹`` as a matvec operator via the factorization tier."""

    def __init__(self, A, sigma: float):
        from ..ops.construct import diags
        from .lu import lu

        n = A.shape[0]
        if sigma != 0.0:
            shift = diags([float(sigma)], offsets=[0], shape=(n, n))
            mat = A - shift
        else:
            mat = A
        self._fac = lu(mat)
        self.shape = A.shape
        self.dtype = getattr(A, "dtype", jnp.float64)

    def __matmul__(self, v):
        from .lu import lu_solve

        if v.ndim == 2:
            return jnp.stack([lu_solve(self._fac, v[:, j])
                              for j in range(v.shape[1])], axis=1)
        return lu_solve(self._fac, v)


def eigsh(A, k: int = 6, *, which: str = "LA", m: Optional[int] = None,
          v0=None, seed: int = 0, block: int = 1,
          sigma: Optional[float] = None
          ) -> Tuple[jax.Array, jax.Array]:
    """Top/bottom-``k`` eigenpairs of a symmetric sparse operator.

    ``which``: "LA" (largest algebraic) or "SA" (smallest algebraic).
    ``m`` is the Krylov size (default ``min(n, max(2k + 8, 32))``); with
    full reorthogonalisation the Ritz pairs converge at Lanczos speed —
    exterior eigenvalues first. Returns ``(w, v)`` with ``w`` ascending
    and ``v`` of shape ``(n, k)``.

    Caveat (inherent to single-vector Lanczos): a degenerate eigenvalue
    of multiplicity d > 1 surfaces only once per starting vector — the
    Krylov space contains one vector of each eigenspace. Pass
    ``block=b ≥ d`` to resolve clusters: the block variant
    (:func:`block_lanczos` + Rayleigh-Ritz) finds multiplicities up to
    the block size, at one SpMM (instead of SpMV) per step.
    """
    if sigma is not None:
        return _eigsh_shift_invert(A, k, sigma=sigma, m=m, seed=seed,
                                   block=block)
    if block > 1:
        return _eigsh_block(A, k, which=which, m=m, b=block, seed=seed)
    if which not in ("LA", "SA"):
        raise ValueError(f"which must be 'LA' or 'SA', got {which!r}")
    n = A.shape[0]
    if A.shape[0] != A.shape[1]:
        from ..errors import ShapeError

        raise ShapeError(f"eigsh needs a square operator, got {A.shape}")
    if not 0 < k < n:
        raise ValueError(f"need 0 < k < n, got k={k}, n={n}")
    m = int(m) if m is not None else min(n, max(2 * k + 8, 32))
    m = max(m, k + 1)

    alpha, beta, V = lanczos(A, m, v0=v0, seed=seed)
    T = (jnp.diag(alpha) + jnp.diag(beta, 1) + jnp.diag(beta, -1))
    w, y = jnp.linalg.eigh(T)             # ascending
    if which == "LA":
        w_k, y_k = w[-k:], y[:, -k:]
    else:
        w_k, y_k = w[:k], y[:, :k]
    v_k = _mm(V.T, y_k)                       # (n, k) Ritz vectors
    # normalise (padding rows of V are zero; Ritz vectors stay unit up to
    # breakdown, renormalise defensively)
    v_k = v_k / jnp.linalg.norm(v_k, axis=0, keepdims=True)
    return w_k, v_k


def _eigsh_shift_invert(A, k, *, sigma, m, seed, block=1):
    """Shift-invert mode: eigenvalues of ``A`` nearest ``σ``.

    Lanczos runs on ``(A - σI)⁻¹`` (one LU factorization at setup, one
    triangular-solve pair per step); Ritz values θ map back as
    ``λ = σ + 1/θ``, selected by largest ``|θ|`` (nearest σ first).
    The standard escape for slow exterior convergence — e.g. the
    smallest eigenvalues of a large Laplacian via ``sigma=0``.
    """
    n = A.shape[0]
    if not 0 < k < n:
        raise ValueError(f"need 0 < k < n, got k={k}, n={n}")
    op = _ShiftInvertOp(A, float(sigma))
    if block > 1:
        mb = int(m) if m is not None else max(2, -(-max(2 * k + 8, 24)
                                                   // block))
        V = block_lanczos(op, mb, block, seed=seed)
        AVt = op @ V.T
        T = _mm(V, AVt)
        T = (T + T.T) / 2.0
        theta, y = jnp.linalg.eigh(T)
    else:
        mm = int(m) if m is not None else min(n, max(2 * k + 8, 24))
        mm = max(mm, k + 1)
        alpha, beta, V = lanczos(op, mm, seed=seed)
        T = (jnp.diag(alpha) + jnp.diag(beta, 1) + jnp.diag(beta, -1))
        theta, y = jnp.linalg.eigh(T)
    idx = jnp.argsort(jnp.abs(theta))[-k:]                 # nearest sigma
    theta_k = theta[idx]
    lam = sigma + 1.0 / theta_k
    order = jnp.argsort(lam)
    lam = lam[order]
    y_k = y[:, idx][:, order]
    v_k = _mm(V.T, y_k)
    v_k = v_k / jnp.linalg.norm(v_k, axis=0, keepdims=True)
    return lam, v_k


def _eigsh_block(A, k, *, which, m, b, seed):
    """Block-Lanczos Rayleigh-Ritz path of :func:`eigsh`."""
    n = A.shape[0]
    if A.shape[0] != A.shape[1]:
        from ..errors import ShapeError

        raise ShapeError(f"eigsh needs a square operator, got {A.shape}")
    if not 0 < k < n:
        raise ValueError(f"need 0 < k < n, got k={k}, n={n}")
    m_blocks = (int(m) if m is not None
                else max(2, -(-max(2 * k + 8, 32) // b)))
    m_blocks = max(m_blocks, -(-(k + 1) // b))
    if m_blocks * b > n:
        m_blocks = max(1, n // b)
    V = block_lanczos(A, m_blocks, b, seed=seed)        # (M, n)
    AVt = A @ V.T                                       # (n, M) SpMM
    T = _mm(V, AVt)
    T = (T + T.T) / 2.0
    w, y = jnp.linalg.eigh(T)
    if which == "LA":
        w_k, y_k = w[-k:], y[:, -k:]
    else:
        w_k, y_k = w[:k], y[:, :k]
    v_k = _mm(V.T, y_k)
    v_k = v_k / jnp.linalg.norm(v_k, axis=0, keepdims=True)
    return w_k, v_k


def lobpcg(A, X0=None, k: Optional[int] = None, *, which: str = "SA",
           maxiter: int = 40, M=None, seed: int = 0
           ) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """Locally Optimal Block Preconditioned Conjugate Gradient.

    The preconditioned block eigensolver (Knyazev 2001): finds the ``k``
    extreme eigenpairs of a symmetric operator ``A`` without any
    factorization — the method of choice for the smallest eigenvalues of
    large SPD matrices (graph Laplacians, stiffness matrices) where
    shift-invert LU is too expensive and plain Lanczos converges slowly.

    Shape: the whole iteration is blocked GEMM work. Each step does
    one SpMM (``A @ S`` on the ``(n, 3k)`` trial block), one
    thin QR, and one ``(3k, 3k)`` dense ``eigh`` — all inside a
    ``lax.fori_loop`` with static shapes. A block size of one maps k
    scalar GEMVs; pick ``k`` ≥ 8 to keep the device busy.

    Parameters
    ----------
    A : operand with ``A @ X`` for ``(n, k)`` blocks (CSR/CSC/BSR/dense).
    X0 : optional ``(n, k)`` initial block; random if omitted (``k``
        must then be given).
    which : ``"SA"`` (smallest, default — the LOBPCG sweet spot) or
        ``"LA"``.
    M : optional preconditioner — a callable ``r -> M⁻¹r`` applied
        column-wise to the residual block, or an object with a
        ``.solve`` method (e.g. :func:`~spalinalg.linalg.ic0` /
        :func:`~spalinalg.linalg.chebyshev`).
    maxiter : fixed iteration count (jit-static; no data-dependent stop).

    Returns ``(w, X, resid)``: Ritz values (ascending), Ritz vectors
    ``(n, k)``, and per-pair residual norms ``‖A x - θ x‖``.

    Unlike single-vector Lanczos (see the :func:`eigsh` caveat), a block
    of size ``k`` resolves eigenvalue clusters of multiplicity ≤ k.

    ``A`` may be a row-partitioned
    :class:`~spalinalg.parallel.partition.DistCsr`: the block then
    lives as padded sharded columns (pad rows provably stay zero through
    the iteration) and each step's SpMM runs the distributed halo /
    all-gather path; ``M`` must then be sharding-aware (e.g.
    :func:`~spalinalg.linalg.chebyshev`).

    Examples
    --------
    >>> import numpy as np
    >>> from spalinalg import CooMatrix, CsrMatrix
    >>> from spalinalg.linalg import lobpcg
    >>> n = 64
    >>> ent = [(i, i, 2.0) for i in range(n)]
    >>> ent += [(i, i + 1, -1.0) for i in range(n - 1)]
    >>> ent += [(i + 1, i, -1.0) for i in range(n - 1)]
    >>> A = CsrMatrix.from_coo(CooMatrix.with_entries(n, n, ent))
    >>> w, X, r = lobpcg(A, k=3, maxiter=60, seed=1)
    >>> expected = 2 - 2 * np.cos(np.arange(1, 4) * np.pi / (n + 1))
    >>> bool(np.allclose(np.asarray(w), expected, atol=1e-5))
    True
    """
    if which not in ("SA", "LA"):
        raise ValueError(f"which must be 'SA' or 'LA', got {which!r}")
    n = A.shape[0]
    if A.shape[0] != A.shape[1]:
        from ..errors import ShapeError

        raise ShapeError(f"lobpcg needs a square operator, got {A.shape}")
    dt = jnp.float64 if _wants_x64(A) else jnp.float32
    from ..parallel.partition import DistCsr

    is_dist = isinstance(A, DistCsr)
    if X0 is None:
        if k is None:
            raise ValueError("lobpcg needs X0 or k")
        X0 = jax.random.normal(jax.random.PRNGKey(seed), (n, k), dtype=dt)
    X0 = jnp.asarray(X0, dt)
    if X0.ndim != 2 or X0.shape[0] != n:
        raise ValueError(f"X0 must be (n, k) = ({n}, k), got {X0.shape}")
    if k is not None and X0.shape[1] != k:
        raise ValueError(
            f"k={k} conflicts with X0.shape[1]={X0.shape[1]}; "
            "pass one or make them agree")
    k = X0.shape[1]
    if 3 * k > n:
        raise ValueError(
            f"lobpcg needs n ≥ 3k for its trial space, got n={n}, k={k} "
            "(use eigsh or a dense eigh at this size)")
    if is_dist:
        # Padded sharded operand blocks: pad rows start zero and every
        # iteration step preserves them (SpMM sentinel padding, residual
        # algebra, and QR of a full-column-rank block with zero rows all
        # keep those rows zero), so the padded operator's spurious zero
        # modes are never entered and the Ritz values are exact — the
        # same invariant :func:`lanczos` relies on for DistCsr.
        from ..parallel.spmv import shard_vector

        X0 = jnp.stack([shard_vector(X0[:, j], A) for j in range(k)],
                       axis=1)

    if M is None:
        psolve = None
    elif hasattr(M, "solve"):
        if is_dist and not getattr(M, "supports_dist", False):
            raise ValueError(
                "this preconditioner is single-chip; use a sharding-aware "
                "one (e.g. chebyshev) with DistCsr operands")
        psolve = M.solve
    elif callable(M):
        psolve = M
    else:
        raise TypeError("M must be a callable r -> M⁻¹r or have .solve")

    def _precond_block(R):
        if psolve is None:
            return R
        # preconditioners take vectors; vmap over columns would retrace
        # sparse triangular sweeps, so apply column-wise (k is small)
        cols = [psolve(R[:, j]) for j in range(k)]
        return jnp.stack(cols, axis=1)

    X, _ = jnp.linalg.qr(X0, mode="reduced")
    # P starts as a random orthonormal block: a zero P would hand QR a
    # rank-deficient trial matrix on step one. The junk directions are
    # harmless (Rayleigh-Ritz ignores them) and are replaced after one
    # step by true conjugate directions.
    P0 = jax.random.normal(jax.random.PRNGKey(seed + 1), (n, k), dtype=dt)
    if is_dist:
        from ..parallel.spmv import shard_vector

        P0 = jnp.stack([shard_vector(P0[:, j], A) for j in range(k)],
                       axis=1)
    P, _ = jnp.linalg.qr(P0 - _mm(X, _mm(X.T, P0)), mode="reduced")

    lo = 0 if which == "SA" else 2 * k
    hi = k if which == "SA" else 3 * k

    def step(i, carry):
        X, P = carry
        AX = A @ X                                     # (n, k) SpMM
        H = _mm(X.T, AX)
        R = AX - _mm(X, H)                                # block residual
        W = _precond_block(R)
        S = jnp.concatenate([X, W, P], axis=1)         # (n, 3k)
        Q, _ = jnp.linalg.qr(S, mode="reduced")
        AQ = A @ Q                                     # (n, 3k) SpMM
        T = _mm(Q.T, AQ)
        T = (T + T.T) / 2.0
        theta, Z = jnp.linalg.eigh(T)                  # ascending
        Zk = jax.lax.slice_in_dim(Z, lo, hi, axis=1)   # (3k, k)
        Xn = _mm(Q, Zk)
        # conjugate direction: the part of the update outside span(X),
        # re-orthonormalised (guarded against breakdown at convergence)
        Pn = Xn - _mm(X, _mm(X.T, Xn))
        Qp, Rp = jnp.linalg.qr(Pn, mode="reduced")
        good = jnp.abs(jnp.diagonal(Rp)) > 1e-10
        Pn = jnp.where(good[None, :], Qp, P)
        return Xn, Pn

    X, P = jax.lax.fori_loop(0, maxiter, step, (X, P))

    # final Rayleigh-Ritz on the converged block
    AX = A @ X
    T = _mm(X.T, AX)
    T = (T + T.T) / 2.0
    w, Z = jnp.linalg.eigh(T)
    X = _mm(X, Z)
    AX = _mm(AX, Z)
    resid = jnp.linalg.norm(AX - X * w[None, :], axis=0)
    return w, X, resid


def svds(A, k: int = 6, *, m: Optional[int] = None, seed: int = 0):
    """Top-``k`` singular triplets ``(u, s, vt)`` of a sparse matrix.

    Runs :func:`eigsh` on the Gram operator of the smaller side
    (``AᵀA`` or ``AAᵀ`` as a matrix-free product — two SpMVs per Lanczos
    step, no SpGEMM), then recovers the other factor by one projection.
    """
    from ..parallel.partition import DistCsr

    if isinstance(A, DistCsr):
        raise ValueError(
            "svds on DistCsr is unsupported (the A / Aᵀ operand vector "
            "spaces shard differently for rectangular operands) — gather "
            "with A.to_csr() first, or use eigsh on a pre-formed Gram "
            "operator")
    mm, nn = A.shape
    if not 0 < k < min(mm, nn):
        raise ValueError(f"need 0 < k < min(shape), got k={k}, {A.shape}")

    class _Gram:
        """Matrix-free symmetric operator for the smaller Gram side."""

        def __init__(self, a, side):
            self._a = a
            self._at = a.transpose()
            self._side = side
            s = nn if side == "right" else mm
            self.shape = (s, s)
            self.dtype = a.dtype

        def __matmul__(self, v):
            if self._side == "right":
                return self._at @ (self._a @ v)
            return self._a @ (self._at @ v)

    side = "right" if nn <= mm else "left"
    g = _Gram(A, side)
    w, vecs = eigsh(g, k=k, which="LA", m=m, seed=seed)
    s = jnp.sqrt(jnp.maximum(w, 0.0))[::-1]          # descending
    vecs = vecs[:, ::-1]
    inv_s = jnp.where(s > 0, 1.0 / jnp.maximum(s, 1e-300), 0.0)
    if side == "right":
        v = vecs                                      # (n, k)
        u = (A @ v) * inv_s[None, :]                  # (m, k)
    else:
        u = vecs                                      # (m, k)
        v = (A.transpose() @ u) * inv_s[None, :]      # (n, k)
    return u, s, v.T
