"""Every f32 matrix product asks for full precision.

On a GPU an f32 ``dot`` without a ``precision`` may run in TF32 (about
three decimal digits), below ``Config.rtol_f32``. These tests trace the
f32 paths and require every f32 ``dot_general`` in the jaxpr, nested
jaxprs included, to carry ``Precision.HIGHEST``."""

import numpy as np
import pytest
import scipy.sparse as sps

import jax
import jax.numpy as jnp
from jax.extend import core as jcore

from spalinalg import BsrMatrix, CsrMatrix

_HIGHEST = jax.lax.Precision.HIGHEST


def _sub_jaxprs(v):
    if isinstance(v, jcore.ClosedJaxpr):
        yield v.jaxpr
    elif isinstance(v, jcore.Jaxpr):
        yield v
    elif isinstance(v, (tuple, list)):
        for e in v:
            yield from _sub_jaxprs(e)


def _f32_dots(jaxpr):
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general" and any(
                getattr(v.aval, "dtype", None) == jnp.float32
                for v in eqn.invars):
            yield eqn
        for v in eqn.params.values():
            for sub in _sub_jaxprs(v):
                yield from _f32_dots(sub)


def _assert_highest(fn, *args):
    dots = list(_f32_dots(jax.make_jaxpr(fn)(*args).jaxpr))
    assert dots, "expected at least one f32 dot_general"
    for eqn in dots:
        assert eqn.params["precision"] == (_HIGHEST, _HIGHEST), eqn


def _lap2d(k, dtype=np.float32):
    t = sps.diags([-1.0, 4.0, -1.0], [-1, 0, 1], shape=(k, k))
    A = (sps.kron(sps.eye(k), t) + sps.kron(
        sps.diags([-1.0, -1.0], [-1, 1], shape=(k, k)), sps.eye(k))).tocsr()
    A.sort_indices()
    return CsrMatrix(k * k, k * k, A.indptr, A.indices, A.data.astype(dtype))


def _bsr(rng):
    indptr = np.array([0, 2, 3])
    indices = np.array([0, 1, 1])
    data = rng.normal(size=(3, 16, 16)).astype(np.float32)
    return BsrMatrix(32, 32, 16, indptr, indices, data)


def test_bsr_spmv_and_spmm(rng):
    bsr = _bsr(rng)
    _assert_highest(lambda x: bsr @ x, jnp.ones(32, jnp.float32))
    _assert_highest(lambda X: bsr @ X, jnp.ones((32, 4), jnp.float32))


def test_bsr_gpu_spmm_dispatch_highest(rng, monkeypatch):
    """SpMM on the GPU dispatch runs the XLA einsum, at HIGHEST."""
    from spalinalg.ops import bsr_ops

    bsr = _bsr(rng)
    X = jnp.ones((32, 16), jnp.float32)
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    assert bsr_ops.bsr_path(bsr, X) == "xla"
    _assert_highest(lambda X: bsr @ X, X)


def test_supernodal_cholesky_factor_and_solve():
    from spalinalg.linalg import supernodal as sn
    from spalinalg.linalg.cholesky import cholesky

    A = _lap2d(8)
    fac = cholesky(A, method="supernodal")
    plan = fac.snf.plan
    _assert_highest(lambda v: sn._factor_all(plan, v), A.values)
    _assert_highest(lambda b: sn._solve_all(plan, fac.snf.panels, b),
                    jnp.ones(plan.n, jnp.float32))


def test_supernodal_lu_factor_and_solve():
    from spalinalg.linalg.lu import lu
    from spalinalg.linalg import supernodal_lu as slu

    sn = lu(_lap2d(6), method="supernodal").snlu
    # values of the symmetrized structure: one per assembled entry
    n_vals = 1 + max(int(bk.a_src.max(initial=0))
                     for lv in sn.plan.levels for bk in lv)
    _assert_highest(lambda v: slu._lu_factor_all(sn.plan, False, v),
                    jnp.ones(n_vals, jnp.float32))
    _assert_highest(
        lambda b: slu._lu_solve_all(sn.plan, sn.lu11, sn.perm11, sn.l21,
                                    sn.u12, b),
        jnp.ones(36, jnp.float32))


def test_banded_cholesky():
    from spalinalg.linalg.banded import (band_cholesky_factor,
                                         band_cholesky_solve)

    A = _lap2d(8)
    fac = band_cholesky_factor(A, bandwidth=8, panel=8)
    _assert_highest(lambda b: band_cholesky_solve(fac, b),
                    jnp.ones(64, jnp.float32))


@pytest.mark.parametrize("solver", ["gmres", "lanczos", "lobpcg", "cg"])
def test_krylov_and_eigen(solver):
    from spalinalg import linalg

    A = _lap2d(6)
    b = jnp.ones(36, jnp.float32)
    if solver == "gmres":
        fn = lambda b: linalg.gmres(A, b, tol=1e-6, restart=8,  # noqa
                                    maxiter=2).x
    elif solver == "lanczos":
        fn = lambda b: linalg.lanczos(A, 8, v0=b)[2]  # noqa: E731
    elif solver == "lobpcg":
        fn = lambda b: linalg.lobpcg(  # noqa: E731
            A, jnp.stack([b, b * jnp.arange(36.0, dtype=b.dtype)], 1),
            maxiter=2)[1]
    else:
        fn = lambda b: linalg.cg(A, b, tol=1e-6, maxiter=4).x  # noqa
    _assert_highest(fn, b)


def test_distributed_dot_and_bsr(rng):
    from spalinalg.parallel import (dist_bsr_spmv, dist_dot, make_row_mesh,
                                    partition_bsr, partition_csr,
                                    shard_bsr_vector, shard_vector)

    mesh = make_row_mesh(2)
    d = partition_csr(_lap2d(4), mesh)
    x = shard_vector(np.ones(16, np.float32), d)
    _assert_highest(lambda u: dist_dot(u, u, d), x)
    db = partition_bsr(_bsr(rng), mesh)
    xb = shard_bsr_vector(np.ones(32, np.float32), db)
    _assert_highest(lambda v: dist_bsr_spmv(db, v), xb)
