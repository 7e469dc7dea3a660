"""Autodiff through sparse ops: value-gradients of SpMV/SpMM/SpGEMM numeric
phases (the functional-transform dividend of the pytree design — nothing in
the reference corresponds to this)."""

import numpy as np

import jax
import jax.numpy as jnp

from spalinalg import CooMatrix, CsrMatrix


def _csr(rng, n, m, density=0.2):
    d = np.where(rng.random((n, m)) < density, rng.normal(size=(n, m)), 0)
    coo = CooMatrix(n, m)
    for i, j in zip(*np.nonzero(d)):
        coo.push(int(i), int(j), float(d[i, j]))
    return CsrMatrix.from_coo(coo), d


class TestGradSpmv:
    def test_grad_wrt_x(self, rng):
        a, d = _csr(rng, 12, 10)
        x = jnp.asarray(rng.normal(size=10))

        def f(v):
            return jnp.sum((a @ v) ** 2)

        g = jax.grad(f)(x)
        expected = 2 * d.T @ (d @ np.asarray(x))
        np.testing.assert_allclose(np.asarray(g), expected, rtol=1e-10)

    def test_grad_wrt_values(self, rng):
        a, d = _csr(rng, 8, 8)
        x = jnp.asarray(rng.normal(size=8))
        w = jnp.asarray(rng.normal(size=8))

        def f(values):
            return jnp.vdot(w, a.with_values(values) @ x)

        g = jax.grad(f)(a.values)
        # d/dv_k (w^T A x) = w_row(k) * x_col(k)
        rows, cols, _ = a._coo_arrays_host()
        expected = np.asarray(w)[rows] * np.asarray(x)[cols]
        np.testing.assert_allclose(np.asarray(g), expected, rtol=1e-10)

    def test_jit_grad_compose(self, rng):
        a, d = _csr(rng, 10, 10)
        x = jnp.asarray(rng.normal(size=10))
        f = jax.jit(jax.grad(lambda v: jnp.sum(a @ v)))
        np.testing.assert_allclose(np.asarray(f(x)), d.sum(axis=0),
                                   rtol=1e-10)


class TestGradSpgemm:
    def test_grad_through_numeric_phase(self, rng):
        from spalinalg import spgemm_apply, spgemm_plan

        a, da = _csr(rng, 6, 6)
        b, db = _csr(rng, 6, 6)
        plan = spgemm_plan(a, b)

        def f(av):
            return jnp.sum(spgemm_apply(plan, av, b.values) ** 2)

        g = jax.grad(f)(a.values)
        assert g.shape == a.values.shape
        # numeric check against finite differences on one coordinate
        eps = 1e-6
        v0 = np.asarray(a.values)
        pert = v0.copy()
        pert[0] += eps
        f0 = float(f(jnp.asarray(v0)))
        f1 = float(f(jnp.asarray(pert)))
        np.testing.assert_allclose(float(g[0]), (f1 - f0) / eps,
                                   rtol=1e-3, atol=1e-6)


class TestVmap:
    def test_vmap_over_rhs_batch(self, rng):
        a, d = _csr(rng, 9, 9)
        X = jnp.asarray(rng.normal(size=(5, 9)))
        ys = jax.vmap(lambda v: a @ v)(X)
        np.testing.assert_allclose(np.asarray(ys), (d @ np.asarray(X).T).T,
                                   rtol=1e-10)
