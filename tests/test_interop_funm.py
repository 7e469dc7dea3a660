"""BCOO/BCSR interop (`io/jax_interop.py`) + Krylov expm (`linalg/funm.py`)."""

import numpy as np
import pytest

import jax.numpy as jnp
from jax.experimental import sparse as jsparse

from spalinalg import BsrMatrix, CooMatrix, CsrMatrix, DokMatrix
from spalinalg.errors import ShapeError
from spalinalg.io import from_bcoo, to_bcoo, to_bcsr
from spalinalg.linalg import expm_multiply


def _rand_csr(rng, n, m, density=0.1):
    d = np.where(rng.random((n, m)) < density, rng.normal(size=(n, m)), 0)
    rows, cols = np.nonzero(d)
    return CsrMatrix.from_coo(CooMatrix.with_triplets(
        n, m, rows.tolist(), cols.tolist(), d[rows, cols].tolist())), d


class TestBcoo:
    def test_csr_roundtrip(self, rng):
        csr, d = _rand_csr(rng, 40, 30)
        bc = to_bcoo(csr)
        assert bc.shape == (40, 30)
        np.testing.assert_allclose(np.asarray(bc.todense()), d, atol=1e-12)
        back = from_bcoo(bc)
        np.testing.assert_allclose(np.asarray(back.to_dense()), d, atol=1e-12)

    def test_all_formats_export(self, rng):
        csr, d = _rand_csr(rng, 32, 32, 0.2)
        for mat in (csr, csr.to_csc(), csr.to_coo(), csr.to_dok(),
                    csr.to_bsr(8)):
            bc = to_bcoo(mat)
            np.testing.assert_allclose(np.asarray(bc.todense()), d,
                                       atol=1e-12)

    def test_coo_duplicates_preserved(self):
        coo = CooMatrix.with_entries(2, 2, [(0, 0, 1.0), (0, 0, 2.0)])
        bc = to_bcoo(coo)
        assert int(bc.nse) == 2
        assert float(bc.todense()[0, 0]) == 3.0

    def test_from_bcoo_dedup_sums(self):
        idx = jnp.asarray([[0, 0], [0, 0], [1, 2]])
        bc = jsparse.BCOO((jnp.asarray([1.0, 2.0, 3.0]), idx), shape=(2, 3))
        m = from_bcoo(bc)
        assert float(np.asarray(m.to_dense())[0, 0]) == 3.0

    def test_bcsr_matvec_parity(self, rng):
        csr, d = _rand_csr(rng, 40, 40)
        x = rng.normal(size=40)
        np.testing.assert_allclose(
            np.asarray(to_bcsr(csr) @ jnp.asarray(x)), d @ x, atol=1e-10)

    def test_bcsr_rejects_non_csr(self, rng):
        with pytest.raises(ShapeError):
            to_bcsr(CooMatrix.with_entries(2, 2, [(0, 0, 1.0)]))

    def test_from_bcoo_rejects_batched(self, rng):
        dense = jnp.asarray(rng.normal(size=(2, 3, 4)))
        bc = jsparse.BCOO.fromdense(dense, n_batch=1)
        with pytest.raises(ShapeError):
            from_bcoo(bc)


class TestExpm:
    def test_matches_dense_expm(self, rng):
        from scipy.linalg import expm as dense_expm

        n = 40
        d = np.where(rng.random((n, n)) < 0.15, rng.normal(size=(n, n)), 0)
        d = d * 0.3
        rows, cols = np.nonzero(d)
        A = CsrMatrix.from_coo(CooMatrix.with_triplets(
            n, n, rows.tolist(), cols.tolist(), d[rows, cols].tolist()))
        b = rng.normal(size=n)
        u = expm_multiply(A, b, t=1.0, m=n)
        np.testing.assert_allclose(np.asarray(u), dense_expm(d) @ b,
                                   atol=1e-8)

    def test_heat_decay(self, rng):
        # graph Laplacian: exp(-tL) converges to the mean
        n = 12
        ent = [(i, i, -2.0) for i in range(n)]
        ent += [(i, (i + 1) % n, 1.0) for i in range(n)]
        ent += [((i + 1) % n, i, 1.0) for i in range(n)]
        L = CsrMatrix.from_coo(CooMatrix.with_entries(n, n, ent))
        b = rng.normal(size=n)
        u = np.asarray(expm_multiply(L, b, t=50.0, m=n))
        np.testing.assert_allclose(u, np.full(n, b.mean()), atol=1e-6)

    def test_t_scaling(self, rng):
        from scipy.linalg import expm as dense_expm

        n = 24
        d = np.diag(rng.normal(size=n) * 0.5)
        A = CsrMatrix.from_coo(CooMatrix.with_entries(
            n, n, [(i, i, float(d[i, i])) for i in range(n)]))
        b = np.ones(n)
        for t in (0.1, 2.0):
            u = expm_multiply(A, b, t=t, m=n)
            np.testing.assert_allclose(np.asarray(u), dense_expm(t * d) @ b,
                                       atol=1e-8)

    def test_rejects_rectangular(self, rng):
        csr, _ = _rand_csr(rng, 4, 6)
        with pytest.raises(ShapeError):
            expm_multiply(csr, np.ones(6))
