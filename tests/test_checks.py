"""checkify device-validation + determinism audit + from_dense tests."""

import numpy as np
import pytest

import jax.numpy as jnp

from spalinalg import CooMatrix, CscMatrix, CsrMatrix
from spalinalg.utils.checks import checked_structure, determinism_audit


class TestCheckedStructure:
    def test_valid_passes(self):
        m = CsrMatrix(2, 2, [0, 1, 2], [0, 1], [1.0, 2.0])
        err = checked_structure(m)()
        err.throw()  # no exception

    def test_corrupt_minor_detected(self):
        m = CsrMatrix(2, 2, [0, 1, 2], [0, 1], [1.0, 2.0])
        bad = type(m)._from_parts(
            2, 2, m.rowptr, jnp.asarray([0, 7], dtype=jnp.int32), m.values
        )
        err = checked_structure(bad)()
        with pytest.raises(Exception, match="minor index out of range"):
            err.throw()

    def test_non_monotone_ptr_detected(self):
        m = CsrMatrix(2, 2, [0, 1, 2], [0, 1], [1.0, 2.0])
        bad = type(m)._from_parts(
            2, 2, jnp.asarray([0, 2, 1], dtype=jnp.int32), m.colind, m.values
        )
        err = checked_structure(bad)()
        with pytest.raises(Exception, match="monotone"):
            err.throw()


class TestDeterminism:
    def test_spmv_bitwise_deterministic(self, rng):
        d = np.where(rng.random((40, 40)) < 0.2, rng.normal(size=(40, 40)), 0)
        a = CsrMatrix.from_dense(d)
        x = jnp.asarray(rng.normal(size=40))
        assert determinism_audit(lambda v: a @ v, x)


class TestFromDense:
    def test_csr(self, rng):
        d = np.where(rng.random((7, 9)) < 0.4, rng.normal(size=(7, 9)), 0)
        a = CsrMatrix.from_dense(d)
        np.testing.assert_allclose(np.asarray(a.to_dense()), d, rtol=1e-15)
        assert a.nnz == np.count_nonzero(d)

    def test_csc(self, rng):
        d = np.where(rng.random((5, 6)) < 0.5, rng.normal(size=(5, 6)), 0)
        a = CscMatrix.from_dense(d)
        np.testing.assert_allclose(np.asarray(a.to_dense()), d, rtol=1e-15)

    def test_keep_zeros(self):
        d = np.zeros((2, 2))
        a = CsrMatrix.from_dense(d, drop_zeros=False)
        assert a.nnz == 4
