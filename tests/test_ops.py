"""Ops-tier tests — add/sub/neg on compressed formats and SpGEMM, using the
reference's hand-built golden cases (`csr/ops/add.rs:84-108`,
`csc/ops/mul.rs:70-100`) and randomised parity vs dense ground truth."""

import numpy as np
import pytest

import jax

from spalinalg import CooMatrix, CscMatrix, CsrMatrix, ShapeError


def dense(mat):
    return np.asarray(mat.to_dense())


class TestCompressedAddSub:
    def test_add_golden(self):
        # Matches the structure of the reference CSR add test
        # (csr/ops/add.rs:84-108): union structure, sorted indices.
        a = CsrMatrix(2, 3, [0, 2, 3], [0, 2, 1], [1.0, 2.0, 3.0])
        b = CsrMatrix(2, 3, [0, 1, 3], [2, 0, 1], [10.0, 20.0, 30.0])
        c = a + b
        np.testing.assert_array_equal(dense(c), dense(a) + dense(b))
        np.testing.assert_array_equal(np.asarray(c.rowptr), [0, 2, 4])
        np.testing.assert_array_equal(np.asarray(c.colind), [0, 2, 0, 1])
        np.testing.assert_array_equal(np.asarray(c.values),
                                      [1.0, 12.0, 20.0, 33.0])
        # exact capacity (reference asserts exactness, add.rs:105-107)
        assert c.nse == c.nnz == 4

    def test_add_keeps_cancellation_as_explicit_zero(self):
        # SURVEY.md §2.1: cancelled sums stay stored (stamp-set semantics)
        a = CsrMatrix(2, 2, [0, 1, 1], [0], [1.0])
        b = CsrMatrix(2, 2, [0, 1, 1], [0], [-1.0])
        c = a + b
        assert c.nnz == 1
        np.testing.assert_array_equal(np.asarray(c.values), [0.0])

    def test_sub(self):
        a = CsrMatrix(2, 2, [0, 1, 2], [0, 1], [5.0, 1.0])
        b = CsrMatrix(2, 2, [0, 2, 2], [0, 1], [2.0, 7.0])
        c = a - b
        np.testing.assert_array_equal(dense(c), dense(a) - dense(b))

    def test_add_shape_mismatch_panics(self):
        a = CsrMatrix(2, 2, [0, 0, 0], [], [])
        b = CsrMatrix(2, 3, [0, 0, 0], [], [])
        with pytest.raises(ShapeError):
            a + b

    def test_csc_add(self):
        # csc/ops/add.rs mirror — including non-square shapes, where the
        # reference's sub has a workspace-sizing bug we don't reproduce.
        a = CscMatrix(3, 2, [0, 1, 2], [0, 2], [1.0, 2.0])
        b = CscMatrix(3, 2, [0, 2, 2], [0, 1], [5.0, 6.0])
        c = a + b
        np.testing.assert_array_equal(dense(c), dense(a) + dense(b))

    def test_csc_sub_nonsquare(self):
        # regression guard for reference bug csc/ops/sub.rs:22-23
        a = CscMatrix(5, 2, [0, 1, 2], [0, 4], [1.0, 2.0])
        b = CscMatrix(5, 2, [0, 1, 1], [3], [7.0])
        c = a - b
        np.testing.assert_array_equal(dense(c), dense(a) - dense(b))

    def test_neg(self):
        a = CsrMatrix(2, 2, [0, 1, 2], [0, 1], [1.0, -2.0])
        np.testing.assert_array_equal(dense(-a), -dense(a))

    def test_add_under_jit_padded(self):
        # device path: static shapes, sentinel padding, same dense result
        a = CsrMatrix(2, 3, [0, 2, 3], [0, 2, 1], [1.0, 2.0, 3.0])
        b = CsrMatrix(2, 3, [0, 1, 3], [2, 0, 1], [10.0, 20.0, 30.0])

        @jax.jit
        def f(x, y):
            return x + y

        c = f(a, b)
        assert c.nse == a.nse + b.nse  # padded capacity
        assert c.nnz == 4              # logical union size
        np.testing.assert_array_equal(dense(c), dense(a) + dense(b))

    def test_random_add_parity(self, rng):
        for _ in range(5):
            n, m = 11, 7
            da = np.where(rng.random((n, m)) < 0.3, rng.normal(size=(n, m)), 0)
            db = np.where(rng.random((n, m)) < 0.3, rng.normal(size=(n, m)), 0)
            a = CsrMatrix.from_coo(_coo_of(da))
            b = CsrMatrix.from_coo(_coo_of(db))
            np.testing.assert_allclose(dense(a + b), da + db, rtol=1e-12)
            np.testing.assert_allclose(dense(a - b), da - db, rtol=1e-12)


def _coo_of(d):
    n, m = d.shape
    coo = CooMatrix(n, m)
    for i, j in zip(*np.nonzero(d)):
        coo.push(int(i), int(j), float(d[i, j]))
    return coo


class TestSpgemm:
    def test_csc_mul_golden(self):
        # The reference's only SpGEMM test: a real 5x3 · 3x4 case
        # (csc/ops/mul.rs:70-100). We reproduce the matrices from their
        # dense meaning and check the product densely plus structure
        # invariants (sorted unique indices).
        a_d = np.array([
            [1.0, 0.0, 2.0],
            [0.0, 3.0, 0.0],
            [4.0, 0.0, 0.0],
            [0.0, 0.0, 5.0],
            [6.0, 7.0, 0.0],
        ])
        b_d = np.array([
            [1.0, 0.0, 0.0, 2.0],
            [0.0, 3.0, 0.0, 0.0],
            [4.0, 0.0, 5.0, 0.0],
        ])
        a = CscMatrix.from_coo(_coo_of(a_d))
        b = CscMatrix.from_coo(_coo_of(b_d))
        c = a * b
        assert isinstance(c, CscMatrix)
        assert c.shape == (5, 4)
        np.testing.assert_allclose(dense(c), a_d @ b_d, rtol=1e-12)

    def test_csr_mul(self):
        # The reference has NO unit test for CSR mul (SURVEY.md C19 gap) —
        # we close it.
        a_d = np.array([[1.0, 2.0, 0.0], [0.0, 0.0, 3.0]])
        b_d = np.array([[0.0, 1.0], [2.0, 0.0], [0.0, 4.0]])
        a = CsrMatrix.from_coo(_coo_of(a_d))
        b = CsrMatrix.from_coo(_coo_of(b_d))
        c = a * b
        assert isinstance(c, CsrMatrix)
        np.testing.assert_allclose(dense(c), a_d @ b_d, rtol=1e-12)

    def test_matmul_operator(self):
        a = CsrMatrix.eye(3)
        b = CsrMatrix.eye(3)
        c = a @ b
        np.testing.assert_array_equal(dense(c), np.eye(3))

    def test_shape_mismatch_panics(self):
        a = CsrMatrix(2, 3, [0, 0, 0], [], [])
        b = CsrMatrix(2, 3, [0, 0, 0], [], [])
        with pytest.raises(ShapeError):
            a * b

    def test_keeps_structural_zeros(self):
        # Gustavson stamp-set semantics: entry exists even if sum cancels
        a = CsrMatrix(1, 2, [0, 2], [0, 1], [1.0, 1.0])
        b = CsrMatrix(2, 1, [0, 1, 2], [0, 0], [1.0, -1.0])
        c = a * b
        assert c.nnz == 1
        np.testing.assert_array_equal(np.asarray(c.values), [0.0])

    def test_sorted_unique_output(self, rng):
        n = 23
        da = np.where(rng.random((n, n)) < 0.2, rng.normal(size=(n, n)), 0)
        db = np.where(rng.random((n, n)) < 0.2, rng.normal(size=(n, n)), 0)
        a = CsrMatrix.from_coo(_coo_of(da))
        b = CsrMatrix.from_coo(_coo_of(db))
        c = a * b
        np.testing.assert_allclose(dense(c), da @ db, rtol=1e-10)
        ptr = np.asarray(c.rowptr)
        ind = np.asarray(c.colind)
        for r in range(n):
            seg = ind[ptr[r]:ptr[r + 1]]
            assert np.all(np.diff(seg) > 0)

    def test_plan_reuse_numeric_only(self):
        # symbolic/numeric split: same structure, new values
        from spalinalg import spgemm_apply, spgemm_plan
        a = CsrMatrix(2, 2, [0, 1, 2], [0, 1], [2.0, 3.0])
        b = CsrMatrix(2, 2, [0, 1, 2], [1, 0], [4.0, 5.0])
        plan = spgemm_plan(a, b)
        v1 = spgemm_apply(plan, a.values, b.values)
        v2 = spgemm_apply(plan, 2 * a.values, b.values)
        np.testing.assert_allclose(np.asarray(v2), 2 * np.asarray(v1))
