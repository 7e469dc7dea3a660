"""SpMV / SpMM tests (N1/N2): plan fast path vs segment_sum fallback vs
dense oracle, padding safety, dtypes, BSR products."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from spalinalg import (
    BsrMatrix,
    CooMatrix,
    CscMatrix,
    CsrMatrix,
    ShapeError,
    csr_matvec,
)
from spalinalg.ops.reduction import build_segment_reduce_plan, segment_reduce


def _random_csr(rng, n, m, density=0.1, dtype=np.float64):
    d = np.where(rng.random((n, m)) < density, rng.normal(size=(n, m)), 0)
    coo = CooMatrix(n, m, dtype=dtype)
    for i, j in zip(*np.nonzero(d)):
        coo.push(int(i), int(j), float(d[i, j]))
    return CsrMatrix.from_coo(coo), d.astype(dtype)


class TestSegmentReduce:
    def test_simple_groups(self):
        plan = build_segment_reduce_plan([3, 0, 2, 1])
        stream = jnp.asarray([1.0, 2.0, 3.0, 10.0, 20.0, 5.0])
        out = segment_reduce(plan, stream)
        np.testing.assert_allclose(np.asarray(out), [6.0, 0.0, 30.0, 5.0])

    def test_wide_group_hierarchical(self):
        # force multi-level: one group wider than max_width
        sizes = [2000, 3, 700]
        rng = np.random.default_rng(7)
        stream = rng.normal(size=sum(sizes))
        plan = build_segment_reduce_plan(sizes, max_width=64)
        assert len(plan.levels) >= 2
        out = segment_reduce(plan, jnp.asarray(stream))
        expected = [stream[:2000].sum(), stream[2000:2003].sum(),
                    stream[2003:].sum()]
        np.testing.assert_allclose(np.asarray(out), expected, rtol=1e-12)

    def test_2d_stream(self):
        plan = build_segment_reduce_plan([2, 1])
        stream = jnp.asarray([[1.0, 2.0], [3.0, 4.0], [5.0, 6.0]])
        out = segment_reduce(plan, stream)
        np.testing.assert_allclose(np.asarray(out), [[4.0, 6.0], [5.0, 6.0]])

    def test_all_empty_groups(self):
        plan = build_segment_reduce_plan([0, 0, 0])
        out = segment_reduce(plan, jnp.zeros(0))
        np.testing.assert_array_equal(np.asarray(out), [0.0, 0.0, 0.0])

    def test_overhead_bounded(self):
        rng = np.random.default_rng(3)
        sizes = rng.integers(0, 40, size=1000)
        plan = build_segment_reduce_plan(sizes)
        assert plan.overhead <= 2.5


class TestSpmv:
    @pytest.mark.parametrize("dtype", [np.float32, np.float64])
    def test_csr_spmv_vs_dense(self, rng, dtype):
        a, d = _random_csr(rng, 50, 40, dtype=dtype)
        x = rng.normal(size=40).astype(dtype)
        y = a @ x
        tol = 1e-5 if dtype == np.float32 else 1e-12
        np.testing.assert_allclose(np.asarray(y), d @ x, rtol=tol, atol=tol)

    def test_empty_rows_and_cols(self, rng):
        a = CsrMatrix(3, 3, [0, 0, 2, 2], [0, 2], [1.0, 2.0])
        x = np.asarray([1.0, 1.0, 1.0])
        np.testing.assert_allclose(np.asarray(a @ x), [0.0, 3.0, 0.0])

    def test_fallback_under_jit_matches(self, rng):
        a, d = _random_csr(rng, 30, 30)
        x = rng.normal(size=30)

        @jax.jit
        def f(mat, v):
            return mat @ v  # structure traced -> segment_sum fallback

        np.testing.assert_allclose(np.asarray(f(a, x)), d @ x, rtol=1e-12)
        np.testing.assert_allclose(np.asarray(f(a, x)), np.asarray(a @ x),
                                   rtol=1e-12)

    def test_csc_spmv(self, rng):
        a, d = _random_csr(rng, 20, 30)
        csc = a.to_csc()
        x = rng.normal(size=30)
        np.testing.assert_allclose(np.asarray(csc @ x), d @ x, rtol=1e-12)

    def test_spmv_shape_mismatch(self, rng):
        a, _ = _random_csr(rng, 5, 5)
        with pytest.raises(ShapeError):
            a @ np.ones(7)

    def test_padded_matrix_spmv(self, rng):
        # jit-produced padded structure (sentinel slots) must not pollute y
        a, da = _random_csr(rng, 12, 12, density=0.3)
        b, db = _random_csr(rng, 12, 12, density=0.3)
        c = jax.jit(lambda p, q: p + q)(a, b)  # padded device result
        assert c.nse > c.nnz
        x = rng.normal(size=12)
        np.testing.assert_allclose(np.asarray(c @ x), (da + db) @ x, rtol=1e-12)


class TestSpmm:
    def test_csr_spmm_vs_dense(self, rng):
        a, d = _random_csr(rng, 40, 30)
        X = rng.normal(size=(30, 64))
        np.testing.assert_allclose(np.asarray(a @ X), d @ X, rtol=1e-12)

    def test_csc_spmm(self, rng):
        a, d = _random_csr(rng, 25, 30)
        X = rng.normal(size=(30, 8))
        np.testing.assert_allclose(np.asarray(a.to_csc() @ X), d @ X,
                                   rtol=1e-12)


class TestBsr:
    def test_from_csr_roundtrip(self, rng):
        a, d = _random_csr(rng, 32, 24, density=0.2)
        bsr = a.to_bsr((8, 8))
        np.testing.assert_allclose(np.asarray(bsr.to_dense()), d, rtol=1e-12)
        np.testing.assert_allclose(np.asarray(bsr.to_csr().to_dense()), d,
                                   rtol=1e-12)

    def test_bsr_matvec_matmat(self, rng):
        a, d = _random_csr(rng, 32, 32, density=0.15)
        bsr = a.to_bsr(8)
        x = rng.normal(size=32)
        X = rng.normal(size=(32, 16))
        np.testing.assert_allclose(np.asarray(bsr @ x), d @ x, rtol=1e-12)
        np.testing.assert_allclose(np.asarray(bsr @ X), d @ X, rtol=1e-12)

    def test_bsr_eye(self):
        m = BsrMatrix.eye(16, 8)
        np.testing.assert_array_equal(np.asarray(m.to_dense()), np.eye(16))

    def test_indivisible_shape_raises(self, rng):
        a, _ = _random_csr(rng, 30, 30)
        with pytest.raises(ShapeError):
            a.to_bsr(8)
