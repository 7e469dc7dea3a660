"""Conversion-graph tests — mirrors `src/csr/conv/*`, `src/csc/conv/*` and
the iterator-based conversions, including the reference's golden case for
COO→CSR covering unsorted input, duplicates, explicit zero and numerical
cancellation (`csr/conv/coo.rs:129-146`)."""

import numpy as np
import pytest

from spalinalg import CooMatrix, CscMatrix, CsrMatrix, DokMatrix


def dense_of(mat):
    if hasattr(mat, "to_dense"):
        return np.asarray(mat.to_dense())
    raise AssertionError


class TestCooToCompressed:
    def test_coo_to_csr_dedup_and_zero_drop(self):
        # Golden semantics from csr/conv/coo.rs:131-146: unsorted input,
        # duplicate summed, explicit zero dropped, +v/-v cancellation dropped.
        coo = CooMatrix.with_entries(4, 4, [
            (2, 2, 4.0),        # unsorted position
            (0, 0, 1.0),
            (0, 0, 2.0),        # duplicate -> summed to 3.0
            (1, 1, 0.0),        # explicit zero -> dropped
            (3, 3, 5.0),
            (3, 3, -5.0),       # cancellation -> dropped
            (0, 2, 7.0),
        ])
        csr = CsrMatrix.from_coo(coo)
        assert csr.nnz == 3
        np.testing.assert_array_equal(np.asarray(csr.rowptr), [0, 2, 2, 3, 3])
        np.testing.assert_array_equal(np.asarray(csr.colind), [0, 2, 2])
        np.testing.assert_array_equal(np.asarray(csr.values), [3.0, 7.0, 4.0])

    def test_coo_to_csc_mirror(self):
        coo = CooMatrix.with_entries(4, 4, [
            (2, 2, 4.0), (0, 0, 1.0), (0, 0, 2.0), (1, 1, 0.0),
            (3, 3, 5.0), (3, 3, -5.0), (0, 2, 7.0),
        ])
        csc = CscMatrix.from_coo(coo)
        assert csc.nnz == 3
        np.testing.assert_array_equal(np.asarray(csc.colptr), [0, 1, 1, 3, 3])
        np.testing.assert_array_equal(np.asarray(csc.rowind), [0, 0, 2])
        np.testing.assert_array_equal(np.asarray(csc.values), [3.0, 7.0, 4.0])

    def test_roundtrip_dense_equality(self, rng):
        n = 37
        coo = CooMatrix(n, n)
        for _ in range(150):
            coo.push(int(rng.integers(n)), int(rng.integers(n)),
                     float(rng.normal()))
        csr = CsrMatrix.from_coo(coo)
        np.testing.assert_allclose(dense_of(csr), coo.to_dense(), rtol=1e-12)


class TestDokToCompressed:
    def test_dok_keeps_explicit_zeros(self):
        # csr/conv/dok.rs: no dedup/zero-drop phases
        dok = DokMatrix.with_entries(3, 3, [(0, 0, 0.0), (1, 2, 5.0)])
        csr = CsrMatrix.from_dok(dok)
        assert csr.nnz == 2  # explicit zero kept
        np.testing.assert_array_equal(np.asarray(csr.values), [0.0, 5.0])

    def test_dok_to_csc(self):
        dok = DokMatrix.with_entries(3, 3, [(2, 0, 1.0), (0, 1, 2.0)])
        csc = CscMatrix.from_dok(dok)
        np.testing.assert_array_equal(dense_of(csc), dok.to_dense())


class TestCompressedRoundtrips:
    def _sample_csr(self):
        return CsrMatrix(3, 4, [0, 2, 2, 4], [0, 3, 1, 2],
                         [1.0, 2.0, 3.0, 4.0])

    def test_csr_to_csc_same_matrix(self):
        csr = self._sample_csr()
        csc = csr.to_csc()
        assert isinstance(csc, CscMatrix)
        assert csc.shape == csr.shape
        np.testing.assert_array_equal(dense_of(csc), dense_of(csr))

    def test_csc_to_csr_same_matrix(self):
        csc = CscMatrix(3, 3, [0, 1, 2, 3], [2, 0, 1], [1.0, 2.0, 3.0])
        csr = csc.to_csr()
        np.testing.assert_array_equal(dense_of(csr), dense_of(csc))

    def test_csr_csc_keeps_explicit_zero(self):
        # csr/conv/csc.rs: zeros kept
        csr = CsrMatrix(2, 2, [0, 1, 2], [0, 1], [0.0, 5.0])
        csc = csr.to_csc()
        assert csc.nnz == 2

    def test_csr_to_coo_order(self):
        # coo.rs:669-706: row-major triplet order
        csr = self._sample_csr()
        coo = csr.to_coo()
        assert list(coo) == [(0, 0, 1.0), (0, 3, 2.0), (2, 1, 3.0), (2, 2, 4.0)]

    def test_csc_to_coo_order(self):
        csc = CscMatrix(3, 3, [0, 1, 2, 3], [2, 0, 1], [1.0, 2.0, 3.0])
        coo = csc.to_coo()
        assert list(coo) == [(2, 0, 1.0), (0, 1, 2.0), (1, 2, 3.0)]

    def test_csr_to_dok(self):
        csr = self._sample_csr()
        dok = csr.to_dok()
        assert dok.length == csr.nnz
        np.testing.assert_array_equal(dok.to_dense(), dense_of(csr))


class TestCooDokConversions:
    def test_coo_to_dok_sums_duplicates(self):
        # dok.rs:659-661: the only other dedup point
        coo = CooMatrix.with_entries(2, 2, [(0, 0, 1.0), (0, 0, 2.0)])
        dok = DokMatrix.with_entries(2, 2, [])
        from spalinalg.convert.conversions import coo_to_dok
        dok = coo_to_dok(coo)
        assert dok.length == 1
        assert dok.get(0, 0) == 3.0

    def test_dok_to_coo(self):
        dok = DokMatrix.with_entries(2, 2, [(0, 1, 2.0), (1, 0, 3.0)])
        from spalinalg.convert.conversions import dok_to_coo
        coo = dok_to_coo(dok)
        assert coo.length == 2
        np.testing.assert_array_equal(coo.to_dense(), dok.to_dense())


class TestPropertyRandom:
    """Randomised conversion-graph closure against dense ground truth."""

    @pytest.mark.parametrize("dtype", [np.float32, np.float64])
    def test_all_paths_dense_equal(self, rng, dtype):
        n, m, k = 13, 17, 60
        coo = CooMatrix(n, m, dtype=dtype)
        for _ in range(k):
            coo.push(int(rng.integers(n)), int(rng.integers(m)),
                     float(rng.normal()))
        dense = coo.to_dense()
        csr = CsrMatrix.from_coo(coo)
        csc = CscMatrix.from_coo(coo)
        tol = dict(rtol=1e-5 if dtype == np.float32 else 1e-12, atol=1e-30)
        np.testing.assert_allclose(dense_of(csr), dense, **tol)
        np.testing.assert_allclose(dense_of(csc), dense, **tol)
        np.testing.assert_allclose(dense_of(csr.to_csc()), dense, **tol)
        np.testing.assert_allclose(dense_of(csc.to_csr()), dense, **tol)
        np.testing.assert_allclose(csr.to_dok().to_dense(), dense, **tol)
        np.testing.assert_allclose(csr.to_coo().to_dense(), dense, **tol)
