"""CsrMatrix / CscMatrix tests — mirrors `csr.rs:466-511` / `csc.rs:466-511`:
the eight constructor validation panics, accessors, transpose."""

import numpy as np
import pytest

import jax.numpy as jnp

from spalinalg import CscMatrix, CsrMatrix, ShapeError, StructureError


# The 4x4 example from the reference docs (csr.rs:24-63):
#     [ 1 . 2 . ]
#     [ . 3 . . ]
#     [ . . 4 5 ]
#     [ . . . 6 ]
REF_ROWPTR = [0, 2, 3, 5, 6]
REF_COLIND = [0, 2, 1, 2, 3, 3]
REF_VALUES = [1.0, 2.0, 3.0, 4.0, 5.0, 6.0]


def ref_csr():
    return CsrMatrix(4, 4, REF_ROWPTR, REF_COLIND, REF_VALUES)


class TestValidation:
    """One case per reference assert (csr.rs:144-156)."""

    def test_valid_construction(self):
        m = ref_csr()
        assert m.shape == (4, 4)
        assert m.nnz == 6

    def test_zero_dims_panics(self):
        with pytest.raises(ShapeError):
            CsrMatrix(0, 4, [0], [], [])

    def test_bad_ptr_length_panics(self):
        with pytest.raises(StructureError):
            CsrMatrix(4, 4, [0, 2, 3], REF_COLIND, REF_VALUES)

    def test_ptr_not_starting_at_zero_panics(self):
        with pytest.raises(StructureError):
            CsrMatrix(4, 4, [1, 2, 3, 5, 6], REF_COLIND, REF_VALUES)

    def test_ind_length_mismatch_panics(self):
        with pytest.raises(StructureError):
            CsrMatrix(4, 4, REF_ROWPTR, [0, 2, 1], REF_VALUES)

    def test_values_length_mismatch_panics(self):
        with pytest.raises(StructureError):
            CsrMatrix(4, 4, REF_ROWPTR, REF_COLIND, [1.0, 2.0])

    def test_non_monotone_ptr_panics(self):
        with pytest.raises(StructureError):
            CsrMatrix(4, 4, [0, 3, 2, 5, 6], REF_COLIND, REF_VALUES)

    def test_index_out_of_range_panics(self):
        with pytest.raises(StructureError):
            CsrMatrix(4, 4, REF_ROWPTR, [0, 9, 1, 2, 3, 3], REF_VALUES)

    def test_unsorted_indices_within_row_panics(self):
        with pytest.raises(StructureError):
            CsrMatrix(4, 4, REF_ROWPTR, [2, 0, 1, 2, 3, 3], REF_VALUES)

    def test_duplicate_indices_within_row_panics(self):
        # strictly increasing required (csr.rs:154-156)
        with pytest.raises(StructureError):
            CsrMatrix(4, 4, REF_ROWPTR, [0, 0, 1, 2, 3, 3], REF_VALUES)


class TestAccessors:
    def test_arrays(self):
        m = ref_csr()
        np.testing.assert_array_equal(np.asarray(m.rowptr), REF_ROWPTR)
        np.testing.assert_array_equal(np.asarray(m.colind), REF_COLIND)
        np.testing.assert_array_equal(np.asarray(m.values), REF_VALUES)

    def test_eye(self):
        m = CsrMatrix.eye(3)
        np.testing.assert_array_equal(np.asarray(m.to_dense()), np.eye(3))
        assert m.nnz == 3

    def test_iter_row_major(self):
        m = ref_csr()
        assert list(m) == [
            (0, 0, 1.0), (0, 2, 2.0), (1, 1, 3.0),
            (2, 2, 4.0), (2, 3, 5.0), (3, 3, 6.0),
        ]

    def test_with_values(self):
        m = ref_csr()
        m2 = m.with_values(np.asarray(m.values) * 2)
        np.testing.assert_array_equal(np.asarray(m2.values),
                                      np.asarray(REF_VALUES) * 2)
        with pytest.raises(ShapeError):
            m.with_values(np.ones(3))

    def test_map_values_uses_nrows_not_ncols(self):
        # The reference iter_mut loops 0..ncols (bug, csr.rs:333). Build a
        # non-square matrix and check every value is mapped.
        m = CsrMatrix(2, 5, [0, 1, 2], [0, 4], [1.0, 2.0])
        d = m.map_values(lambda v: v * 10)
        np.testing.assert_array_equal(np.asarray(d.values), [10.0, 20.0])

    def test_to_dense(self):
        m = ref_csr()
        expected = np.array([
            [1, 0, 2, 0],
            [0, 3, 0, 0],
            [0, 0, 4, 5],
            [0, 0, 0, 6],
        ], dtype=np.float64)
        np.testing.assert_array_equal(np.asarray(m.to_dense()), expected)


class TestTranspose:
    def test_transpose_values(self):
        # reference: csr.rs:358-406
        m = ref_csr()
        t = m.transpose()
        np.testing.assert_array_equal(
            np.asarray(t.to_dense()), np.asarray(m.to_dense()).T
        )

    def test_transpose_sorted_structure(self):
        m = CsrMatrix(2, 3, [0, 2, 3], [0, 2, 1], [1.0, 2.0, 3.0])
        t = m.transpose()
        assert t.shape == (3, 2)
        tp = np.asarray(t.rowptr)
        assert tp[0] == 0 and tp[-1] == 3
        # strictly increasing within rows
        ind = np.asarray(t.colind)
        for r in range(3):
            seg = ind[tp[r]:tp[r + 1]]
            assert np.all(np.diff(seg) > 0) or seg.size <= 1

    def test_double_transpose_identity(self):
        m = ref_csr()
        tt = m.transpose().transpose()
        np.testing.assert_array_equal(
            np.asarray(tt.to_dense()), np.asarray(m.to_dense())
        )


class TestCsc:
    def test_valid_construction(self):
        # CSC mirror of the reference 4x4 (csc.rs:24-63)
        m = CscMatrix(4, 4, [0, 1, 2, 4, 6], [0, 1, 0, 2, 2, 3],
                      [1.0, 3.0, 2.0, 4.0, 5.0, 6.0])
        expected = np.array([
            [1, 0, 2, 0],
            [0, 3, 0, 0],
            [0, 0, 4, 5],
            [0, 0, 0, 6],
        ], dtype=np.float64)
        np.testing.assert_array_equal(np.asarray(m.to_dense()), expected)
        assert m.nnz == 6

    def test_validation_mirror(self):
        with pytest.raises(StructureError):
            CscMatrix(4, 4, [0, 1], [0], [1.0])
        with pytest.raises(StructureError):
            CscMatrix(2, 2, [0, 2, 2], [1, 0], [1.0, 2.0])  # unsorted in col

    def test_iter_column_major(self):
        m = CscMatrix(4, 4, [0, 1, 2, 4, 6], [0, 1, 0, 2, 2, 3],
                      [1.0, 3.0, 2.0, 4.0, 5.0, 6.0])
        assert list(m) == [
            (0, 0, 1.0), (1, 1, 3.0), (0, 2, 2.0),
            (2, 2, 4.0), (2, 3, 5.0), (3, 3, 6.0),
        ]

    def test_transpose(self):
        m = CscMatrix(2, 3, [0, 1, 2, 3], [0, 1, 0], [1.0, 2.0, 3.0])
        t = m.transpose()
        assert t.shape == (3, 2)
        np.testing.assert_array_equal(
            np.asarray(t.to_dense()), np.asarray(m.to_dense()).T
        )


class TestAstype:
    def test_cast_roundtrip(self):
        a = CsrMatrix.eye(3)                     # f64
        b = a.astype("float32")
        assert b.dtype.name == "float32"
        assert a.dtype.name == "float64"         # original untouched
        np.testing.assert_array_equal(np.asarray(b.to_dense()), np.eye(3))
        c = b.astype(jnp.bfloat16)
        assert c.dtype.name == "bfloat16"

    def test_rejects_outside_scalar_set(self):
        from spalinalg.errors import DTypeError

        with pytest.raises(DTypeError):
            CsrMatrix.eye(3).astype("int32")
        with pytest.raises(DTypeError):
            CsrMatrix.eye(3).astype("float16")
