"""CooMatrix tests — mirrors the reference's inline suite (`coo.rs:806-1121`):
validation-by-exception, exact-behavior cases, plus the COO op semantics
(concatenation on add/sub, `coo.rs:751-804`)."""

import numpy as np
import pytest

from spalinalg import CooMatrix, IndexError_, ShapeError


class TestConstructors:
    def test_new(self):
        m = CooMatrix(2, 3)
        assert m.shape == (2, 3)
        assert m.length == 0

    def test_new_zero_rows_panics(self):
        # reference: coo.rs:819-829 should_panic
        with pytest.raises(ShapeError):
            CooMatrix(0, 3)

    def test_new_zero_cols_panics(self):
        with pytest.raises(ShapeError):
            CooMatrix(2, 0)

    def test_eye(self):
        m = CooMatrix.eye(3)
        assert m.shape == (3, 3)
        assert m.length == 3
        assert list(m) == [(0, 0, 1.0), (1, 1, 1.0), (2, 2, 1.0)]

    def test_with_capacity(self):
        m = CooMatrix.with_capacity(2, 3, 10)
        assert m.capacity >= 10
        assert m.length == 0

    def test_with_capacity_zero_dims_panics(self):
        with pytest.raises(ShapeError):
            CooMatrix.with_capacity(0, 3, 10)

    def test_with_entries(self):
        m = CooMatrix.with_entries(2, 3, [(0, 0, 1.0), (1, 2, 2.0)])
        assert m.length == 2
        assert list(m) == [(0, 0, 1.0), (1, 2, 2.0)]

    def test_with_entries_out_of_range_panics(self):
        with pytest.raises(IndexError_):
            CooMatrix.with_entries(2, 3, [(2, 0, 1.0)])
        with pytest.raises(IndexError_):
            CooMatrix.with_entries(2, 3, [(0, 3, 1.0)])

    def test_with_triplets(self):
        m = CooMatrix.with_triplets(2, 3, [0, 1], [0, 2], [1.0, 2.0])
        assert list(m) == [(0, 0, 1.0), (1, 2, 2.0)]

    def test_with_triplets_length_mismatch_panics(self):
        with pytest.raises(ShapeError):
            CooMatrix.with_triplets(2, 3, [0, 1], [0], [1.0, 2.0])

    def test_with_triplets_out_of_range_panics(self):
        with pytest.raises(IndexError_):
            CooMatrix.with_triplets(2, 3, [5], [0], [1.0])


class TestAccessors:
    def test_shape_accessors(self):
        m = CooMatrix(2, 3)
        assert (m.nrows, m.ncols) == (2, 3)

    def test_get(self):
        m = CooMatrix.with_entries(2, 3, [(0, 1, 5.0)])
        assert m.get(0) == (0, 1, 5.0)
        assert m.get(1) is None

    def test_set_value(self):
        m = CooMatrix.with_entries(2, 3, [(0, 1, 5.0)])
        m.set_value(0, 7.0)
        assert m.get(0) == (0, 1, 7.0)
        with pytest.raises(IndexError_):
            m.set_value(3, 1.0)


class TestMutation:
    def test_push_pop_clear(self):
        m = CooMatrix(3, 3)
        m.push(1, 2, 4.0)
        m.push(0, 0, 1.0)
        assert m.length == 2
        assert m.pop() == (0, 0, 1.0)
        assert m.length == 1
        m.clear()
        assert m.length == 0
        assert m.pop() is None

    def test_push_out_of_range_panics(self):
        # reference: coo.rs:434-435
        m = CooMatrix(2, 3)
        with pytest.raises(IndexError_):
            m.push(2, 0, 1.0)
        with pytest.raises(IndexError_):
            m.push(0, 3, 1.0)

    def test_duplicates_allowed(self):
        m = CooMatrix(2, 2)
        m.push(0, 0, 1.0)
        m.push(0, 0, 2.0)
        assert m.length == 2  # duplicates kept (coo.rs:28-36)

    def test_extend(self):
        m = CooMatrix(2, 3)
        m.extend([(0, 0, 1.0), (1, 1, 2.0)])
        assert m.length == 2


class TestStructure:
    def test_transpose_swaps_indices_keeps_order(self):
        # reference: coo.rs:538-546
        m = CooMatrix.with_entries(2, 3, [(0, 2, 1.0), (1, 0, 2.0)])
        t = m.transpose()
        assert t.shape == (3, 2)
        assert list(t) == [(2, 0, 1.0), (0, 1, 2.0)]

    def test_map_values(self):
        m = CooMatrix.with_entries(2, 2, [(0, 0, 1.0), (1, 1, 2.0)])
        d = m.map_values(lambda v: v * 10)
        assert list(d) == [(0, 0, 10.0), (1, 1, 20.0)]
        assert list(m) == [(0, 0, 1.0), (1, 1, 2.0)]  # original untouched


class TestOps:
    def test_add_concatenates(self):
        # reference: coo.rs:751-770 — entries concatenated, duplicates kept
        a = CooMatrix.with_entries(2, 2, [(0, 0, 1.0)])
        b = CooMatrix.with_entries(2, 2, [(0, 0, 2.0), (1, 1, 3.0)])
        c = a + b
        assert c.length == 3
        assert list(c) == [(0, 0, 1.0), (0, 0, 2.0), (1, 1, 3.0)]

    def test_add_shape_mismatch_panics(self):
        a = CooMatrix(2, 2)
        b = CooMatrix(2, 3)
        with pytest.raises(ShapeError):
            a + b

    def test_sub_concatenates_negated(self):
        a = CooMatrix.with_entries(2, 2, [(0, 0, 1.0)])
        b = CooMatrix.with_entries(2, 2, [(1, 1, 3.0)])
        c = a - b
        assert list(c) == [(0, 0, 1.0), (1, 1, -3.0)]

    def test_neg(self):
        a = CooMatrix.with_entries(2, 2, [(0, 0, 1.0), (1, 0, -2.0)])
        assert list(-a) == [(0, 0, -1.0), (1, 0, 2.0)]

    def test_to_dense_sums_duplicates(self):
        a = CooMatrix.with_entries(2, 2, [(0, 0, 1.0), (0, 0, 2.0)])
        np.testing.assert_array_equal(a.to_dense(), [[3.0, 0.0], [0.0, 0.0]])


class TestBulkPaths:
    """bulk host paths must handle 1M entries fast."""

    def test_extend_1m_under_1s(self):
        import time
        n = 1_000_000
        rows = np.random.default_rng(0).integers(0, 1000, size=n)
        cols = np.random.default_rng(1).integers(0, 1000, size=n)
        vals = np.random.default_rng(2).normal(size=n)
        entries = list(zip(rows.tolist(), cols.tolist(), vals.tolist()))
        # Best-of-2 timing: a single wall-clock sample is load-sensitive
        # (CI shares the host with benches); the bulk path itself is ~0.3 s.
        dt = float("inf")
        for _ in range(2):
            m = CooMatrix(1000, 1000)
            t0 = time.perf_counter()
            m.extend(entries)
            dt = min(dt, time.perf_counter() - t0)
        assert m.length == n
        assert dt < 1.0, f"1M extend took {dt:.2f}s (best of 2)"

    def test_extend_from_coo_bulk(self):
        src = CooMatrix.with_entries(2, 3, [(0, 0, 1.0), (1, 2, 5.0)])
        m = CooMatrix(2, 3)
        m.extend(src)
        assert list(m) == [(0, 0, 1.0), (1, 2, 5.0)]

    def test_extend_out_of_range_appends_nothing(self):
        m = CooMatrix(2, 2)
        with pytest.raises(IndexError_):
            m.extend([(0, 0, 1.0), (5, 0, 2.0)])
        assert m.length == 0  # all-or-nothing (documented divergence)
