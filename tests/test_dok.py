"""DokMatrix tests — mirrors `dok.rs:806-1112`: keyed access with
overwrite-on-insert, validation panics, merge ops."""

import pytest

from spalinalg import DokMatrix, IndexError_, ShapeError


class TestConstructors:
    def test_new(self):
        m = DokMatrix(2, 3)
        assert m.shape == (2, 3)
        assert m.length == 0

    def test_new_zero_dims_panics(self):
        # reference: dok.rs:106-107
        with pytest.raises(ShapeError):
            DokMatrix(0, 3)
        with pytest.raises(ShapeError):
            DokMatrix(2, 0)

    def test_eye(self):
        m = DokMatrix.eye(3)
        assert m.length == 3
        assert m.get(1, 1) == 1.0
        assert m.get(0, 1) is None

    def test_with_entries_overwrites_duplicates(self):
        # insert semantics: later duplicate wins (dok.rs:205-253)
        m = DokMatrix.with_entries(2, 2, [(0, 0, 1.0), (0, 0, 9.0)])
        assert m.length == 1
        assert m.get(0, 0) == 9.0

    def test_with_triplets_length_mismatch_panics(self):
        with pytest.raises(ShapeError):
            DokMatrix.with_triplets(2, 2, [0], [0, 1], [1.0])


class TestAccess:
    def test_insert_returns_old(self):
        # reference: dok.rs:462-482
        m = DokMatrix(2, 2)
        assert m.insert(0, 0, 1.0) is None
        assert m.insert(0, 0, 2.0) == 1.0
        assert m.get(0, 0) == 2.0
        assert m.length == 1

    def test_insert_out_of_range_panics(self):
        # reference: dok.rs:465-466
        m = DokMatrix(2, 2)
        with pytest.raises(IndexError_):
            m.insert(2, 0, 1.0)
        with pytest.raises(IndexError_):
            m.insert(0, 5, 1.0)

    def test_contains(self):
        m = DokMatrix.with_entries(2, 2, [(0, 1, 3.0)])
        assert m.contains(0, 1)
        assert not m.contains(1, 0)
        with pytest.raises(IndexError_):
            m.contains(5, 0)

    def test_get_out_of_range_panics(self):
        # reference: dok.rs:954-966
        m = DokMatrix(2, 2)
        with pytest.raises(IndexError_):
            m.get(2, 0)

    def test_remove(self):
        m = DokMatrix.with_entries(2, 2, [(0, 1, 3.0)])
        assert m.remove(0, 1) == 3.0
        assert m.remove(0, 1) is None
        assert m.length == 0

    def test_clear(self):
        m = DokMatrix.eye(3)
        m.clear()
        assert m.length == 0


class TestStructure:
    def test_transpose(self):
        # reference: dok.rs:547-559
        m = DokMatrix.with_entries(2, 3, [(0, 2, 1.0), (1, 0, 2.0)])
        t = m.transpose()
        assert t.shape == (3, 2)
        assert t.get(2, 0) == 1.0
        assert t.get(0, 1) == 2.0


class TestOps:
    def test_add_merges_by_key(self):
        # reference: dok.rs:722-736 — entry().or_default().add_assign
        a = DokMatrix.with_entries(2, 2, [(0, 0, 1.0), (1, 1, 2.0)])
        b = DokMatrix.with_entries(2, 2, [(0, 0, 10.0)])
        c = a + b
        assert c.get(0, 0) == 11.0
        assert c.get(1, 1) == 2.0
        assert c.length == 2

    def test_add_keeps_cancelled_zero(self):
        a = DokMatrix.with_entries(2, 2, [(0, 0, 1.0)])
        b = DokMatrix.with_entries(2, 2, [(0, 0, -1.0)])
        c = a + b
        assert c.contains(0, 0)
        assert c.get(0, 0) == 0.0

    def test_sub(self):
        a = DokMatrix.with_entries(2, 2, [(0, 0, 5.0)])
        b = DokMatrix.with_entries(2, 2, [(0, 0, 2.0), (1, 0, 1.0)])
        c = a - b
        assert c.get(0, 0) == 3.0
        assert c.get(1, 0) == -1.0

    def test_add_shape_mismatch_raises(self):
        # divergence: reference omits this check for DOK (SURVEY.md C7);
        # we validate deliberately.
        a = DokMatrix(2, 2)
        b = DokMatrix(3, 2)
        with pytest.raises(ShapeError):
            a + b

    def test_neg(self):
        a = DokMatrix.with_entries(2, 2, [(0, 0, 1.0)])
        assert (-a).get(0, 0) == -1.0
