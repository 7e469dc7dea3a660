"""Structural composition ops (`ops/structure.py`). Oracle: scipy.sparse."""

import numpy as np

import jax.numpy as jnp
import pytest
import scipy.sparse as sps

from spalinalg import (
    CooMatrix,
    CsrMatrix,
    bmat,
    block_diag,
    hstack,
    kron,
    vstack,
)
from spalinalg.errors import ShapeError
from spalinalg.io import from_scipy, to_scipy


def _rand(rng, n, m, density=0.3):
    d = np.where(rng.random((n, m)) < density, rng.normal(size=(n, m)), 0)
    return from_scipy(sps.csr_matrix(d)), sps.csr_matrix(d)


@pytest.mark.parametrize("shapes", [((3, 4), (2, 5)), ((1, 1), (4, 3))])
def test_kron_matches_scipy(rng, shapes):
    (am, an), (bm, bn) = shapes
    a, sa = _rand(rng, am, an)
    b, sb = _rand(rng, bm, bn)
    k = kron(a, b)
    ref = sps.kron(sa, sb).toarray()
    np.testing.assert_allclose(np.asarray(k.to_dense()), ref, atol=1e-12)


def test_kron_coo_duplicates(rng):
    a = CooMatrix.with_entries(2, 2, [(0, 0, 1.0), (0, 0, 2.0)])
    b = CsrMatrix.eye(2)
    k = kron(a, b)
    assert float(np.asarray(k.to_dense())[0, 0]) == 3.0


def test_vstack_hstack_match_scipy(rng):
    a, sa = _rand(rng, 3, 4)
    b, sb = _rand(rng, 2, 4)
    np.testing.assert_allclose(
        np.asarray(vstack([a, b]).to_dense()),
        sps.vstack([sa, sb]).toarray(), atol=1e-12)
    c, sc = _rand(rng, 3, 2)
    np.testing.assert_allclose(
        np.asarray(hstack([a, c]).to_dense()),
        sps.hstack([sa, sc]).toarray(), atol=1e-12)


def test_block_diag_matches_scipy(rng):
    a, sa = _rand(rng, 3, 4)
    b, sb = _rand(rng, 2, 2)
    np.testing.assert_allclose(
        np.asarray(block_diag([a, b]).to_dense()),
        sps.block_diag([sa, sb]).toarray(), atol=1e-12)


def test_bmat_with_none(rng):
    a, sa = _rand(rng, 3, 4)
    b, sb = _rand(rng, 3, 2)
    c, sc = _rand(rng, 2, 4)
    got = bmat([[a, b], [c, None]])
    ref = sps.bmat([[sa, sb], [sc, None]]).toarray()
    np.testing.assert_allclose(np.asarray(got.to_dense()), ref, atol=1e-12)


def test_mixed_formats(rng):
    a, sa = _rand(rng, 4, 4)
    got = vstack([a, a.to_csc(), a.to_coo(), a.to_dok(), a.to_bsr(2)])
    ref = sps.vstack([sa] * 5).toarray()
    np.testing.assert_allclose(np.asarray(got.to_dense()), ref, atol=1e-12)


def test_validation(rng):
    a, _ = _rand(rng, 3, 4)
    b, _ = _rand(rng, 3, 5)
    with pytest.raises(ShapeError):
        vstack([a, b])
    with pytest.raises(ShapeError):
        hstack([a, _rand(rng, 2, 4)[0]])
    with pytest.raises(ShapeError):
        vstack([])
    with pytest.raises(ShapeError):
        bmat([[None, None]])
    with pytest.raises(ShapeError):
        bmat([[a, a], [a, b]])   # width mismatch in column 1


class TestConstruct:
    def test_diags_matches_scipy(self, rng):
        from spalinalg import diags

        dvals = [rng.normal(size=5), rng.normal(size=6), rng.normal(size=4)]
        got = diags(dvals, offsets=[-1, 0, 2], shape=(6, 6))
        ref = sps.diags(dvals, offsets=[-1, 0, 2], shape=(6, 6)).toarray()
        np.testing.assert_allclose(np.asarray(got.to_dense()), ref,
                                   atol=1e-12)

    def test_diags_scalar_broadcast(self):
        from spalinalg import diags

        got = diags([-1.0, 2.0, -1.0], offsets=[-1, 0, 1], shape=(5, 5))
        ref = sps.diags([-1.0, 2.0, -1.0], offsets=[-1, 0, 1],
                        shape=(5, 5)).toarray()
        np.testing.assert_allclose(np.asarray(got.to_dense()), ref,
                                   atol=1e-12)

    def test_diags_rectangular(self):
        from spalinalg import diags

        got = diags([1.0, 2.0], offsets=[0, 1], shape=(3, 5))
        ref = sps.diags([1.0, 2.0], offsets=[0, 1], shape=(3, 5)).toarray()
        np.testing.assert_allclose(np.asarray(got.to_dense()), ref,
                                   atol=1e-12)

    def test_diags_single(self):
        from spalinalg import diags

        got = diags(np.array([1.0, 2.0, 3.0]))
        assert got.shape == (3, 3)
        np.testing.assert_allclose(np.asarray(got.to_dense()),
                                   np.diag([1.0, 2.0, 3.0]), atol=1e-12)

    def test_sprandom(self):
        from spalinalg import sprandom

        r = sprandom(50, 60, density=0.1, seed=3)
        assert r.shape == (50, 60)
        assert r.nnz == round(0.1 * 50 * 60)
        # distinct positions
        d = np.asarray(r.to_dense())
        assert np.count_nonzero(d) == r.nnz

    def test_construct_validation(self):
        from spalinalg import diags, sprandom
        from spalinalg.errors import ShapeError

        with pytest.raises(ShapeError):
            diags([1.0], offsets=[9], shape=(3, 3))
        with pytest.raises(ShapeError):
            diags([[1.0], [2.0]], offsets=[0])
        with pytest.raises(ShapeError):
            sprandom(0, 4)
        with pytest.raises(ShapeError):
            sprandom(4, 4, density=1.5)
        with pytest.raises(ValueError):
            sprandom(4, 4, density=0.5, values="cauchy")


class TestMatrixPower:
    def test_matches_dense_power(self, rng):
        a, sa = _rand(rng, 6, 6, density=0.4)
        d = sa.toarray()
        for k in (0, 1, 2, 3, 5):
            got = np.asarray((a ** k).to_dense())
            np.testing.assert_allclose(got, np.linalg.matrix_power(d, k),
                                       atol=1e-8)

    def test_validation(self, rng):
        a, _ = _rand(rng, 3, 5)
        from spalinalg.errors import ShapeError

        with pytest.raises(ShapeError):
            a ** 2
        b, _ = _rand(rng, 4, 4)
        with pytest.raises(ValueError):
            b ** (-1)


class TestTrilTriu:
    """`tril`/`triu` vs the scipy oracle (all formats, duplicate COO)."""

    def test_matches_scipy(self, rng):
        import scipy.sparse as sps

        from spalinalg import CsrMatrix, tril, triu
        from spalinalg.dtypes import INDEX_DTYPE

        A = sps.random(17, 23, 0.2, random_state=5).tocsr()
        A.sort_indices()
        a = CsrMatrix._from_parts(
            17, 23,
            jnp.asarray(A.indptr, dtype=INDEX_DTYPE),
            jnp.asarray(A.indices, dtype=INDEX_DTYPE),
            jnp.asarray(A.data))
        for k in (-3, -1, 0, 1, 4):
            np.testing.assert_allclose(
                np.asarray(tril(a, k).to_dense()),
                sps.tril(A, k).toarray(), atol=0)
            np.testing.assert_allclose(
                np.asarray(triu(a, k).to_dense()),
                sps.triu(A, k).toarray(), atol=0)

    def test_coo_duplicates_dedup_summed(self):
        from spalinalg import CooMatrix, tril

        coo = CooMatrix.with_entries(
            2, 2, [(1, 0, 1.5), (1, 0, 2.5), (0, 1, 9.0)])
        t = tril(coo)
        assert t.nnz == 1
        np.testing.assert_allclose(
            np.asarray(t.to_dense()), [[0.0, 0.0], [4.0, 0.0]])

    def test_split_reassembles(self, rng):
        """tril(A,-1) + diagonal + triu(A,1) == A."""
        import scipy.sparse as sps

        from spalinalg import CsrMatrix, tril, triu
        from spalinalg.dtypes import INDEX_DTYPE
        from spalinalg.ops.construct import diags

        A = sps.random(20, 20, 0.3, random_state=9).tocsr()
        A.sort_indices()
        a = CsrMatrix._from_parts(
            20, 20,
            jnp.asarray(A.indptr, dtype=INDEX_DTYPE),
            jnp.asarray(A.indices, dtype=INDEX_DTYPE),
            jnp.asarray(A.data))
        d = diags([np.asarray(A.diagonal())], offsets=[0], shape=(20, 20))
        back = tril(a, -1) + d + triu(a, 1)
        np.testing.assert_allclose(np.asarray(back.to_dense()),
                                   A.toarray(), atol=1e-12)
