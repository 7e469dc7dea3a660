"""Native C++ host-kernel parity tests: every native symbolic kernel must
agree exactly with its NumPy reference implementation."""

import numpy as np
import pytest

from spalinalg.native import lib as native

pytestmark = pytest.mark.skipif(
    not native.available(), reason="native library unavailable (no g++?)"
)

from spalinalg import CooMatrix, CsrMatrix  # noqa: E402
from spalinalg.convert.engine import compress_host  # noqa: E402
from spalinalg.linalg.ordering import (  # noqa: E402
    level_schedule as np_levels,
    rcm_ordering,
    bandwidth,
    # permute via cholesky helper
)
from spalinalg.linalg.cholesky import permute_csr  # noqa: E402


def _random_triplets(rng, n, m, k):
    return (rng.integers(0, n, k), rng.integers(0, m, k),
            rng.normal(size=k))


class TestCompress:
    @pytest.mark.parametrize("dedup,drop", [(True, True), (True, False),
                                            (False, False)])
    def test_parity(self, rng, dedup, drop):
        rows, cols, vals = _random_triplets(rng, 20, 25, 200)
        vals[::7] = 0.0  # explicit zeros to exercise dropping
        p1, m1, v1 = compress_host(rows, cols, vals, 20,
                                   dedup=dedup, drop_zeros=drop)
        p2, m2, v2 = native.compress(rows, cols, vals, 20,
                                     dedup=dedup, drop_zeros=drop)
        np.testing.assert_array_equal(p1, p2)
        np.testing.assert_array_equal(m1, m2)
        np.testing.assert_allclose(v1, v2, rtol=1e-15)


class TestRcm:
    def test_bandwidth_reduction_parity_class(self, rng):
        # native RCM must be a valid permutation with comparable bandwidth
        n = 80
        coo = CooMatrix(n, n)
        for i in range(n):
            coo.push(i, i, 2.0)
            if i > 0:
                coo.push(i, i - 1, -1.0)
                coo.push(i - 1, i, -1.0)
        a = permute_csr(CsrMatrix.from_coo(coo), rng.permutation(n))
        ptr = np.asarray(a._ptr, dtype=np.int64)
        ind = np.asarray(a._minor, dtype=np.int64)
        perm = native.rcm(ptr, ind, n)
        assert sorted(perm) == list(range(n))
        assert bandwidth(permute_csr(a, perm)) <= 2
        # python reference yields identical permutation (same algorithm)
        np.testing.assert_array_equal(perm, rcm_ordering(a))


class TestLevels:
    def test_parity(self, rng):
        n = 40
        d = np.tril(np.where(rng.random((n, n)) < 0.3,
                             rng.normal(size=(n, n)), 0))
        np.fill_diagonal(d, 1.0)
        coo = CooMatrix(n, n)
        for i, j in zip(*np.nonzero(d)):
            coo.push(int(i), int(j), float(d[i, j]))
        a = CsrMatrix.from_coo(coo)
        ptr = np.asarray(a._ptr, dtype=np.int64)
        ind = np.asarray(a._minor, dtype=np.int64)
        nl, lev = native.level_schedule(ptr, ind, n, lower=True)
        bounds, order = np_levels(ptr, ind, n, lower=True)
        assert nl == bounds.size - 1
        # same level assignment
        lev_py = np.empty(n, dtype=np.int64)
        for g in range(bounds.size - 1):
            lev_py[order[bounds[g]:bounds[g + 1]]] = g
        np.testing.assert_array_equal(lev, lev_py)


class TestSpgemmSymbolic:
    def test_parity_with_python_plan(self, rng):
        from spalinalg.ops.spgemm import spgemm_plan

        n = 30
        da = np.where(rng.random((n, n)) < 0.2, rng.normal(size=(n, n)), 0)
        db = np.where(rng.random((n, n)) < 0.2, rng.normal(size=(n, n)), 0)

        def mk(d):
            coo = CooMatrix(*d.shape)
            for i, j in zip(*np.nonzero(d)):
                coo.push(int(i), int(j), float(d[i, j]))
            return CsrMatrix.from_coo(coo)

        a, b = mk(da), mk(db)
        plan = spgemm_plan(a, b)
        aptr = np.asarray(a._ptr, dtype=np.int64)
        acol = np.asarray(a._minor, dtype=np.int64)
        bptr = np.asarray(b._ptr, dtype=np.int64)
        bcol = np.asarray(b._minor, dtype=np.int64)
        a_idx, b_idx, gid, rp, ci = native.spgemm_symbolic(
            aptr, acol, n, bptr, bcol, n
        )
        np.testing.assert_array_equal(rp, np.asarray(plan.rowptr))
        np.testing.assert_array_equal(ci, np.asarray(plan.colind))
        np.testing.assert_array_equal(gid, np.asarray(plan.gid))
        # term order may legitimately differ within an output group as long
        # as the (a_idx, b_idx) multiset per gid matches
        py = sorted(zip(np.asarray(plan.gid), np.asarray(plan.a_idx),
                        np.asarray(plan.b_idx)))
        cc = sorted(zip(gid, a_idx, b_idx))
        assert py == cc
