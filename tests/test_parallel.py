"""Distributed-tier tests (N6/N7): N-device row-partitioned SpMV must match
the single-device result (SURVEY.md §4 parity contract) on a virtual
8-device CPU mesh."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from spalinalg import CooMatrix, CsrMatrix
from spalinalg.parallel.partition import make_row_mesh, partition_csr
from spalinalg.parallel.spmv import (
    dist_dot,
    dist_spmv,
    shard_vector,
    unshard_vector,
)


def _random_csr(rng, n, m, density=0.05):
    d = np.where(rng.random((n, m)) < density, rng.normal(size=(n, m)), 0)
    coo = CooMatrix(n, m)
    for i, j in zip(*np.nonzero(d)):
        coo.push(int(i), int(j), float(d[i, j]))
    return CsrMatrix.from_coo(coo), d


def _banded_csr(n, bw=3):
    coo = CooMatrix(n, n)
    rng = np.random.default_rng(0)
    d = np.zeros((n, n))
    for i in range(n):
        for j in range(max(0, i - bw), min(n, i + bw + 1)):
            v = float(rng.normal())
            coo.push(i, j, v)
            d[i, j] = v
    return CsrMatrix.from_coo(coo), d


@pytest.fixture(scope="module")
def mesh():
    assert len(jax.devices()) >= 8, "conftest should force 8 CPU devices"
    return make_row_mesh(8)


class TestPartition:
    def test_partition_shapes(self, rng, mesh):
        a, _ = _random_csr(rng, 100, 100)
        dist = partition_csr(a, mesh)
        assert dist.n_shards == 8
        assert dist.rows_per_shard == 13  # ceil(100/8)
        assert dist.rowptr.shape == (8, 14)

    def test_banded_selects_halo(self, mesh):
        a, _ = _banded_csr(64, bw=2)
        dist = partition_csr(a, mesh)
        assert dist.comm == "halo"
        assert dist.halo_width <= 2

    def test_random_selects_allgather(self, rng, mesh):
        a, _ = _random_csr(rng, 64, 64, density=0.2)
        dist = partition_csr(a, mesh)
        assert dist.comm == "allgather"


class TestDistSpmv:
    def test_allgather_parity(self, rng, mesh):
        a, d = _random_csr(rng, 100, 100)
        dist = partition_csr(a, mesh, comm="allgather")
        x = rng.normal(size=100)
        xs = shard_vector(x, dist)
        y = unshard_vector(dist_spmv(dist, xs), dist)
        np.testing.assert_allclose(np.asarray(y), d @ x, rtol=1e-12)

    def test_halo_parity(self, mesh):
        a, d = _banded_csr(96, bw=3)
        dist = partition_csr(a, mesh, comm="halo")
        rng = np.random.default_rng(5)
        x = rng.normal(size=96)
        xs = shard_vector(x, dist)
        y = unshard_vector(dist_spmv(dist, xs), dist)
        np.testing.assert_allclose(np.asarray(y), d @ x, rtol=1e-12)

    def test_single_vs_multi_device_bitwise_class(self, rng, mesh):
        # N-device result equals the single-chip kernel within f64 tolerance
        a, d = _random_csr(rng, 80, 80)
        x = rng.normal(size=80)
        y1 = np.asarray(a @ x)
        dist = partition_csr(a, mesh)
        y8 = np.asarray(unshard_vector(dist_spmv(dist, shard_vector(x, dist)),
                                       dist))
        np.testing.assert_allclose(y8, y1, rtol=1e-13)

    def test_dist_spgemm_on_device(self, rng, mesh):
        """DistCsr * DistCsr: symbolic on structure, NUMERIC on device
        — the product values must match the single-chip SpGEMM and
        come back row-sharded on the same mesh."""
        a, da = _random_csr(rng, 80, 96)
        b, db = _random_csr(rng, 96, 72)
        dA = partition_csr(a, mesh)
        dB = partition_csr(b, mesh)
        # note: row partitions need matching row spaces only for the
        # layout reuse; the product is defined by the logical dims
        dC = dA * dB
        ref = (a * b).to_dense()
        got = dC.to_csr().to_dense()
        np.testing.assert_allclose(np.asarray(got), np.asarray(ref),
                                   rtol=1e-5, atol=1e-6)
        # result values live sharded on the mesh (not host-gathered)
        assert dC.mesh is mesh
        assert dC.values.shape[0] == dA.n_shards

    def test_nondivisible_rows(self, rng, mesh):
        a, d = _random_csr(rng, 59, 59)  # 59 not divisible by 8
        dist = partition_csr(a, mesh)
        x = rng.normal(size=59)
        y = unshard_vector(dist_spmv(dist, shard_vector(x, dist)), dist)
        np.testing.assert_allclose(np.asarray(y), d @ x, rtol=1e-12)

    def test_jit_dist_spmv(self, rng, mesh):
        a, d = _random_csr(rng, 64, 64)
        dist = partition_csr(a, mesh)
        x = rng.normal(size=64)
        xs = shard_vector(x, dist)
        f = jax.jit(lambda v: dist_spmv(dist, v))
        y = unshard_vector(f(xs), dist)
        np.testing.assert_allclose(np.asarray(y), d @ x, rtol=1e-12)


class TestDistDot:
    def test_dot_parity(self, rng, mesh):
        a, _ = _random_csr(rng, 64, 64)
        dist = partition_csr(a, mesh)
        u = rng.normal(size=64)
        v = rng.normal(size=64)
        us, vs = shard_vector(u, dist, by="rows"), shard_vector(v, dist, by="rows")
        got = float(dist_dot(us, vs, dist))
        np.testing.assert_allclose(got, u @ v, rtol=1e-12)


class TestDistSpmm:
    def test_spmm_parity(self, rng, mesh):
        from spalinalg.parallel.spmv import dist_spmm, shard_matrix_rows

        a, d = _random_csr(rng, 72, 72)
        dist = partition_csr(a, mesh)
        X = rng.normal(size=(72, 16))
        Xs = shard_matrix_rows(X, dist)
        Y = dist_spmm(dist, Xs)
        got = np.asarray(Y)[: 72]
        np.testing.assert_allclose(got, d @ X, rtol=1e-12)


    def test_spmm_halo_parity(self, mesh):
        from spalinalg.parallel.spmv import dist_spmm, shard_matrix_rows

        a, d = _banded_csr(96, bw=2)
        dist = partition_csr(a, mesh)
        assert dist.comm == "halo"
        rng = np.random.default_rng(5)
        X = rng.normal(size=(96, 8))
        Xs = shard_matrix_rows(X, dist)
        Y = dist_spmm(dist, Xs)
        np.testing.assert_allclose(np.asarray(Y)[:96], d @ X, rtol=1e-12)


class TestDistBsr:
    def _block_banded(self, nbr=10, bs=8):
        from spalinalg import BsrMatrix
        from spalinalg.dtypes import INDEX_DTYPE

        rng = np.random.default_rng(3)
        indptr = [0]
        indices = []
        for i in range(nbr):
            cols = [j for j in (i - 1, i, i + 1) if 0 <= j < nbr]
            indices.extend(cols)
            indptr.append(len(indices))
        data = rng.normal(size=(len(indices), bs, bs)).astype(np.float32)
        n = nbr * bs
        bsr = BsrMatrix._from_parts(
            n, n, bs, bs,
            jnp.asarray(np.asarray(indptr), dtype=INDEX_DTYPE),
            jnp.asarray(np.asarray(indices), dtype=INDEX_DTYPE),
            jnp.asarray(data))
        import scipy.sparse as sps

        dense = sps.bsr_matrix(
            (data, np.asarray(indices), np.asarray(indptr)),
            shape=(n, n)).toarray()
        return bsr, dense

    def test_partition_uniform_shards(self, mesh):
        from spalinalg.parallel.bsr import partition_bsr

        bsr, _ = self._block_banded()
        d = partition_bsr(bsr, mesh)
        assert d.rows.shape == (8, d.nblk_per_shard)
        assert d.data.shape == (8, d.nblk_per_shard, 8, 8)
        # every shard padded to the largest shard's block count, no more
        ip = np.asarray(bsr.indptr)
        per = [ip[min((p + 1) * d.nbr_per_shard, 10)]
               - ip[min(p * d.nbr_per_shard, 10)] for p in range(8)]
        assert d.nblk_per_shard == max(per)

    def test_dist_bsr_spmv_parity(self, mesh):
        from spalinalg.parallel.bsr import (
            dist_bsr_spmv,
            partition_bsr,
            shard_bsr_vector,
        )

        bsr, dense = self._block_banded()
        d = partition_bsr(bsr, mesh)
        rng = np.random.default_rng(7)
        x = rng.normal(size=bsr.ncols).astype(np.float32)
        xs = shard_bsr_vector(x, d)
        y = np.asarray(dist_bsr_spmv(d, xs))[: bsr.nrows]
        np.testing.assert_allclose(y, dense @ x, rtol=2e-4, atol=2e-4)

    def test_dist_bsr_matches_single_device(self, mesh):
        from spalinalg.parallel.bsr import (
            dist_bsr_spmv,
            partition_bsr,
            shard_bsr_vector,
        )

        bsr, _ = self._block_banded(nbr=12, bs=8)
        d = partition_bsr(bsr, mesh)
        rng = np.random.default_rng(9)
        x = rng.normal(size=bsr.ncols).astype(np.float32)
        y1 = np.asarray(bsr @ jnp.asarray(x))
        xs = shard_bsr_vector(x, d)
        yN = np.asarray(dist_bsr_spmv(d, xs))[: bsr.nrows]
        np.testing.assert_allclose(yN, y1, rtol=2e-5, atol=2e-5)


class TestMultihost:
    def test_initialize_single_process_noop(self):
        from spalinalg.parallel.multihost import initialize
        initialize(num_processes=1)  # must not raise or hang

    def test_heartbeat(self):
        from spalinalg.parallel.multihost import heartbeat
        dt = heartbeat()
        assert dt >= 0

    def test_device_summary(self):
        from spalinalg.parallel.multihost import global_device_summary
        s = global_device_summary()
        assert s["global_device_count"] >= 8
        assert s["process_count"] == 1


class TestDistTranspose:
    def test_to_csr_roundtrip(self, rng, mesh):
        import numpy as np

        from spalinalg.parallel.partition import partition_csr

        n = 50
        d = np.where(rng.random((n, n)) < 0.1, rng.normal(size=(n, n)), 0)
        rows, cols = np.nonzero(d)
        from spalinalg import CooMatrix, CsrMatrix

        csr = CsrMatrix.from_coo(CooMatrix.with_triplets(
            n, n, rows.tolist(), cols.tolist(), d[rows, cols].tolist()))
        dist = partition_csr(csr, mesh)
        back = dist.to_csr()
        np.testing.assert_allclose(np.asarray(back.to_dense()), d,
                                   atol=1e-12)

    def test_transpose_parity(self, rng, mesh):
        import numpy as np

        from spalinalg.parallel.partition import partition_csr
        from spalinalg.parallel.spmv import shard_vector, unshard_vector
        from spalinalg.parallel.spmv import dist_spmv
        from spalinalg import CooMatrix, CsrMatrix

        n = 64
        d = np.where(rng.random((n, n)) < 0.1, rng.normal(size=(n, n)), 0)
        rows, cols = np.nonzero(d)
        csr = CsrMatrix.from_coo(CooMatrix.with_triplets(
            n, n, rows.tolist(), cols.tolist(), d[rows, cols].tolist()))
        dist_t = partition_csr(csr, mesh).transpose()
        x = rng.normal(size=n)
        y = unshard_vector(dist_spmv(dist_t, shard_vector(x, dist_t)),
                           dist_t)
        np.testing.assert_allclose(np.asarray(y), d.T @ x, atol=1e-10)


class TestDistSpgemm:
    def test_product_parity(self, rng):
        """dA * dB == A * B (host re-partition path, setup-class)."""
        import scipy.sparse as sps

        from spalinalg import CsrMatrix
        from spalinalg.dtypes import INDEX_DTYPE
        from spalinalg.parallel.partition import (make_row_mesh,
                                                      partition_csr)

        A = sps.random(60, 40, 0.1, random_state=3).tocsr()
        B = sps.random(40, 52, 0.1, random_state=4).tocsr()
        A.sort_indices(); B.sort_indices()

        def mk(S):
            return CsrMatrix._from_parts(
                S.shape[0], S.shape[1],
                jnp.asarray(S.indptr, dtype=INDEX_DTYPE),
                jnp.asarray(S.indices, dtype=INDEX_DTYPE),
                jnp.asarray(S.data))

        mesh = make_row_mesh(8)
        dP = partition_csr(mk(A), mesh) * partition_csr(mk(B), mesh)
        np.testing.assert_allclose(
            np.asarray(dP.to_csr().to_dense()), (A @ B).toarray(),
            atol=1e-12)

    def test_shape_mismatch(self, rng):
        from spalinalg import CsrMatrix
        from spalinalg.errors import ShapeError
        from spalinalg.parallel.partition import (make_row_mesh,
                                                      partition_csr)

        mesh = make_row_mesh(8)
        a = partition_csr(CsrMatrix.eye(10), mesh)
        b = partition_csr(CsrMatrix.eye(12), mesh)
        with pytest.raises(ShapeError):
            a * b
