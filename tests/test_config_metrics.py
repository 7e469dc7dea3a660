"""Config and metrics tiers are consumed by dispatch: every exported
subsystem has a consumer, and a test proves each knob changes
behavior."""

import numpy as np
import pytest
import scipy.sparse as sps

import jax
import jax.numpy as jnp

from spalinalg import CsrMatrix
from spalinalg import config as cfg_mod
from spalinalg.dtypes import INDEX_DTYPE
from spalinalg.utils import metrics


def _csr(n=300, density=0.03, seed=7, dtype=np.float32):
    A = sps.random(n, n, density, random_state=seed).tocsr()
    A.sort_indices()
    return A, CsrMatrix._from_parts(
        n, n,
        jnp.asarray(A.indptr, dtype=INDEX_DTYPE),
        jnp.asarray(A.indices, dtype=INDEX_DTYPE),
        jnp.asarray(A.data.astype(dtype)))


class TestConfigConsumed:
    def test_bucket_widths_change_row_plan(self):
        from spalinalg.ops import matvec as mv

        _, csr = _csr()
        mv._ROW_PLAN_CACHE.clear()
        base = cfg_mod.current_config()
        with cfg_mod.use(base.with_(max_bucket_width=8, min_bucket_width=8)):
            p8 = mv._row_plan(csr)
        with cfg_mod.use(base.with_(max_bucket_width=512, min_bucket_width=4)):
            p512 = mv._row_plan(csr)
        w8 = {w for w, _ in p8.levels[0].buckets}
        w512 = {w for w, _ in p512.levels[0].buckets}
        assert max(w8) <= 8
        assert w8 != w512
        # both plans still reduce correctly
        x = np.ones(csr.nse, np.float32)
        from spalinalg.ops.reduction import segment_reduce
        out8 = np.asarray(segment_reduce(p8, jnp.asarray(x)))
        out512 = np.asarray(segment_reduce(p512, jnp.asarray(x)))
        np.testing.assert_allclose(out8, out512)

    def test_partition_axis_names_mesh(self):
        from spalinalg.parallel.partition import make_row_mesh

        base = cfg_mod.current_config()
        with cfg_mod.use(base.with_(partition_axis="shards")):
            mesh = make_row_mesh(2)
        assert mesh.axis_names == ("shards",)

    def test_use_is_scoped(self):
        base = cfg_mod.current_config()
        with cfg_mod.use(base.with_(rtol_f32=1e-3)):
            assert cfg_mod.current_config().rtol_f32 == 1e-3
        assert cfg_mod.current_config().rtol_f32 == base.rtol_f32


class TestMetricsConsumed:
    def test_spmv_records(self):
        A, csr = _csr()
        x = jnp.ones(300, jnp.float32)
        rec = metrics.enable()
        try:
            n0 = len(rec.records)
            _ = jax.block_until_ready(csr @ x)
            assert len(rec.records) == n0 + 1
            m = rec.records[-1]
            assert m.op == "csr_spmv"
            assert m.nnz == csr.nse
            assert m.seconds > 0
            assert m.nnz_per_s > 0
        finally:
            metrics.disable()

    def test_spgemm_records(self):
        _, a = _csr(seed=1)
        _, b = _csr(seed=2)
        rec = metrics.enable()
        try:
            n0 = len(rec.records)
            _ = a * b
            ops = [m.op for m in rec.records[n0:]]
            assert "spgemm" in ops
        finally:
            metrics.disable()

    def test_csc_mirror_records_once(self):
        from spalinalg.convert.conversions import csr_to_csc

        _, a = _csr(seed=3)
        csc = csr_to_csc(a)
        rec = metrics.enable()
        try:
            n0 = len(rec.records)
            _ = jax.block_until_ready(csc @ jnp.ones(300, jnp.float32))
            new = rec.records[n0:]
            assert [m.op for m in new] == ["csc_spmv"]
        finally:
            metrics.disable()

    def test_disabled_recorder_records_nothing(self):
        _, csr = _csr(seed=4)
        rec = metrics.recorder()
        n0 = len(rec.records)
        _ = jax.block_until_ready(csr @ jnp.ones(300, jnp.float32))
        assert len(rec.records) == n0


class TestNativeLevelSchedule:
    def test_native_matches_python(self):
        from spalinalg.linalg.ordering import level_schedule
        from spalinalg.native import lib as native

        if not native.available():
            pytest.skip("native library unavailable")
        n = 5000  # above the native-dispatch threshold
        A = sps.random(n, n, 0.001, random_state=5).tocsr()
        L = sps.tril(A, k=-1).tocsr() + sps.eye(n, format="csr")
        L.sort_indices()
        ptr, ind = L.indptr.astype(np.int64), L.indices.astype(np.int64)
        b_native, o_native = level_schedule(ptr, ind, n, lower=True)

        # pure-python reference (force the fallback)
        lev = np.zeros(n, dtype=np.int64)
        for i in range(n):
            deps = ind[ptr[i]:ptr[i + 1]]
            deps = deps[deps < i]
            if deps.size:
                lev[i] = lev[deps].max() + 1
        nl = int(lev.max()) + 1
        order = np.argsort(lev, kind="stable")
        bounds = np.searchsorted(lev[order], np.arange(nl + 1))
        np.testing.assert_array_equal(b_native, bounds)
        np.testing.assert_array_equal(o_native, order)
