"""On-disk plan persistence (`utils/plandisk.py`).

The store must be a NON-EXECUTABLE format (a pickle would execute
arbitrary code from a shared/tampered cache dir), keyed on structure
only, with a size cap + LRU eviction.
"""

import os
import zipfile

import numpy as np

import jax.numpy as jnp

from spalinalg.utils import plandisk


def _laplacian_2d(k):
    """5-point Laplacian on a k x k grid as a CsrMatrix (f32)."""
    import scipy.sparse as sps

    from spalinalg import CsrMatrix

    t = sps.diags([-1.0, 4.0, -1.0], [-1, 0, 1], shape=(k, k))
    A = (sps.kron(sps.eye(k), t) + sps.kron(
        sps.diags([-1.0, -1.0], [-1, 1], shape=(k, k)), sps.eye(k))).tocsr()
    A.sort_indices()
    return CsrMatrix(k * k, k * k, A.indptr, A.indices,
                     A.data.astype(np.float32))


def _symbolic(csr):
    from spalinalg.linalg.cholesky import _supernodal_symbolic_cached

    return _supernodal_symbolic_cached(csr, True)


def test_supernodal_plan_npz_roundtrip(tmp_path, monkeypatch):
    monkeypatch.setenv("SPALINALG_PLAN_CACHE", "off")
    perm, plan = _symbolic(_laplacian_2d(10))

    path = str(tmp_path / "plan.npz")
    plandisk._save(path, (perm, plan))
    # the file is a plain npz zip archive, not a pickle
    assert zipfile.is_zipfile(path)
    with np.load(path, allow_pickle=False) as z:
        assert "__meta__" in z.files

    perm2, back = plandisk._load(path)
    np.testing.assert_array_equal(perm2, perm)
    assert type(back) is type(plan)
    assert len(back.levels) == len(plan.levels)
    for l0, l1 in zip(plan.levels, back.levels):
        assert len(l0) == len(l1)
        for b0, b1 in zip(l0, l1):
            assert (b0.nsp, b0.mup) == (b1.nsp, b1.mup)
            np.testing.assert_array_equal(b0.sids, b1.sids)
            np.testing.assert_array_equal(b0.a_dst, b1.a_dst)
            np.testing.assert_array_equal(b0.a_src, b1.a_src)
            assert len(b0.ext) == len(b1.ext)
    np.testing.assert_array_equal(back.sym.snode_ptr, plan.sym.snode_ptr)


def test_structure_key_tracks_version_and_structure(monkeypatch):
    a = (np.arange(5), np.array([1, 2]))
    k0 = plandisk._structure_key("snchol", a, (5, 1))
    assert plandisk._structure_key("snchol", a, (5, 1)) == k0
    assert plandisk._structure_key("snchol", a, (5, 0)) != k0
    assert plandisk._structure_key(
        "snchol", (np.arange(5), np.array([1, 3])), (5, 1)) != k0
    # a layout change (version bump) never serves an old file
    monkeypatch.setattr(plandisk, "_VERSION", plandisk._VERSION + 1)
    assert plandisk._structure_key("snchol", a, (5, 1)) != k0


def test_load_or_build_uses_cache_and_updates_mtime(rng, tmp_path,
                                                    monkeypatch):
    monkeypatch.setenv("SPALINALG_PLAN_CACHE", str(tmp_path))
    calls = []

    class Tiny:
        pass

    import dataclasses

    @dataclasses.dataclass(eq=False)
    class _FakePlan:
        a: np.ndarray
        k: int

    # register the test class in the allowlist for this test only
    monkeypatch.setattr(
        plandisk, "_plan_classes",
        lambda: {"_FakePlan": _FakePlan})

    def build():
        calls.append(1)
        return _FakePlan(a=np.arange(5, dtype=np.int64), k=7)

    p1 = plandisk.load_or_build("t", (np.arange(3),), (1,), build)
    p2 = plandisk.load_or_build("t", (np.arange(3),), (1,), build)
    assert len(calls) == 1  # second came from disk
    assert p2.k == 7
    np.testing.assert_array_equal(np.asarray(p2.a), np.arange(5))
    # a different structure key rebuilds
    plandisk.load_or_build("t", (np.arange(4),), (1,), build)
    assert len(calls) == 2


def test_supernodal_symbolic_roundtrip(rng, tmp_path, monkeypatch):
    """(perm, SupernodalPlan) persists through the npz store and the
    reloaded plan factors to the same panels."""
    monkeypatch.setenv("SPALINALG_PLAN_CACHE", str(tmp_path))
    import jax

    from spalinalg import CsrMatrix
    from spalinalg.dtypes import INDEX_DTYPE
    from spalinalg.linalg.cholesky import cholesky, cholesky_solve

    k = 12
    n = k * k
    rows, cols, vals = [], [], []
    for i in range(k):
        for j in range(k):
            r = i * k + j
            for (ii, jj, v) in ((i, j, 4.0), (i - 1, j, -1.0),
                                (i + 1, j, -1.0), (i, j - 1, -1.0),
                                (i, j + 1, -1.0)):
                if 0 <= ii < k and 0 <= jj < k:
                    rows.append(r)
                    cols.append(ii * k + jj)
                    vals.append(v)
    order = np.lexsort((cols, rows))
    rows = np.asarray(rows)[order]
    cols = np.asarray(cols)[order]
    vals = np.asarray(vals, np.float32)[order]
    rowptr = np.zeros(n + 1, np.int64)
    np.add.at(rowptr, rows + 1, 1)
    np.cumsum(rowptr, out=rowptr)
    csr = CsrMatrix._from_parts(
        n, n, jnp.asarray(rowptr, dtype=INDEX_DTYPE),
        jnp.asarray(cols, dtype=INDEX_DTYPE), jnp.asarray(vals))
    b = jnp.asarray(rng.normal(size=n).astype(np.float32))

    fac1 = cholesky(csr, method="supernodal")
    x1 = np.asarray(cholesky_solve(fac1, b))
    assert len(list(tmp_path.iterdir())) == 1  # plan stored
    # second factor comes from the disk plan; same result
    fac2 = cholesky(csr, method="supernodal")
    x2 = np.asarray(cholesky_solve(fac2, b))
    np.testing.assert_allclose(x1, x2, rtol=1e-6)
    res = np.asarray(csr @ jnp.asarray(x2)) - np.asarray(b)
    assert np.abs(res).max() < 1e-4


def test_eviction_caps_cache_size(tmp_path, monkeypatch):
    monkeypatch.setenv("SPALINALG_PLAN_CACHE_MAX_MB", "1")
    # write 5 x ~400 KB files with increasing mtimes
    for i in range(5):
        p = tmp_path / f"f{i}.npz"
        p.write_bytes(bytes(400_000))
        os.utime(p, (1_000_000 + i, 1_000_000 + i))
    plandisk._evict(str(tmp_path))
    left = sorted(f.name for f in tmp_path.iterdir())
    total = sum(f.stat().st_size for f in tmp_path.iterdir())
    assert total <= 1_000_000
    # oldest went first
    assert "f0.npz" not in left and "f4.npz" in left


def test_corrupt_cache_falls_back_to_rebuild(tmp_path, monkeypatch):
    monkeypatch.setenv("SPALINALG_PLAN_CACHE", str(tmp_path))
    import dataclasses

    @dataclasses.dataclass(eq=False)
    class _FakePlan:
        k: int

    monkeypatch.setattr(plandisk, "_plan_classes",
                        lambda: {"_FakePlan": _FakePlan})
    calls = []

    def build():
        calls.append(1)
        return _FakePlan(k=3)

    plandisk.load_or_build("c", (), (9,), build)
    # corrupt the stored file
    (fname,) = [f for f in tmp_path.iterdir()]
    fname.write_bytes(b"not an npz")
    p = plandisk.load_or_build("c", (), (9,), build)
    assert p.k == 3 and len(calls) == 2
