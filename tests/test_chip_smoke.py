"""chip_smoke.py: refuses to run without a GPU, and its phases and
reference checks hold at tiny sizes on the CPU."""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import scipy.sparse as sps

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as cs  # noqa: E402


def _run(script, cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, script], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_exits_nonzero_without_gpu():
    out = _run(os.path.join(REPO, "chip_smoke.py"), REPO)
    assert out.returncode != 0
    assert "needs a GPU" in out.stderr
    assert '"ok"' not in out.stdout


def test_exits_nonzero_alone(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    out = _run(str(tmp_path / "chip_smoke.py"), str(tmp_path))
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_all_single_device_phases_tiny(capsys):
    cs.run_single(cs.TINY)
    lines = capsys.readouterr().out.splitlines()
    phases = [ln for ln in lines if ln.startswith("[smoke]")]
    assert len(phases) >= 20
    assert all("path=" in ln and "first=" in ln for ln in phases)


def test_distributed_phases_tiny(capsys):
    cs.run_dist(cs.TINY, 4)
    out = capsys.readouterr().out
    for name in ("dist spmv halo", "dist spmv allgather", "dist cg",
                 "dist bsr spmv", "dist spgemm"):
        assert name in out


def test_rel_err_and_check_close():
    ref = np.array([1.0, -2.0, 4.0])
    assert cs.rel_err(ref, ref) == 0.0
    assert cs.rel_err(ref + [0, 0, 4e-6], ref) == pytest.approx(1e-6)
    cs.check_close("ok", ref * (1 + 1e-7), ref, 1e-6)
    with pytest.raises(cs.SmokeFailure, match="relative error"):
        cs.check_close("bad", ref * (1 + 1e-3), ref, 1e-6)
    with pytest.raises(cs.SmokeFailure, match="non-finite"):
        cs.check_close("nan", np.array([1.0, np.nan, 0.0]), ref, 1.0)
    with pytest.raises(cs.SmokeFailure, match="shape"):
        cs.check_close("shape", ref[:2], ref, 1.0)


def test_check_csr_equal_catches_structure():
    import spalinalg as sp

    A = cs.laplacian_3d(3)
    csr = sp.CsrMatrix(*A.shape, A.indptr, A.indices, A.data)
    cs.check_csr_equal("same", csr, A)
    B = A.copy()
    B[0, 26] = 1.0               # one more stored entry
    with pytest.raises(cs.SmokeFailure, match="ptr"):
        cs.check_csr_equal("other", csr, B.tocsr())
    with pytest.raises(cs.SmokeFailure, match="values"):
        cs.check_csr_equal("vals", csr, (A * 2).tocsr())


@pytest.mark.parametrize("k", [3, 7])
def test_laplacian_and_triplets(rng, k):
    A = cs.laplacian_3d(k)
    n = k ** 3
    assert A.shape == (n, n)
    assert A.nnz == 7 * n - 6 * k * k       # no explicit zeros
    assert A.sum(axis=1).A1[n // 2] == 0.0  # interior row: 6 - 6
    rows, cols, vals = cs.laplacian_triplets(A, rng)
    back = sps.coo_matrix((vals, (rows, cols)), shape=A.shape).tocsr()
    assert (back != A).nnz == 0
    C = cs.laplacian_3d(k, convection=0.3)
    assert (C != C.T).nnz > 0 and C.nnz == A.nnz


def test_input_generators(rng):
    A = cs.random_csr(256, 8, np.float32, rng)
    assert np.all(np.diff(A.indptr) == 8)
    for r in range(256):
        assert np.all(np.diff(A.indices[A.indptr[r]:A.indptr[r + 1]]) > 0)
    P = cs.power_law_csr(512, np.float64, rng)
    assert P.has_sorted_indices and P.nnz > 512
    P.sum_duplicates()
    assert P.nnz == P.indices.size
    indptr, indices, data = cs.block_banded(5, 16, np.float32, rng)
    assert list(np.diff(indptr)) == [2, 3, 3, 3, 2]
    assert data.shape == (13, 16, 16)


def test_dia_reference_matches_library(rng):
    import spalinalg as sp

    n, offs = 700, [-300, -1, 0, 7, 333]
    data, ref = cs.dia_data(n, offs, np.float64, rng)
    x = rng.normal(size=n)
    y = np.asarray(sp.DiaMatrix(n, n, offs, data) @ x)
    np.testing.assert_allclose(y, ref @ x, atol=1e-12 * np.abs(y).max())


def test_json_line_contract(monkeypatch, capsys):
    """With a GPU (stood in for here) the last line is the contract."""
    import jax

    class FakeDev:
        platform, device_kind = "gpu", "NVIDIA H100 80GB HBM3"

    monkeypatch.setattr(jax, "devices", lambda: [FakeDev()])
    monkeypatch.setattr(cs, "run_single", lambda S, seed=0: None)
    from spalinalg.utils import metrics

    from spalinalg.utils import compile_cache

    monkeypatch.setattr(metrics, "gpu_card",
                        lambda: "NVIDIA H100 80GB HBM3, 700.00 W")
    monkeypatch.setattr(compile_cache, "enable_compile_cache",
                        lambda: "(cache)")
    assert cs.main([]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert any("NVIDIA H100 80GB HBM3, 700.00 W" in ln
               for ln in lines[:-1])
    assert json.loads(lines[-1]) == {"ok": True, "device": {
        "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1}}
