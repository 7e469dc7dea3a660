"""Bench-harness smoke tests (CPU): the driver runs bench.py on real
hardware; these guarantee the harness itself cannot crash or emit a
malformed metric line."""

import json
import os
import subprocess
import sys

import numpy as np


def test_measure_helpers_cpu():
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import bench

    bsr, x0, nnz = bench._make_bsr(8, "f32")
    assert nnz > 0
    per, diag = bench._measure(lambda v: bsr @ v, x0, ks=(1, 2, 3), reps=1)
    assert per is None or per > 0
    assert "totals_ms" in diag

    csr, cx, cnnz = bench._make_csr(1 << 10, 8)
    assert bench._csr_path(csr, cx) == "bucket_plan"
    assert bench._bsr_path(bsr, x0) == "xla"


def test_measure_rejects_impossible_rates():
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import bench

    bsr, x0, _ = bench._make_bsr(4, "f32")
    # a roofline so low no real measurement can satisfy it -> must
    # come back as None (invalid), never as a number
    per, diag = bench._measure(lambda v: bsr @ v, x0, ks=(1, 2, 3),
                               reps=1, max_rate=1e-12, tries=2)
    assert per is None


def _run_bench(*args):
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run(
        [sys.executable, os.path.join(repo, "bench.py"), *args],
        capture_output=True, text=True, timeout=600, env=env, cwd=repo)


def test_bench_main_cpu_emits_valid_json():
    """Run the whole harness as a CPU rehearsal; the last stdout line
    must be the metric contract, naming the device it ran on and
    claiming no roofline share for it."""
    out = _run_bench("--rehearse")
    assert out.returncode == 0, out.stderr[-2000:]
    line = out.stdout.strip().splitlines()[-1]
    d = json.loads(line)
    assert d["metric"] == "bsr_banded_spmv_f32_nnz_per_s"
    assert isinstance(d["value"], (int, float))
    assert d["vs_baseline"] is None          # no peaks for a CPU
    assert d["unit"] == "nnz/s"
    assert d["device"]["platform"] == "cpu"
    assert d["device"]["count"] >= 1 and d["card"] is None
    sec = d["secondary"]
    assert not [k for k in sec if k.endswith("_roofline_frac")]
    assert not [k for k in sec if k.endswith("_error")], sec
    # path tags present for the attributable metrics
    assert sec["bsr_f32_path"] == "xla"
    assert sec["csr_random_spmv_nnz_per_s_path"] == "bucket_plan"
    assert sec["dia_f64_spmv_nnz_per_s_path"] == "xla_fused"


def test_bench_refuses_to_measure_without_a_gpu():
    out = _run_bench()
    assert out.returncode != 0
    assert "needs a GPU" in out.stderr
    assert not out.stdout.strip()
