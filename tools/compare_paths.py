"""Time the alternative implementations of each op on the current GPU.

    python tools/compare_paths.py [--only bsr] [--out results/paths.jsonl]

For every op with two candidate paths — BSR SpMV (XLA batched einsum
vs the Triton kernel), CSR SpMV/SpMM (bucket plan vs ``segment_sum``) —
it checks the candidates against each other and times them in the
order A, B, B, A with ``bench._measure`` (loop slope,
``block_until_ready``). It also times the single-path ops (BSR SpMM,
DIA, SpGEMM numeric, a large copy) and counts the fusions XLA makes of
DIA SpMV. Large operands enter the timed loops as arguments. One JSON
object per measurement is appended to ``--out``; a summary goes to
stdout, headed by the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import traceback
from functools import partial

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import numpy as np  # noqa: E402

import bench  # noqa: E402


def _time(fn, x, ks, operand=None):
    per, diag = bench._measure(fn, x, ks=ks, reps=3, operand=operand)
    return per


def _abba(rec, name, fa, fb, x, ks, out, operand=None):
    """Time fa, fb, fb, fa on the same input; record all four."""
    ta1 = _time(fa, x, ks, operand)
    tb1 = _time(fb, x, ks, operand)
    tb2 = _time(fb, x, ks, operand)
    ta2 = _time(fa, x, ks, operand)
    row = dict(rec, op=name, a_ms=[ta1 and ta1 * 1e3, ta2 and ta2 * 1e3],
               b_ms=[tb1 and tb1 * 1e3, tb2 and tb2 * 1e3])
    out.write(json.dumps(row) + "\n")
    out.flush()
    print(f"{name:<34} {rec['a']:>12} {row['a_ms']}  "
          f"{rec['b']:>12} {row['b_ms']}", flush=True)


def _one(rec, name, fn, x, ks, out, operand=None):
    t = _time(fn, x, ks, operand)
    row = dict(rec, op=name, ms=t and t * 1e3)
    out.write(json.dumps(row) + "\n")
    out.flush()
    print(f"{name:<34} {row['ms']}", flush=True)


def _check(name, a, b, tol):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    err = float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-30))
    if not err <= tol:
        raise AssertionError(f"{name}: paths disagree, rel err {err:.3e}")
    return err


def bsr_cases(out):
    import jax
    import jax.numpy as jnp

    from spalinalg.ops import bsr_ops
    from spalinalg.ops.kernels.bsr_triton import bsr_matvec_call

    for dtype, nbr in (("f32", 1024), ("bf16", 2048)):
        bsr, x0, nnz = bench._make_bsr(nbr, dtype)
        # the BSR arrays enter each compiled loop as arguments
        op = (bsr.indptr, bsr.indices, bsr.data)

        def xla(op, v):
            return bsr_ops._xla_matvec(*op, v, nbr=nbr)

        def tri(op, v):
            return bsr_matvec_call(*op, v, nbr=nbr)

        err = _check(f"bsr spmv {dtype}", jax.jit(tri)(op, x0),
                     jax.jit(xla)(op, x0), 1e-5)
        _abba({"a": "xla", "b": "triton", "nnz": nnz, "err": err},
              f"bsr_spmv_{dtype}_nbr{nbr}", xla, tri, x0,
              (128, 640, 1152), out, op)
        K = 64
        X0 = jax.random.normal(jax.random.PRNGKey(3), (nbr * 128, K),
                               jnp.float32)

        def xla_mm(op, X):
            return bsr_ops._xla_matmat(*op, X, nbr=nbr)

        _one({"nnz": nnz, "K": K}, f"bsr_spmm_{dtype}_k64_nbr{nbr}",
             xla_mm, X0, (16, 80, 144), out, op)
        del bsr, x0, X0


def csr_cases(out):
    import jax
    import jax.numpy as jnp

    from spalinalg.ops import matvec as mv

    for dtype, rows in (("f32", 1 << 16), ("f32", 1 << 20),
                        ("f64", 1 << 15), ("f64", 1 << 20)):
        vdt = np.float64 if dtype == "f64" else np.float32
        csr, x0, nnz = bench._make_csr(rows, 32, vdt)
        plan = mv._row_plan(csr)
        bucket = partial(mv._plan_spmv_jit, plan, csr.colind, csr.values)
        segsum = partial(mv._csr_spmv_kernel, csr.rowptr, csr.colind,
                         csr.values, nrows=csr.nrows)
        err = _check(f"csr spmv {dtype}", bucket(x0), segsum(x0),
                     1e-5 if dtype == "f32" else 1e-12)
        _abba({"a": "bucket_plan", "b": "segment_sum", "nnz": nnz,
               "mbytes": nnz * (2 * np.dtype(vdt).itemsize + 4) >> 20,
               "err": err},
              f"csr_spmv_{dtype}_rows{rows}", bucket, segsum, x0,
              (16, 80, 144), out)
    for rows in (1 << 14, 1 << 18):
        csr, _, nnz = bench._make_csr(rows, 32)
        X0 = jax.random.normal(jax.random.PRNGKey(4), (rows, 64),
                               jnp.float32)
        plan = mv._row_plan(csr)
        bucket = partial(mv._plan_spmm_jit, plan, csr.colind, csr.values)
        segsum = partial(mv._csr_spmm_kernel, csr.rowptr, csr.colind,
                         csr.values, nrows=csr.nrows)
        err = _check("csr spmm", bucket(X0), segsum(X0), 1e-5)
        _abba({"a": "bucket_plan", "b": "segment_sum", "nnz": nnz,
               "K": 64, "err": err},
              f"csr_spmm_f32_k64_rows{rows}", bucket, segsum, X0,
              (8, 40, 72), out)


def dia_cases(out):
    import jax
    import jax.numpy as jnp

    from spalinalg import DiaMatrix

    offs = [-300, -130, -1, 0, 1, 7, 129, 250, 333]
    for vdt, n in ((jnp.float32, 1 << 22), (jnp.float64, 1 << 21)):
        data = jax.random.normal(jax.random.PRNGKey(0), (len(offs), n), vdt)
        dia = DiaMatrix(n, n, offs, data)
        x0 = jax.random.normal(jax.random.PRNGKey(1), (n,), vdt)
        hlo = jax.jit(lambda v: dia @ v).lower(x0).compile().as_text()
        entry = hlo[hlo.index("ENTRY"):]
        fusions = entry.count(" fusion(")
        kinds = sorted({ln.split("kind=")[1].split(",")[0]
                        for ln in entry.splitlines() if "kind=" in ln})
        _one({"fusions_in_entry": fusions, "fusion_kinds": kinds,
              "nnz": dia.nnz},
             f"dia_spmv_{jnp.dtype(vdt).name}_n{n}", lambda v: dia @ v,
             x0, (32, 160, 288), out)
        print(f"  dia {jnp.dtype(vdt).name}: {fusions} fusion(s) in the "
              f"entry computation, kinds {kinds}", flush=True)


def spgemm_case(out):
    import jax.numpy as jnp

    from spalinalg import CsrMatrix
    from spalinalg.dtypes import INDEX_DTYPE
    from spalinalg.ops import spgemm as sg

    n = 1 << 15
    rng = np.random.default_rng(1)
    deg = np.minimum(rng.zipf(1.8, size=n), 512)
    rowptr = np.concatenate([[0], np.cumsum(deg)]).astype(np.int64)
    colind = rng.integers(0, n, size=int(rowptr[-1]))
    srt = np.lexsort((colind, np.repeat(np.arange(n), deg)))
    a = CsrMatrix._from_parts(
        n, n, jnp.asarray(rowptr, dtype=INDEX_DTYPE),
        jnp.asarray(colind[srt], dtype=INDEX_DTYPE),
        jnp.asarray(rng.normal(size=colind.size).astype(np.float32)))
    plan = sg.spgemm_plan(a, a)

    def body(v):
        y = sg._spgemm_numeric(plan.a_idx, plan.b_idx, plan.gid, v,
                               a.values, n_out=plan.n_out)
        return v * (1.0 + jnp.sum(y) * 1e-12)

    _one({"terms": int(plan.a_idx.shape[0]), "n_out": plan.n_out},
         "spgemm_numeric_f32_powerlaw_n32768", body, a.values,
         (4, 20, 36), out)


def copy_case(out):
    import jax
    import jax.numpy as jnp

    x0 = jax.random.normal(jax.random.PRNGKey(7), (1 << 28,), jnp.float32)
    _one({"bytes_per_iter_min": 8 << 28}, "copy_f32_1GiB",
         lambda v: v * 1.0001, x0, (8, 40, 72), out)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="results/paths.jsonl")
    ap.add_argument("--only", default="")
    args = ap.parse_args()

    import jax

    from spalinalg.utils.compile_cache import enable_compile_cache
    from spalinalg.utils.metrics import gpu_card

    if jax.devices()[0].platform != "gpu":
        print("compare_paths: needs a GPU", file=sys.stderr)
        return 2
    enable_compile_cache()
    card = gpu_card()
    print(f"card: {card}; device_kind: {jax.devices()[0].device_kind}",
          flush=True)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    only = {s for s in args.only.split(",") if s}
    failed = []
    with open(args.out, "a") as out:
        out.write(json.dumps({"card": card,
                              "kind": jax.devices()[0].device_kind}) + "\n")
        for name, fn in (("bsr", bsr_cases), ("dia", dia_cases),
                         ("csr", csr_cases), ("spgemm", spgemm_case),
                         ("copy", copy_case)):
            if only and name not in only:
                continue
            try:
                fn(out)
            except Exception:  # report, and still measure the others
                traceback.print_exc()
                failed.append(name)
    if failed:
        print(f"compare_paths: failed groups {failed}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
