"""Chip smoke test: the library's main path once on one GPU, checked
against scipy on the host.

    python chip_smoke.py             # one GPU, every single-device phase
    python chip_smoke.py --chips 4   # the distributed tier on four GPUs

Each phase goes through the public API (``CooMatrix``, ``CsrMatrix``,
``CscMatrix``, ``BsrMatrix``, ``DiaMatrix`` with ``@``, ``+``, ``-``,
``*``, ``linalg.cg``, ``cholesky``, ``lu``, ``spalinalg.parallel``) at
the sizes in ``FULL``, and prints the dispatch path taken, the first-call
(compile) time and the warm time. Any failure ends the run with a nonzero
exit code. The last line of standard output is one JSON object naming
the device, printed only when every phase passed. The script refuses to
run when JAX's first device is not a GPU.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

# Tolerances, each with its reason. The device sums in another order
# than scipy (and in f32 where the data is f32), so equality is asked
# only where no arithmetic happens.
TOL_F32 = 1e-5    # f32 data: rounding 6e-8 per add over rows of <= 384
#                   terms, measured in the inf-norm of the result
TOL_F64 = 1e-12   # f64 data: the same argument at 1.1e-16 per add
CG_RTOL = 1e-8    # CG stops at ||r|| <= CG_RTOL ||b||; the host checks
#                   the true residual b - A x in f64 against the same bound
FACTOR_RESID = 1e-10  # direct solves: ||A x - b|| / ||b||, f64
FACTOR_VS_REF = 1e-8  # and agreement with scipy's x: the condition number
#                       of a 40^3 Laplacian (~700) times FACTOR_RESID

# Sizes. FULL is what the script runs; tests pass TINY to the phase
# functions to check the reference logic on the CPU.
FULL = dict(lap=128, rand_rows=1 << 20, mm_rows=1 << 18, row_nnz=32,
            K=64, bs=128, bsr_nbr=1024, bsr_bf16_nbr=2048, bsr_mm_nbr=256,
            dia_n=1 << 22, pl_n=1 << 17, fact=40,
            dist_lap=216, dist_gemm_lap=64, dist_bsr_nbr=1024)
TINY = dict(lap=6, rand_rows=1 << 9, mm_rows=1 << 8, row_nnz=8,
            K=8, bs=16, bsr_nbr=8, bsr_bf16_nbr=8, bsr_mm_nbr=4,
            dia_n=1 << 11, pl_n=1 << 9, fact=5,
            dist_lap=6, dist_gemm_lap=4, dist_bsr_nbr=8)

DIA_OFFSETS = (-300, -130, -1, 0, 1, 7, 129, 250, 333)


class SmokeFailure(AssertionError):
    """A phase's result is outside its tolerance."""


def rel_err(got, ref) -> float:
    """Relative error in the inf-norm: max|got - ref| / max|ref|."""
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    if got.shape != ref.shape:
        raise SmokeFailure(f"shape {got.shape} != reference {ref.shape}")
    if not np.all(np.isfinite(got)):
        raise SmokeFailure("non-finite values in the result")
    scale = float(np.max(np.abs(ref))) if ref.size else 0.0
    return float(np.max(np.abs(got - ref))) / (scale if scale else 1.0)


def check_close(name, got, ref, tol) -> float:
    err = rel_err(got, ref)
    if not err <= tol:
        raise SmokeFailure(f"{name}: relative error {err:.3e} > {tol:.0e}")
    return err


def check_equal(name, got, ref) -> None:
    got, ref = np.asarray(got), np.asarray(ref)
    if got.shape != ref.shape or not np.array_equal(got, ref):
        raise SmokeFailure(f"{name}: arrays differ from the reference")


def check_csr_equal(name, mat, ref, *, values_tol=None) -> float:
    """Structure of ``mat`` (CSR/CSC) exactly equal to scipy's ``ref``;
    values exactly equal, or within ``values_tol``."""
    ref = ref.copy()
    ref.sort_indices()
    nnz = int(np.asarray(mat._ptr)[-1])
    check_equal(name + " ptr", np.asarray(mat._ptr), ref.indptr)
    check_equal(name + " indices", np.asarray(mat._minor)[:nnz], ref.indices)
    vals = np.asarray(mat._values)[:nnz]
    if values_tol is None:
        check_equal(name + " values", vals, ref.data)
        return 0.0
    return check_close(name + " values", vals, ref.data, values_tol)


# ---------------------------------------------------------------------
# Inputs, made from a seed on the host
# ---------------------------------------------------------------------

def laplacian_3d(k: int, convection: float = 0.0):
    """7-point Laplacian on a k^3 grid (scipy CSR, f64). ``convection``
    adds a first-order term along x, making the values nonsymmetric on
    the same structure."""
    import scipy.sparse as sps

    one = sps.diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(k, k))
    eye = sps.identity(k)
    conv = sps.diags([-convection, convection], [-1, 1], shape=(k, k))
    A = (sps.kron(sps.kron(eye, eye), one + conv)
         + sps.kron(sps.kron(eye, one), eye)
         + sps.kron(sps.kron(one, eye), eye)).tocsr()
    A.eliminate_zeros()   # kron of banded factors stores explicit zeros
    A.sort_indices()
    return A


def laplacian_triplets(A, rng):
    """Shuffled COO triplets of ``A`` with every diagonal entry split in
    two halves (exact in binary), so conversion must sort and merge."""
    coo = A.tocoo()
    d = coo.row == coo.col
    rows = np.concatenate([coo.row, coo.row[d]])
    cols = np.concatenate([coo.col, coo.col[d]])
    vals = np.concatenate([np.where(d, coo.data / 2, coo.data),
                           coo.data[d] / 2])
    p = rng.permutation(rows.size)
    return rows[p], cols[p], vals[p]


def random_csr(n: int, row_nnz: int, dtype, rng):
    """n x n, ``row_nnz`` distinct sorted columns per row spread over the
    whole width (one random column in each of ``row_nnz`` stripes)."""
    import scipy.sparse as sps

    stripe = n // row_nnz
    cols = (np.arange(row_nnz) * stripe
            + rng.integers(0, stripe, size=(n, row_nnz))).reshape(-1)
    ptr = np.arange(n + 1, dtype=np.int64) * row_nnz
    vals = rng.normal(size=n * row_nnz).astype(dtype)
    return sps.csr_matrix((vals, cols, ptr), shape=(n, n))


def power_law_csr(n: int, dtype, rng, *, exponent=1.8, cap=512):
    """Power-law rows: zipf(exponent) degrees capped at ``cap``, uniform
    random distinct columns."""
    import scipy.sparse as sps

    deg = np.minimum(rng.zipf(exponent, size=n), cap)
    rows = np.repeat(np.arange(n, dtype=np.int64), deg)
    keys = np.unique(rows * n + rng.integers(0, n, size=rows.size))
    rows, cols = keys // n, keys % n
    vals = rng.normal(size=keys.size).astype(dtype)
    A = sps.csr_matrix((vals, (rows, cols)), shape=(n, n))
    A.sort_indices()
    return A


def block_banded(nbr: int, bs: int, dtype, rng, band=1):
    """Block-banded BSR arrays: block row i holds block columns
    i-band..i+band (the bench's headline shape at band=1)."""
    indptr, indices = [0], []
    for i in range(nbr):
        indices.extend(j for j in range(i - band, i + band + 1)
                       if 0 <= j < nbr)
        indptr.append(len(indices))
    data = rng.standard_normal((len(indices), bs, bs), dtype=np.float32)
    return (np.asarray(indptr), np.asarray(indices), data.astype(dtype))


def dia_data(n: int, offsets, dtype, rng):
    """Row-aligned DIA data (zero outside the matrix) and the scipy
    (column-aligned) ``dia_matrix`` of the same operator."""
    import scipy.sparse as sps

    data = rng.standard_normal((len(offsets), n), dtype=np.float32)
    data = data.astype(dtype)
    col_aligned = np.zeros_like(data)
    for k, o in enumerate(offsets):
        lo, hi = max(-o, 0), min(n, n - o)      # rows i with 0<=i+o<n
        data[k, :lo] = 0
        data[k, hi:] = 0
        col_aligned[k, lo + o:hi + o] = data[k, lo:hi]
    return data, sps.dia_matrix((col_aligned, list(offsets)), shape=(n, n))


# ---------------------------------------------------------------------
# Timing
# ---------------------------------------------------------------------

def timed(fn):
    """(result, first-call seconds, warm seconds) of ``fn()``; both
    calls end in ``block_until_ready``."""
    import jax

    t0 = time.perf_counter()
    out = jax.block_until_ready(fn())
    t1 = time.perf_counter()
    out = jax.block_until_ready(fn())
    return out, t1 - t0, time.perf_counter() - t1


def report(phase, path, t_first, t_warm, **extra):
    items = " ".join(f"{k}={v}" for k, v in extra.items())
    print(f"[smoke] {phase:<28} path={path:<22} first={t_first:8.3f}s "
          f"warm={t_warm * 1e3:10.3f}ms {items}", flush=True)


# ---------------------------------------------------------------------
# Single-device phases
# ---------------------------------------------------------------------

def phase_build_convert(S, rng):
    import spalinalg as sp

    A = laplacian_3d(S["lap"])
    n = A.shape[0]
    rows, cols, vals = laplacian_triplets(A, rng)
    t0 = time.perf_counter()
    coo = sp.CooMatrix.with_triplets(n, n, rows, cols, vals)
    csr = sp.CsrMatrix.from_coo(coo)
    t_csr = time.perf_counter() - t0
    check_csr_equal("coo->csr", csr, A)
    csc, t_first, t_warm = timed(lambda: csr.to_csc())
    check_csr_equal("csr->csc", csc, A.tocsc())
    tr = csr.transpose()
    check_csr_equal("transpose", tr, A.T.tocsr())
    report("build+convert", "host sort / device sort", t_first, t_warm,
           n=n, nnz=A.nnz, coo_to_csr_s=f"{t_csr:.2f}")
    return A, csr


def phase_csr_spmv_f64(S, rng, A, csr):
    from spalinalg.ops.matvec import csr_path

    x = rng.normal(size=A.shape[1])
    y, t_first, t_warm = timed(lambda: csr @ x)
    err = check_close("csr spmv f64", y, A @ x, TOL_F64)
    report("csr spmv f64 laplacian", csr_path(csr), t_first, t_warm,
           err=f"{err:.2e}")


def phase_csr_spmv_f32(S, rng):
    import spalinalg as sp
    from spalinalg.ops.matvec import csr_path

    A = random_csr(S["rand_rows"], S["row_nnz"], np.float32, rng)
    csr = sp.CsrMatrix(*A.shape, A.indptr, A.indices, A.data)
    x = rng.normal(size=A.shape[1]).astype(np.float32)
    y, t_first, t_warm = timed(lambda: csr @ x)
    ref = A.astype(np.float64) @ x.astype(np.float64)
    err = check_close("csr spmv f32", y, ref, TOL_F32)
    report("csr spmv f32 random", csr_path(csr), t_first, t_warm,
           nnz=A.nnz, err=f"{err:.2e}")


def phase_csr_csc_spmm(S, rng):
    import spalinalg as sp
    from spalinalg.ops.matvec import csr_path

    A = random_csr(S["mm_rows"], S["row_nnz"], np.float32, rng)
    csr = sp.CsrMatrix(*A.shape, A.indptr, A.indices, A.data)
    csc = csr.to_csc()
    X = rng.normal(size=(A.shape[1], S["K"])).astype(np.float32)
    ref = A.astype(np.float64) @ X.astype(np.float64)
    for name, mat in (("csr", csr), ("csc", csc)):
        Y, t_first, t_warm = timed(lambda: mat @ X)
        err = check_close(f"{name} spmm", Y, ref, TOL_F32)
        report(f"{name} spmm K={S['K']}", csr_path(csr), t_first, t_warm,
               err=f"{err:.2e}")


def _bsr(S, nbr, dtype, rng, band=1):
    import scipy.sparse as sps

    import spalinalg as sp

    bs = S["bs"]
    indptr, indices, data = block_banded(nbr, bs, np.float32 if dtype ==
                                         "bf16" else dtype, rng, band)
    n = nbr * bs
    bsr = sp.BsrMatrix(n, n, bs, indptr, indices, data)
    if dtype == "bf16":
        import jax.numpy as jnp

        bsr = bsr.astype(jnp.bfloat16)
        data = np.asarray(bsr.data.astype(jnp.float32))
    ref = sps.bsr_matrix((data.astype(np.float64), indices, indptr),
                         shape=(n, n))
    return bsr, ref


def phase_bsr(S, rng):
    from spalinalg.ops.bsr_ops import bsr_path

    for dtype, nbr, tol in ((np.float32, S["bsr_nbr"], TOL_F32),
                            ("bf16", S["bsr_bf16_nbr"], TOL_F32),
                            (np.float64, S["bsr_nbr"], TOL_F64)):
        bsr, ref = _bsr(S, nbr, dtype, rng)
        xdt = np.float64 if dtype is np.float64 else np.float32
        x = rng.normal(size=ref.shape[1]).astype(xdt)
        y, t_first, t_warm = timed(lambda: bsr @ x)
        err = check_close(f"bsr spmv {bsr.dtype}", y, ref @ x, tol)
        report(f"bsr spmv {bsr.dtype} nbr={nbr}", bsr_path(bsr, x),
               t_first, t_warm, mbytes=bsr.data.nbytes >> 20,
               err=f"{err:.2e}")
        del bsr, ref
    # f32 SpMM takes the kernel on a GPU; f64 the XLA path, at the
    # bench's SpMV shape and in this process's default memory setting
    for dtype, nbr, tol in ((np.float32, S["bsr_mm_nbr"], TOL_F32),
                            (np.float64, S["bsr_nbr"], TOL_F64)):
        bsr, ref = _bsr(S, nbr, dtype, rng)
        X = rng.normal(size=(ref.shape[1], S["K"])).astype(dtype)
        Y, t_first, t_warm = timed(lambda: bsr @ X)
        err = check_close(f"bsr spmm {bsr.dtype}", Y,
                          ref @ X.astype(np.float64), tol)
        report(f"bsr spmm {bsr.dtype} K={S['K']} nbr={nbr}",
               bsr_path(bsr, X), t_first, t_warm, err=f"{err:.2e}")
        del bsr, ref


def phase_dia(S, rng):
    import spalinalg as sp

    n = S["dia_n"]
    offs = [o for o in DIA_OFFSETS if abs(o) < n]
    for dtype, tol in ((np.float32, TOL_F32), (np.float64, TOL_F64)):
        data, ref = dia_data(n, offs, dtype, rng)
        dia = sp.DiaMatrix(n, n, offs, data)
        x = rng.normal(size=n).astype(dtype)
        y, t_first, t_warm = timed(lambda: dia @ x)
        err = check_close(f"dia spmv {np.dtype(dtype).name}", y,
                          ref @ x.astype(np.float64), tol)
        report(f"dia spmv {np.dtype(dtype).name}", "xla_fused", t_first,
               t_warm, n=n, err=f"{err:.2e}")


def phase_spgemm(S, rng):
    import spalinalg as sp

    n = S["pl_n"]
    for dtype, tol in ((np.float32, TOL_F32), (np.float64, TOL_F64)):
        A = power_law_csr(n, dtype, rng)
        B = power_law_csr(n, dtype, rng)
        a = sp.CsrMatrix(n, n, A.indptr, A.indices, A.data)
        b = sp.CsrMatrix(n, n, B.indptr, B.indices, B.data)
        A64, B64 = A.astype(np.float64), B.astype(np.float64)
        name = np.dtype(dtype).name
        c, t_first, t_warm = timed(lambda: a * a)
        err = check_csr_equal(f"spgemm {name}", c, A64 @ A64,
                              values_tol=tol)
        report(f"spgemm A*A {name}", "xla_gather_segsum", t_first, t_warm,
               nnz_a=A.nnz, nnz_c=c.nnz, err=f"{err:.2e}")
        for op, ref in (("+", A64 + B64), ("-", A64 - B64)):
            c, t_first, t_warm = timed(
                lambda: a + b if op == "+" else a - b)
            err = check_csr_equal(f"add {op} {name}", c, ref,
                                  values_tol=tol)
            report(f"A {op} B {name}", "sort_segment", t_first, t_warm,
                   err=f"{err:.2e}")


def phase_cg(S, rng, A, csr):
    import scipy.sparse.linalg as spla

    import spalinalg as sp
    from spalinalg.ops.matvec import csr_path

    b = rng.normal(size=A.shape[0])
    bnorm = float(np.linalg.norm(b))
    # the loop's own residual drifts from the true one by rounding; stop
    # at half the bound so the true residual meets it
    res, t_first, t_warm = timed(lambda: sp.linalg.cg(
        csr, b, tol=0.5 * CG_RTOL * bnorm, precondition="jacobi"))
    x = np.asarray(res.x)
    true_res = float(np.linalg.norm(b - A @ x)) / bnorm
    if not true_res <= CG_RTOL:
        raise SmokeFailure(f"cg: true residual {true_res:.3e} > {CG_RTOL}")
    it_sp = []
    inv_diag = 1.0 / A.diagonal()
    spla.cg(A, b, rtol=CG_RTOL, maxiter=10 * A.shape[0],
            M=spla.LinearOperator(A.shape, matvec=lambda r: inv_diag * r),
            callback=lambda xk: it_sp.append(1))
    report("cg jacobi f64", f"while_loop({csr_path(csr)})", t_first,
           t_warm, iters=int(res.iterations), scipy_iters=len(it_sp),
           resid=f"{true_res:.2e}")


def phase_factorizations(S, rng):
    import scipy.sparse.linalg as spla

    import spalinalg as sp

    for name, conv in (("cholesky", 0.0), ("lu", 0.3)):
        A = laplacian_3d(S["fact"], convection=conv)
        csr = sp.CsrMatrix(*A.shape, A.indptr, A.indices, A.data)
        b = rng.normal(size=A.shape[0])
        if name == "cholesky":
            def solve():
                fac = sp.linalg.cholesky(csr, method="supernodal")
                return sp.linalg.cholesky_solve(fac, b)
        else:
            def solve():
                fac = sp.linalg.lu(csr, method="supernodal")
                return sp.linalg.lu_solve(fac, b)
        x, t_first, t_warm = timed(solve)
        x = np.asarray(x)
        resid = float(np.linalg.norm(A @ x - b) / np.linalg.norm(b))
        if not resid <= FACTOR_RESID:
            raise SmokeFailure(f"{name}: residual {resid:.3e}")
        err = check_close(name, x, spla.spsolve(A.tocsc(), b),
                          FACTOR_VS_REF)
        report(f"{name} 3d n={A.shape[0]}", "supernodal", t_first, t_warm,
               resid=f"{resid:.2e}", err=f"{err:.2e}")


def run_single(S, seed=0):
    rng = np.random.default_rng(seed)
    A, csr = phase_build_convert(S, rng)
    phase_bsr(S, rng)               # the headline path, first
    phase_csr_spmv_f64(S, rng, A, csr)
    phase_csr_spmv_f32(S, rng)
    phase_csr_csc_spmm(S, rng)
    phase_dia(S, rng)
    phase_spgemm(S, rng)
    phase_cg(S, rng, A, csr)
    del A, csr
    phase_factorizations(S, rng)


# ---------------------------------------------------------------------
# Four-device phases (--chips 4)
# ---------------------------------------------------------------------

def run_dist(S, n_dev, seed=0):
    import spalinalg as sp
    from spalinalg import parallel as par

    # single-device comparisons run on jax.devices()[0], the default
    rng = np.random.default_rng(seed)
    mesh = par.make_row_mesh(n_dev)

    A = laplacian_3d(S["dist_lap"])
    n = A.shape[0]
    csr = sp.CsrMatrix(n, n, A.indptr, A.indices, A.data)
    x = rng.normal(size=n)
    y_ref = A @ x
    y_one = np.asarray(csr @ x)
    check_close("one-device spmv", y_one, y_ref, TOL_F64)
    for comm in ("halo", "allgather"):
        d = par.partition_csr(csr, mesh, comm=comm)
        xs = par.shard_vector(x, d)
        y, t_first, t_warm = timed(lambda: par.dist_spmv(d, xs))
        y = np.asarray(par.unshard_vector(y, d))
        e1 = check_close(f"dist spmv {comm} vs scipy", y, y_ref, TOL_F64)
        e2 = check_close(f"dist spmv {comm} vs one device", y, y_one,
                         TOL_F64)
        report(f"dist spmv {comm}", f"shard_map/{d.comm}", t_first,
               t_warm, n=n, err_scipy=f"{e1:.2e}", err_one=f"{e2:.2e}")
        if comm == "halo":
            dist_halo = d

    # CG: both runs stop at ||r|| <= CG_RTOL ||b|| / 2, so their
    # solutions differ by at most (||r_dist|| + ||r_one||) / lambda_min
    # in the 2-norm; lambda_min of the 7-point Laplacian is analytic.
    b = rng.normal(size=n)
    bnorm = float(np.linalg.norm(b))
    tol = 0.5 * CG_RTOL * bnorm
    bs_ = par.shard_vector(b, dist_halo)
    res, t_first, t_warm = timed(lambda: sp.linalg.cg(
        dist_halo, bs_, tol=tol, precondition="jacobi"))
    xd = np.asarray(par.unshard_vector(res.x, dist_halo))
    one = sp.linalg.cg(csr, b, tol=tol, precondition="jacobi")
    x1 = np.asarray(one.x)
    r_d = float(np.linalg.norm(b - A @ xd))
    r_1 = float(np.linalg.norm(b - A @ x1))
    if not max(r_d, r_1) <= CG_RTOL * bnorm:
        raise SmokeFailure(f"dist cg: residuals {r_d:.3e}, {r_1:.3e}")
    k = S["dist_lap"]
    lam_min = 3.0 * (2.0 - 2.0 * np.cos(np.pi / (k + 1)))
    gap = float(np.linalg.norm(xd - x1))
    if not gap <= (r_d + r_1) / lam_min:
        raise SmokeFailure(f"dist cg: solutions differ by {gap:.3e}")
    report("dist cg jacobi f64", "shard_map/halo", t_first, t_warm,
           iters=int(res.iterations), iters_one=int(one.iterations),
           resid=f"{r_d / bnorm:.2e}", gap=f"{gap:.2e}")
    del dist_halo, csr

    bsr, ref = _bsr(S, S["dist_bsr_nbr"], np.float64, rng)
    xb = rng.normal(size=ref.shape[1])
    yb_ref = ref @ xb
    yb_one = np.asarray(bsr @ xb)
    db = par.partition_bsr(bsr, mesh)
    xbs = par.shard_bsr_vector(xb, db)
    yb, t_first, t_warm = timed(lambda: par.dist_bsr_spmv(db, xbs))
    yb = np.asarray(yb)[: ref.shape[0]]
    e1 = check_close("dist bsr vs scipy", yb, yb_ref, TOL_F64)
    e2 = check_close("dist bsr vs one device", yb, yb_one, TOL_F64)
    report("dist bsr spmv f64", "shard_map/allgather", t_first, t_warm,
           err_scipy=f"{e1:.2e}", err_one=f"{e2:.2e}")
    del bsr, db

    G = laplacian_3d(S["dist_gemm_lap"])
    g = sp.CsrMatrix(*G.shape, G.indptr, G.indices, G.data)
    dg = par.partition_csr(g, mesh)
    c, t_first, t_warm = timed(lambda: dg * dg)
    c = c.to_csr()
    c_one = g * g
    e1 = check_csr_equal("dist spgemm vs scipy", c, G @ G,
                         values_tol=TOL_F64)
    check_equal("dist spgemm vs one device ptr", np.asarray(c.rowptr),
                np.asarray(c_one.rowptr))
    e2 = check_close("dist spgemm vs one device",
                     np.asarray(c.values)[: c.nnz],
                     np.asarray(c_one.values)[: c_one.nnz], TOL_F64)
    report("dist spgemm f64", "host symbolic/xla", t_first, t_warm,
           n=G.shape[0], err_scipy=f"{e1:.2e}", err_one=f"{e2:.2e}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--chips", type=int, choices=(1, 4), default=1,
                    help="4: run only the distributed tier on 4 GPUs")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"chip_smoke: needs a GPU, JAX found "
              f"{devices[0].platform!r}", file=sys.stderr)
        return 2
    if len(devices) < args.chips:
        print(f"chip_smoke: --chips {args.chips} needs {args.chips} GPUs, "
              f"found {len(devices)}", file=sys.stderr)
        return 2

    from spalinalg.utils.compile_cache import enable_compile_cache
    from spalinalg.utils.metrics import gpu_card

    print(f"[smoke] compile cache: {enable_compile_cache()}", flush=True)
    print(gpu_card(), flush=True)            # nvidia-smi name, power.limit
    t0 = time.perf_counter()
    if args.chips == 4:
        run_dist(FULL, 4, seed=args.seed)
    else:
        run_single(FULL, seed=args.seed)
    print(f"[smoke] all phases passed in {time.perf_counter() - t0:.1f}s",
          flush=True)
    d = devices[0]
    # count: the devices the phases ran on, not all the host has
    print(json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind,
        "count": args.chips}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
