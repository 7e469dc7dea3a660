"""Headline benchmark: per-device SpMV throughput against the HBM roofline.

    python bench.py              # on a GPU; fails on any other platform
    python bench.py --rehearse   # tiny sizes on any platform (CI)

Prints ONE JSON line last:
    {"metric": ..., "value": N, "unit": "nnz/s", "vs_baseline": N,
     "device": {"platform", "kind", "count"}, "card": ..., ...}

Headline: block-banded BSR SpMV (f32). Secondary metrics (stderr and the
"secondary" field): bf16 and f64 BSR, DIA f32/f64, unstructured CSR
(f32 and f64), CSR SpMM, SpGEMM, supernodal Cholesky factor+solve, and a
large-copy bandwidth measured in the same run.

Method: each operation runs K times *inside one compiled program*
(``fori_loop``) for three loop lengths, each run ending in
``block_until_ready``; the per-iteration time is the median of the
pairwise slopes, which cancels the fixed dispatch cost. A measurement is
valid only if totals grow with K and the implied rate stays at or below
the device's datasheet roofline (``spalinalg.utils.metrics
.DEVICE_PEAKS``); an invalid one is reported as ``null``, never as a
number. Every metric carries a ``path`` tag naming the dispatch branch
that ran. ``--rehearse`` runs on any platform at tiny sizes and reports
no roofline shares: its numbers describe that platform only.

Baseline: the reference publishes no numbers (BASELINE.md); the target
is 70 % of the HBM roofline for the format's minimal traffic.
``vs_baseline`` = achieved / (0.70 * roofline).
"""

from __future__ import annotations

import argparse
import itertools
import json
import os
import sys
import time
from functools import partial

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np  # noqa: E402

_seed = itertools.count(1)


def _measure(body, x0, *, ks, reps=3, max_rate=None, tries=3,
             loop_fn=None, operand=None):
    """Per-iteration seconds of ``x -> normalize(body(x))``, or of
    ``body(operand, x)`` when an ``operand`` pytree is given: it then
    enters the compiled loop as an argument, not as constants (a BSR
    cell's blocks are hundreds of MB, and compile time grows with the
    constants a program carries).

    ``loop_fn(x, k)``, when given, replaces the default jitted
    ``fori_loop``. Returns ``(per_iter_seconds or None, diag)``; ``per``
    is None when the measurement stayed invalid after ``tries``
    attempts."""
    import jax
    import jax.numpy as jnp

    if loop_fn is None:
        @partial(jax.jit, static_argnames=("k",))
        def loop(x, op, k):
            def it(i, xc):
                y = body(xc) if op is None else body(op, xc)
                return (y / (jnp.max(jnp.abs(y)) + 1.0)).astype(xc.dtype)
            return jax.lax.fori_loop(0, k, it, x)

        def loop_fn(x, k):
            return loop(x, operand, k=k)

    def run(k):
        # a fresh scale per call: identical (program, inputs) pairs could
        # otherwise be served from a cache
        xs = x0 * x0.dtype.type(1 + next(_seed) * 1e-6)
        jax.block_until_ready(loop_fn(xs, k=k))

    diag = {}
    for attempt in range(tries):
        totals = {}
        for k in sorted(ks):
            run(k)  # compile this k
            best = None
            for _ in range(reps):
                t0 = time.perf_counter()
                run(k)
                dt = time.perf_counter() - t0
                best = dt if best is None else min(best, dt)
            totals[k] = best
        kl = sorted(ks)
        slopes = sorted(
            (totals[kl[j]] - totals[kl[i]]) / (kl[j] - kl[i])
            for i in range(len(kl)) for j in range(i + 1, len(kl)))
        per = slopes[len(slopes) // 2]
        # equal timer readings at tiny sizes shouldn't invalidate a
        # healthy kernel; the min-to-max spread must still be positive
        monotone = (
            all(totals[kl[i]] <= totals[kl[i + 1]] * (1 + 1e-6) + 1e-7
                for i in range(len(kl) - 1))
            and totals[kl[-1]] > totals[kl[0]])
        diag = {"totals_ms": {str(k): v * 1e3 for k, v in totals.items()},
                "attempt": attempt + 1, "monotone": monotone}
        if not monotone or per <= 0:
            continue
        if max_rate is not None and (1.0 / per) > max_rate * 1.02:
            diag["above_roofline"] = True
            continue
        return per, diag
    return None, diag


def _emit(name, *, nnz=None, per=None, diag=None, roof_rate=None,
          unit="nnz/s", path=None, frac_key=None):
    """Record one secondary metric (stderr log + dict entries)."""
    rec = {}
    if per is None:
        rec[name] = None
        rec[name + "_invalid"] = True
        print(f"[bench] {name} INVALID measurement {diag}", file=sys.stderr)
    else:
        rate = nnz / per
        rec[name] = rate
        if roof_rate:
            rec[frac_key or name + "_roofline_frac"] = rate / roof_rate
        pct = f" ({100*rate/roof_rate:.1f}% of roofline)" if roof_rate else ""
        print(f"[bench] {name} path={path} {per*1e3:.4f} ms/it -> "
              f"{rate/1e9:.3f} G{unit}{pct}", file=sys.stderr)
    if path is not None:
        rec[name + "_path"] = path
    return rec


def _make_bsr(nbr, dtype, band=1):
    """Block-banded BSR (bs=128), values generated on the device."""
    import jax
    import jax.numpy as jnp

    from spalinalg import BsrMatrix
    from spalinalg.dtypes import INDEX_DTYPE

    bs = 128
    n = nbr * bs
    indptr = [0]
    indices = []
    for i in range(nbr):
        cols = [j for j in range(i - band, i + band + 1) if 0 <= j < nbr]
        indices.extend(cols)
        indptr.append(len(indices))
    nblocks = len(indices)
    vdt = jnp.float64 if dtype == "f64" else jnp.float32
    data = jax.random.normal(jax.random.PRNGKey(0), (nblocks, bs, bs), vdt)
    bsr = BsrMatrix._from_parts(
        n, n, bs, bs,
        jnp.asarray(np.asarray(indptr), dtype=INDEX_DTYPE),
        jnp.asarray(np.asarray(indices), dtype=INDEX_DTYPE), data)
    if dtype == "bf16":
        bsr = bsr.astype(jnp.bfloat16)
    x0 = jax.random.normal(jax.random.PRNGKey(1), (n,), vdt)
    return bsr, x0, nblocks * bs * bs


def _bsr_path(bsr, x) -> str:
    from spalinalg.ops.bsr_ops import bsr_path

    return bsr_path(bsr, x)


def _make_csr(n, row_nnz, dtype=np.float32):
    import jax.numpy as jnp

    from spalinalg import CsrMatrix
    from spalinalg.dtypes import INDEX_DTYPE

    rng = np.random.default_rng(0)
    colind = np.sort(rng.integers(0, n, size=(n, row_nnz)), axis=1)
    rowptr = np.arange(n + 1, dtype=np.int64) * row_nnz
    values = rng.normal(size=n * row_nnz).astype(dtype)
    csr = CsrMatrix._from_parts(
        n, n,
        jnp.asarray(rowptr, dtype=INDEX_DTYPE),
        jnp.asarray(colind.reshape(-1), dtype=INDEX_DTYPE),
        jnp.asarray(values))
    x0 = jnp.asarray(rng.normal(size=n).astype(dtype))
    return csr, x0, n * row_nnz


def _csr_path(csr, x) -> str:
    from spalinalg.ops.matvec import csr_path

    return csr_path(csr)


def bench_copy(full, secondary):
    """Large-copy bandwidth in this run: what the card's memory reaches
    for a plain streaming pass, the practical ceiling beside the
    datasheet."""
    import jax
    import jax.numpy as jnp

    n = (1 << 28) if full else (1 << 16)       # 1 GiB of f32 when full
    x0 = jax.random.normal(jax.random.PRNGKey(7), (n,), jnp.float32)
    per, diag = _measure(lambda v: v * 1.0001, x0,
                         ks=(8, 40, 72) if full else (1, 2, 3),
                         reps=3 if full else 1)
    # the loop body reads x and writes y; the normalisation reads y
    # again for its max and once more to scale it, writing x: at least
    # one read and one write of 4 B per element are counted
    secondary.update(_emit("copy_bytes_per_s", nnz=8.0 * n, per=per,
                           diag=diag, unit="B/s", path="xla"))


def bench_chol(full, secondary):
    """Supernodal Cholesky factor + solve on a 2-D Laplacian
    (BASELINE config[3])."""
    import jax
    import jax.numpy as jnp

    from spalinalg import CsrMatrix
    from spalinalg.dtypes import INDEX_DTYPE
    from spalinalg.linalg import supernodal as sn
    from spalinalg.linalg.cholesky import cholesky, cholesky_solve

    k = 96 if full else 32
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

    t0 = time.perf_counter()
    fac = cholesky(csr, method="supernodal")
    jax.block_until_ready(list(fac.snf.panels.values()))
    t_total = time.perf_counter() - t0
    flops = 0
    for buckets in fac.snf.plan.levels:
        for bk in buckets:
            B, ns, mu = bk.sids.size, bk.nsp, bk.mup
            flops += B * (ns ** 3 / 3 + ns * ns * mu + ns * mu * mu)

    plan = fac.snf.plan

    @partial(jax.jit, static_argnames=("k",))
    def refac_loop(v0, k):
        def it(i, c):
            panels = sn._factor_all(plan, v0 * (1.0 + c * 1e-12))
            last = panels[max(panels)]
            return c + last[0, 0, 0] * 1e-20
        return jax.lax.fori_loop(0, k, it, v0.dtype.type(0))

    reps = 3 if full else 1
    per_f, _ = _measure(None, csr.values, ks=(2, 8, 14) if full
                        else (1, 2, 3), reps=reps,
                        loop_fn=lambda x, k: refac_loop(x, k=k))

    b = jnp.asarray(np.random.default_rng(1).normal(size=n)
                    .astype(np.float32))
    jax.block_until_ready(cholesky_solve(fac, b))

    @partial(jax.jit, static_argnames=("k",))
    def solve_loop(bb, k):
        def it(i, bc):
            xs = sn._solve_all(plan, fac.snf.panels, bc)
            return bc * (1.0 + jnp.sum(xs) * 1e-20)
        return jax.lax.fori_loop(0, k, it, bb)

    per_s, _ = _measure(None, b, ks=(2, 10, 18) if full else (1, 2, 3),
                        reps=reps, loop_fn=lambda x, k: solve_loop(x, k=k))
    t_num = per_f if per_f is not None else float("nan")
    t_solve = per_s if per_s is not None else float("nan")
    secondary["chol_laplacian_n"] = n
    secondary["chol_laplacian_factor_ms"] = t_total * 1e3
    secondary["chol_laplacian_refactor_ms"] = t_num * 1e3
    secondary["chol_laplacian_gflops"] = flops / t_num / 1e9
    secondary["chol_laplacian_solve_ms"] = t_solve * 1e3
    print(f"[bench] chol_laplacian n={n} factor {t_total*1e3:.0f} ms "
          f"(numeric re-factor {t_num*1e3:.3f} ms = "
          f"{flops/t_num/1e9:.1f} GFLOP/s), solve {t_solve*1e3:.3f} ms",
          file=sys.stderr)


def bench_spgemm(full, secondary, hbm):
    """SpGEMM numeric phase on a power-law matrix (BASELINE config[2])."""
    import jax
    import jax.numpy as jnp

    from spalinalg import CsrMatrix
    from spalinalg.dtypes import INDEX_DTYPE
    from spalinalg.ops import spgemm as sg

    n = 1 << 15 if full else 1 << 10
    rng = np.random.default_rng(1)
    deg = np.minimum(rng.zipf(1.8, size=n), 512)
    rowptr = np.concatenate([[0], np.cumsum(deg)]).astype(np.int64)
    nnz = int(rowptr[-1])
    colind = rng.integers(0, n, size=nnz)
    order = np.repeat(np.arange(n), deg)
    srt = np.lexsort((colind, order))
    colind = colind[srt]
    values = rng.normal(size=nnz).astype(np.float32)
    a = CsrMatrix._from_parts(
        n, n,
        jnp.asarray(rowptr, dtype=INDEX_DTYPE),
        jnp.asarray(colind, dtype=INDEX_DTYPE),
        jnp.asarray(values))
    t0 = time.perf_counter()
    plan = sg.spgemm_plan(a, a)
    t_sym = time.perf_counter() - t0
    n_terms = int(plan.a_idx.shape[0])

    av = a.values
    t0 = time.perf_counter()
    jax.block_until_ready(sg.spgemm_apply(plan, av, av))
    t_warm = time.perf_counter() - t0
    secondary["spgemm_symbolic_s"] = t_sym
    secondary["spgemm_warm_s"] = t_warm

    @partial(jax.jit, static_argnames=("k",))
    def xlaloop(x, k):
        def it(i, xc):
            y = sg._spgemm_numeric(plan.a_idx, plan.b_idx, plan.gid,
                                   xc, av, n_out=plan.n_out)
            return xc * (1.0 + jnp.sum(y) * 1e-12)
        return jax.lax.fori_loop(0, k, it, x)

    # per term: two 4 B value gathers and three 4 B indices, plus the
    # 4 B output amortised to at most one per term
    roof = hbm / 24.0 if hbm else None
    per, diag = _measure(None, av, ks=(4, 20, 36) if full else (1, 2, 3),
                         reps=3 if full else 1,
                         max_rate=(roof / n_terms) if roof else None,
                         loop_fn=xlaloop)
    secondary.update(_emit("spgemm_powerlaw_terms_per_s", nnz=n_terms,
                           per=per, diag=diag, roof_rate=roof,
                           unit="terms/s", path="xla_gather_segsum",
                           frac_key="spgemm_roofline_frac"))


_RESULT = {"value": None, "vs_baseline": None, "secondary": {}}


def _emit_json(device, card, peaks) -> None:
    """Print the one-line JSON contract (last line of stdout)."""
    rec = {
        "metric": "bsr_banded_spmv_f32_nnz_per_s",
        "value": _RESULT["value"],
        "unit": "nnz/s",
        "vs_baseline": _RESULT["vs_baseline"],
        "device": device,
        "card": card,
        "peaks_source": peaks["source"] if peaks else None,
        "secondary": _RESULT["secondary"],
    }
    print(json.dumps(rec), flush=True)


def _section(name: str, fn) -> None:
    """Run one secondary; a failure is recorded under ``<name>_error``
    and the remaining sections still run."""
    t0 = time.monotonic()
    try:
        fn()
    except Exception as e:
        print(f"[bench] {name} failed: {e!r}", file=sys.stderr)
        _RESULT["secondary"][name + "_error"] = repr(e)[:200]
    _RESULT["secondary"][name + "_s"] = time.monotonic() - t0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="spalinalg benchmark")
    ap.add_argument("--rehearse", action="store_true",
                    help="tiny sizes on any platform, no roofline shares")
    ap.add_argument("--sections", default="",
                    help="comma-separated subset of secondary sections")
    args = ap.parse_args(argv)

    import jax

    from spalinalg.utils.compile_cache import enable_compile_cache
    from spalinalg.utils.metrics import device_peaks, gpu_card

    d0 = jax.devices()[0]
    # count: the devices the bench ran on (one), not all the host has
    device = {"platform": d0.platform, "kind": d0.device_kind, "count": 1}
    full = not args.rehearse
    if full and d0.platform != "gpu":
        print(f"bench: needs a GPU, found {d0.platform!r} (use --rehearse "
              "for a tiny run on any platform)", file=sys.stderr)
        return 2
    enable_compile_cache()
    peaks = device_peaks(d0.device_kind) if full else None
    card = gpu_card() if full else None
    hbm = peaks["hbm_gbps"] * 1e9 if peaks else None
    secondary = _RESULT["secondary"]
    print(f"[bench] device {device} card {card}", file=sys.stderr)

    def rate_cap(bytes_per_nnz, nnz):
        return hbm / bytes_per_nnz / nnz if hbm else None

    ks_big = (64, 320, 576) if full else (1, 2, 3)
    ks_mid = (16, 80, 144) if full else (1, 2, 3)
    reps = 4 if full else 1
    # the rehearsal's headline must come back a number even on a loaded
    # CPU: loops long enough, and the best of several runs, for the
    # totals to rise with the loop length above the timer's noise
    ks_head, reps_head = (ks_big, reps) if full else ((2, 16, 64), 3)

    # ---- headline: f32 banded BSR ---------------------------------
    bsr_roof = hbm / 4.0 if hbm else None  # minimal traffic: 4 B / nnz
    bsr, x0, nnz_b = _make_bsr(1024 if full else 8, "f32")
    path = _bsr_path(bsr, x0)
    per_b, diag_b = _measure(lambda A, v: A @ v, x0, operand=bsr,
                             ks=ks_head, reps=reps_head,
                             max_rate=rate_cap(4.0, nnz_b))
    secondary["bsr_f32_path"] = path
    secondary["bsr_f32_diag"] = diag_b
    if per_b is None:
        print(f"[bench] HEADLINE INVALID {diag_b}", file=sys.stderr)
    else:
        rate = nnz_b / per_b
        _RESULT["value"] = rate
        if bsr_roof:
            _RESULT["vs_baseline"] = rate / (0.70 * bsr_roof)
            secondary["bsr_f32_roofline_frac"] = rate / bsr_roof
        print(f"[bench] bsr_banded path={path} nnz={nnz_b} "
              f"{per_b*1e3:.4f} ms/spmv -> {rate/1e9:.2f} Gnnz/s",
              file=sys.stderr)
    del bsr, x0

    def sec_bsr(dtype, nbr, bytes_per, band=1):
        hb, hx, hnnz = _make_bsr(nbr if full else 8, dtype, band)
        # bf16 iterations are ~2x shorter: longer loops keep kernel time
        # well above the timer's resolution
        ks = (128, 640, 1152) if full and dtype == "bf16" else ks_mid
        per, diag = _measure(lambda A, v: A @ v, hx, operand=hb, ks=ks,
                             reps=reps, max_rate=rate_cap(bytes_per, hnnz))
        secondary.update(_emit(
            f"bsr_banded_spmv_{dtype}_nnz_per_s", nnz=hnnz, per=per,
            diag=diag, roof_rate=hbm / bytes_per if hbm else None,
            frac_key=f"bsr_{dtype}_roofline_frac", path=_bsr_path(hb, hx)))

    def sec_dia(dtype):
        import jax.numpy as jnp

        from spalinalg import DiaMatrix

        vdt = jnp.float64 if dtype == "f64" else jnp.float32
        itm = jnp.dtype(vdt).itemsize
        n = (1 << 22 if dtype == "f32" else 1 << 21) if full else 1 << 14
        offs = [-300, -130, -1, 0, 1, 7, 129, 250, 333]
        D = len(offs)
        ddata = jax.random.normal(jax.random.PRNGKey(0), (D, n), vdt)
        dia = DiaMatrix(n, n, offs, ddata)
        dx = jax.random.normal(jax.random.PRNGKey(1), (n,), vdt)
        # one pass: the diagonals, plus x read and y written once,
        # amortised over the D diagonals
        bytes_per = itm * (1.0 + 2.0 / D)
        per, diag = _measure(lambda v: dia @ v, dx,
                             ks=(32, 160, 288) if full else (1, 2, 3),
                             reps=reps, max_rate=rate_cap(bytes_per,
                                                          dia.nnz))
        name = "dia_banded_spmv" if dtype == "f32" else "dia_f64_spmv"
        secondary.update(_emit(
            f"{name}_nnz_per_s", nnz=dia.nnz, per=per, diag=diag,
            roof_rate=hbm / bytes_per if hbm else None,
            frac_key=("dia_roofline_frac" if dtype == "f32"
                      else "dia_f64_roofline_frac"),
            path="xla_fused"))

    def sec_csr(dtype):
        vdt = np.float64 if dtype == "f64" else np.float32
        itm = np.dtype(vdt).itemsize
        rows = (1 << 16 if dtype == "f32" else 1 << 15) if full else 1 << 10
        csr, cx, cnnz = _make_csr(rows, 32, vdt)
        bytes_per = 2.0 * itm + 4.0   # value + x element + index
        ks = ks_big if dtype == "f32" else ((8, 40, 72) if full
                                            else (1, 2, 3))
        per, diag = _measure(lambda v: csr @ v, cx, ks=ks, reps=reps,
                             max_rate=rate_cap(bytes_per, cnnz))
        name = ("csr_random_spmv_nnz_per_s" if dtype == "f32"
                else "csr_f64_spmv_nnz_per_s")
        secondary.update(_emit(
            name, nnz=cnnz, per=per, diag=diag,
            roof_rate=hbm / bytes_per if hbm else None,
            frac_key=("csr_roofline_frac" if dtype == "f32"
                      else "csr_f64_roofline_frac"),
            path=_csr_path(csr, cx)))

    def sec_csr_spmm():
        import jax.numpy as jnp

        csr, _, mnnz = _make_csr(1 << 14 if full else 1 << 10, 32)
        K = 64
        rng = np.random.default_rng(0)
        X0 = jnp.asarray(rng.normal(size=(csr.nrows, K)).astype(np.float32))
        flops = 2.0 * mnnz * K
        # value + index per nnz, one X row read and one Y row written
        roof = hbm / (8.0 + 4.0 * K) * 2.0 * K if hbm else None
        per, diag = _measure(lambda X: csr @ X, X0, ks=ks_mid, reps=reps,
                             max_rate=roof / flops if roof else None)
        secondary.update(_emit(
            "csr_spmm_k64_flops_per_s", nnz=flops, per=per, diag=diag,
            roof_rate=roof, unit="FLOP/s", frac_key="csr_spmm_roofline_frac",
            path=_csr_path(csr, X0)))

    sections = {
        "copy": lambda: bench_copy(full, secondary),
        "csr_random": lambda: sec_csr("f32"),
        "spgemm": lambda: bench_spgemm(full, secondary, hbm),
        "csr_f64": lambda: sec_csr("f64"),
        "csr_spmm": sec_csr_spmm,
        "bsr_bf16": lambda: sec_bsr("bf16", 2048, 2.0),
        "bsr_f64": lambda: sec_bsr("f64", 512, 8.0, band=2),
        "chol": lambda: bench_chol(full, secondary),
        "dia": lambda: sec_dia("f32"),
        "dia_f64": lambda: sec_dia("f64"),
    }
    only = {s.strip() for s in args.sections.split(",") if s.strip()}
    t0 = time.monotonic()
    for name, fn in sections.items():
        if not only or name in only:
            _section(name, fn)
    secondary["bench_wall_s"] = time.monotonic() - t0
    _emit_json(device, card, peaks)
    return 0


if __name__ == "__main__":
    sys.exit(main())
