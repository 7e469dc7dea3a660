"""SpGEMM: sparse × sparse product (reference C9/C12: `src/csr/ops/mul.rs`,
`src/csc/ops/mul.rs`; north-star N3).

Reference semantics (behavioral spec): ``C = A·B`` where the output stores an
entry (i, j) iff some k has A[i,k] and B[k,j] stored — even when the sum
cancels to exact zero (the Gustavson stamp-set keeps it). Output indices are
sorted and unique. Shape assert ``a.ncols == b.nrows`` (`csr/ops/mul.rs:8`).

Design — **symbolic/numeric split** (the SpGEMM analogue of the
supernodal plan in SURVEY.md §7 phase 5):

1. *Symbolic phase* (host, once per structure pair): expand every product
   term (i,k)·(k,j) into flat gather indices, sort-and-unique the output
   coordinates, and record the segment id of each term. This is pure
   structure work — NumPy today, native C++ via ``spalinalg.native``
   for large plans.
2. *Numeric phase* (device, jit-able, differentiable): two gathers, one
   multiply, one sorted ``segment_sum``:

       C.values = segment_sum(A.values[ai] * B.values[bi], gid)

   Bandwidth-bound streaming: no hash tables, no dynamic allocation, no
   transpose sandwich (`csr/ops/mul.rs:10,57`).

Repeated products with the same structures (iterative algorithms, graph
powers) reuse the cached plan and pay only the numeric phase.

Examples
--------
>>> from spalinalg import CsrMatrix
>>> a = CsrMatrix(2, 2, [0, 2, 3], [0, 1, 1], [1.0, 2.0, 3.0])
>>> c = a * a                      # operator* is SpGEMM (csr/ops/mul.rs)
>>> c.shape, c.nnz
((2, 2), 3)
>>> [float(v) for v in c.values]   # [[1,8],[0,9]]
[1.0, 8.0, 9.0]
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import numpy as np

import jax
import jax.numpy as jnp

from ..dtypes import INDEX_DTYPE
from ..errors import ShapeError

__all__ = ["spgemm", "SpgemmPlan", "spgemm_plan", "spgemm_apply"]


@dataclass(frozen=True)
class SpgemmPlan:
    """Precomputed symbolic structure of ``C = A·B`` for fixed sparsity.

    ``a_idx``/``b_idx`` index the operand value arrays per product term;
    ``gid`` maps each term to its output slot; ``rowptr``/``colind`` are the
    output CSR structure (exact nnz, reference-semantic: cancellation zeros
    kept).
    """

    nrows: int
    ncols: int
    a_idx: jax.Array   # (n_terms,) int32 into A.values
    b_idx: jax.Array   # (n_terms,) int32 into B.values
    gid: jax.Array     # (n_terms,) int32 output slot per term (sorted)
    rowptr: jax.Array  # (nrows+1,) int32
    colind: jax.Array  # (nnz_out,) int32
    n_out: int         # static output nnz

    def num_flops(self) -> int:
        """2 × product-term count (multiply + add)."""
        return 2 * int(self.a_idx.shape[0])


def _csr_host_arrays(mat):
    ptr = np.asarray(mat._ptr, dtype=np.int64)
    minor = np.asarray(mat._minor, dtype=np.int64)
    nnz = int(ptr[-1])
    return ptr, minor[:nnz]


def spgemm_plan(a, b) -> SpgemmPlan:
    """Symbolic phase on host (structure only; values never touched).

    ``a``/``b`` are CSR matrices (CSC pairs are planned on their mirrored
    structure by the caller).
    """
    if a.ncols != b.nrows:
        raise ShapeError(
            f"dimension mismatch: {a.shape} x {b.shape} "
            "(reference: csr/ops/mul.rs:8)"
        )
    aptr, acol = _csr_host_arrays(a)
    bptr, bcol = _csr_host_arrays(b)
    nnz_a = acol.size

    if nnz_a > 4096:
        from ..native import lib as _native

        if _native.available():
            a_idx, b_idx, gid, rowptr, colind = _native.spgemm_symbolic(
                aptr, acol, a.nrows, bptr, bcol, b.ncols
            )
            return SpgemmPlan(
                nrows=a.nrows,
                ncols=b.ncols,
                a_idx=jnp.asarray(a_idx, dtype=INDEX_DTYPE),
                b_idx=jnp.asarray(b_idx, dtype=INDEX_DTYPE),
                gid=jnp.asarray(gid, dtype=INDEX_DTYPE),
                rowptr=jnp.asarray(rowptr, dtype=INDEX_DTYPE),
                colind=jnp.asarray(colind, dtype=INDEX_DTYPE),
                n_out=int(colind.size),
            )

    arow = np.repeat(np.arange(a.nrows, dtype=np.int64), np.diff(aptr))
    # Expansion: term t couples A-entry j with the t-th entry of B-row k_j.
    k = acol                                     # (nnz_a,) inner index per A entry
    counts = (bptr[k + 1] - bptr[k])             # products per A entry
    total = int(counts.sum())
    a_idx = np.repeat(np.arange(nnz_a, dtype=np.int64), counts)
    starts = np.repeat(bptr[k], counts)
    local = np.arange(total, dtype=np.int64) - np.repeat(
        np.cumsum(counts) - counts, counts
    )
    b_idx = starts + local
    out_row = arow[a_idx]
    out_col = bcol[b_idx]

    # Sort terms by output coordinate; group into unique output slots.
    order = np.lexsort((out_col, out_row))
    out_row, out_col = out_row[order], out_col[order]
    a_idx, b_idx = a_idx[order], b_idx[order]
    if total:
        is_new = np.empty(total, dtype=bool)
        is_new[0] = True
        is_new[1:] = (out_row[1:] != out_row[:-1]) | (out_col[1:] != out_col[:-1])
        gid = np.cumsum(is_new) - 1
        n_out = int(gid[-1]) + 1
        colind = out_col[is_new]
        rows_u = out_row[is_new]
    else:
        gid = np.zeros(0, dtype=np.int64)
        n_out = 0
        colind = np.zeros(0, dtype=np.int64)
        rows_u = np.zeros(0, dtype=np.int64)

    rowptr = np.zeros(a.nrows + 1, dtype=np.int64)
    np.add.at(rowptr, rows_u + 1, 1)
    np.cumsum(rowptr, out=rowptr)

    return SpgemmPlan(
        nrows=a.nrows,
        ncols=b.ncols,
        a_idx=jnp.asarray(a_idx, dtype=INDEX_DTYPE),
        b_idx=jnp.asarray(b_idx, dtype=INDEX_DTYPE),
        gid=jnp.asarray(gid, dtype=INDEX_DTYPE),
        rowptr=jnp.asarray(rowptr, dtype=INDEX_DTYPE),
        colind=jnp.asarray(colind, dtype=INDEX_DTYPE),
        n_out=n_out,
    )


@partial(jax.jit, static_argnames=("n_out",))
def _spgemm_numeric(a_idx, b_idx, gid, a_values, b_values, *, n_out):
    prod = a_values[a_idx] * b_values[b_idx]
    return jax.ops.segment_sum(
        prod, gid, num_segments=max(n_out, 1), indices_are_sorted=True
    )[:n_out]


def spgemm_apply(plan: SpgemmPlan, a_values: jax.Array, b_values: jax.Array):
    """Numeric phase: returns the output CSR value array. Device-resident.

    Two value gathers, one multiply and one sorted ``segment_sum`` over
    the plan's product terms — jit- and grad-compatible, any dtype.
    """
    return _spgemm_numeric(
        plan.a_idx, plan.b_idx, plan.gid, a_values, b_values, n_out=plan.n_out
    )


# Plan cache keyed by operand structure identity (structures are immutable).
from ..utils.plancache import StructureCache

_PLAN_CACHE = StructureCache(maxsize=64)


def _cached_plan(a, b) -> SpgemmPlan:
    key = (id(a._ptr), id(a._minor), id(b._ptr), id(b._minor),
           a.shape, b.shape, type(a).__name__)
    return _PLAN_CACHE.get(
        key, (a._ptr, a._minor, b._ptr, b._minor),
        lambda: spgemm_plan(a, b))


def spgemm(a, b):
    """``C = A·B`` with reference Gustavson semantics (`csr/ops/mul.rs:5-58`).

    CSR×CSR → CSR. CSC×CSC → CSC via the mirror identity: the CSC arrays of
    A·B equal the CSR arrays of (BᵀAᵀ) computed on the mirrored structures —
    the same trick the reference uses (`csc/ops/mul.rs:10-12`), but executed
    symbolically in the plan instead of via runtime transposes.
    """
    from ..formats.compressed import CscMatrix, CsrMatrix
    from ..utils.metrics import instrument

    if isinstance(a, CscMatrix):
        # CSC storage of A is the CSR storage of Aᵀ. (A·B)ᵀ = Bᵀ·Aᵀ, so the
        # CSC of A·B is the CSR-product of (B_mirror · A_mirror).
        bm = CsrMatrix._from_parts(b.ncols, b.nrows, b._ptr, b._minor, b._values)
        am = CsrMatrix._from_parts(a.ncols, a.nrows, a._ptr, a._minor, a._values)
        if a.ncols != b.nrows:
            raise ShapeError(
                f"dimension mismatch: {a.shape} x {b.shape} "
                "(reference: csc/ops/mul.rs:8)"
            )
        plan = _cached_plan(bm, am)
        values = instrument(
            "spgemm", lambda: spgemm_apply(plan, b._values, a._values),
            nnz=plan.n_out, flops=plan.num_flops())
        return CscMatrix._from_parts(
            a.nrows, b.ncols, plan.rowptr, plan.colind, values
        )

    plan = _cached_plan(a, b)
    values = instrument(
        "spgemm", lambda: spgemm_apply(plan, a._values, b._values),
        nnz=plan.n_out, flops=plan.num_flops())
    return CsrMatrix._from_parts(a.nrows, b.ncols, plan.rowptr, plan.colind, values)
