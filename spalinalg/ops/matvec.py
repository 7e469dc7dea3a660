"""SpMV / SpMM: sparse × dense products (north-star N1/N2; absent from the
reference, whose docs only state the intent — `csr.rs:16-17`).

Formulation: with static structure, CSR SpMV is

    y = segment_sum(values * x[colind], row_ids, num_segments=nrows)

- structures known on the host (the common case) run the bucketed
  gather plan (``ops.reduction``): rows padded into power-of-two ELL
  buckets and reduced densely, no scatter; structures traced under a
  user jit run the ``segment_sum`` form above. Both are plain XLA and
  run on every backend;
- padding slots carry ``row_id == nrows`` (sentinel) and zero values, so
  ``segment_sum`` drops them for free;
- ``row_ids`` are recomputed in-jit from ``rowptr`` (one searchsorted
  over nse, fused).

CSC operands are handled by the mirror identity (CSC of A is CSR of Aᵀ with
the same arrays): ``A @ x`` scatters into rows — expressed as a segment_sum
over the minor axis is unsorted, so we instead gather x by the major
(column) ids and scatter-add by rowind. For performance-critical paths
convert to CSR once (structure is static; conversion is a one-time sort).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from ..convert.engine import major_ids_device
from ..errors import ShapeError

__all__ = ["matmul_dense", "csr_matvec", "csr_matmat", "csc_matvec", "csc_matmat"]


def acc_dtype(values_dtype, x_dtype):
    """Accumulation dtype: bf16 products accumulate in f32."""
    d = jnp.result_type(values_dtype, x_dtype)
    return jnp.dtype(jnp.float32) if d == jnp.bfloat16 else d


@partial(jax.jit, static_argnames=("nrows",))
def _csr_spmv_kernel(rowptr, colind, values, x, *, nrows):
    nse = colind.shape[0]
    rows = major_ids_device(rowptr, nse)  # padding -> nrows (dropped below)
    acc = acc_dtype(values.dtype, x.dtype)
    prod = values.astype(acc) * x[colind].astype(acc)
    y = jax.ops.segment_sum(
        prod, rows, num_segments=nrows, indices_are_sorted=True
    )
    return y


@partial(jax.jit, static_argnames=("nrows",))
def _csr_spmm_kernel(rowptr, colind, values, X, *, nrows):
    nse = colind.shape[0]
    rows = major_ids_device(rowptr, nse)
    acc = acc_dtype(values.dtype, X.dtype)
    prod = values.astype(acc)[:, None] * X[colind, :].astype(acc)
    return jax.ops.segment_sum(
        prod, rows, num_segments=nrows, indices_are_sorted=True
    )


@partial(jax.jit, static_argnames=("nrows",))
def _csc_spmv_kernel(colptr, rowind, values, x, *, nrows):
    nse = rowind.shape[0]
    cols = major_ids_device(colptr, nse)
    acc = acc_dtype(values.dtype, x.dtype)
    ncols = colptr.shape[0] - 1
    pad = cols >= ncols
    xg = jnp.where(pad, jnp.zeros((), acc), x[jnp.where(pad, 0, cols)].astype(acc))
    prod = values.astype(acc) * xg
    return jnp.zeros(nrows, dtype=acc).at[rowind].add(
        jnp.where(pad, jnp.zeros((), acc), prod)
    )


@partial(jax.jit, static_argnames=("nrows",))
def _csc_spmm_kernel(colptr, rowind, values, X, *, nrows):
    nse = rowind.shape[0]
    cols = major_ids_device(colptr, nse)
    acc = acc_dtype(values.dtype, X.dtype)
    ncols = colptr.shape[0] - 1
    pad = cols >= ncols
    Xg = X[jnp.where(pad, 0, cols), :].astype(acc)
    prod = jnp.where(pad[:, None], jnp.zeros((), acc),
                     values.astype(acc)[:, None] * Xg)
    return jnp.zeros((nrows, X.shape[1]), dtype=acc).at[rowind].add(prod)


# ----------------------------------------------------------------------
# Plan-based fast path: scatter-free bucketed row reduction (N1 design).
# Built once per (concrete) structure and cached; the numeric phase is a
# jitted composition of gathers + dense reductions.
# ----------------------------------------------------------------------

from ..utils.plancache import StructureCache

_ROW_PLAN_CACHE = StructureCache(maxsize=64)


def _row_plan(csr):
    """Segmented-reduction plan over CSR rows (host-built, cached).

    Bucket widths come from :func:`config.current_config` (and key the
    cache); caching contract (ref-holding, compile-time-eval, FIFO) is
    ``utils.plancache.StructureCache``.
    """
    from ..config import current_config

    cfg = current_config()
    key = (id(csr._ptr), csr.nse, csr.nrows,
           cfg.max_bucket_width, cfg.min_bucket_width)

    def build():
        from .reduction import build_segment_reduce_plan
        import numpy as np

        sizes = np.diff(np.asarray(csr._ptr, dtype=np.int64))
        return build_segment_reduce_plan(
            sizes, max_width=cfg.max_bucket_width,
            min_width=cfg.min_bucket_width)

    return _ROW_PLAN_CACHE.get(key, (csr._ptr,), build)


def _plan_spmv(plan, colind, values, x):
    from .reduction import segment_reduce

    acc = acc_dtype(values.dtype, x.dtype)
    prod = values.astype(acc) * x[colind].astype(acc)
    return segment_reduce(plan, prod)


def _plan_spmm(plan, colind, values, X):
    from .reduction import segment_reduce

    acc = acc_dtype(values.dtype, X.dtype)
    prod = values.astype(acc)[:, None] * X[colind, :].astype(acc)
    return segment_reduce(plan, prod)


_plan_spmv_jit = jax.jit(_plan_spmv)
_plan_spmm_jit = jax.jit(_plan_spmm)


def _structure_concrete(mat) -> bool:
    return not isinstance(mat._ptr, jax.core.Tracer)


def csr_path(csr) -> str:
    """The path ``csr @ x`` and ``csr @ X`` take: ``"bucket_plan"`` for a
    structure known on the host, ``"segment_sum"`` under a trace."""
    return "bucket_plan" if _structure_concrete(csr) else "segment_sum"


def csr_matvec(csr, x: jax.Array) -> jax.Array:
    """``y = A @ x`` for CSR A (row-segmented reduction, N1).

    Concrete structures run the bucketed gather plan; structures traced
    under a user jit run the ``segment_sum`` formulation.
    """
    from ..utils.metrics import instrument

    nnz = csr.nse
    itm = jnp.dtype(csr.values.dtype).itemsize
    return instrument("csr_spmv", lambda: _csr_matvec_impl(csr, x),
                      nnz=nnz, flops=2 * nnz, bytes=(itm * 2 + 4) * nnz)


def _csr_matvec_impl(csr, x):
    if csr_path(csr) == "bucket_plan":
        return _plan_spmv_jit(_row_plan(csr), csr.colind, csr.values, x)
    return _csr_spmv_kernel(csr.rowptr, csr.colind, csr.values, x,
                            nrows=csr.nrows)


def csr_matmat(csr, X: jax.Array) -> jax.Array:
    """``Y = A @ X`` for CSR A and dense tall-skinny X (N2)."""
    from ..utils.metrics import instrument

    nnz, k = csr.nse, int(X.shape[1])
    itm = jnp.dtype(csr.values.dtype).itemsize
    return instrument(
        "csr_spmm", lambda: _csr_matmat_impl(csr, X),
        nnz=nnz, flops=2 * nnz * k, bytes=(itm * (1 + 2 * k) + 4) * nnz)


def _csr_matmat_impl(csr, X):
    if csr_path(csr) == "bucket_plan":
        return _plan_spmm_jit(_row_plan(csr), csr.colind, csr.values, X)
    return _csr_spmm_kernel(csr.rowptr, csr.colind, csr.values, X,
                            nrows=csr.nrows)


# CSC fast path: one cached CSR mirror per structure, then the CSR row
# pipeline (the direct CSC formulation scatter-adds by rowind, whose
# summation order on a GPU changes from run to run).
_CSC_MIRROR_CACHE = StructureCache(maxsize=16)


def _csc_mirror(csc):
    key = (id(csc._ptr), id(csc._minor), id(csc._values),
           csc.nrows, csc.ncols)

    def build():
        from ..convert.conversions import csc_to_csr

        csr = csc_to_csr(csc)
        jax.block_until_ready(csr._values)
        return csr

    return _CSC_MIRROR_CACHE.get(
        key, (csc._ptr, csc._minor, csc._values), build)


def _csc_concrete(csc) -> bool:
    return not any(isinstance(a, jax.core.Tracer)
                   for a in (csc._ptr, csc._minor, csc._values))


def csc_matvec(csc, x: jax.Array) -> jax.Array:
    from ..utils.metrics import instrument

    def run():
        if _csc_concrete(csc):
            return csr_matvec(_csc_mirror(csc), x)
        return _csc_spmv_kernel(csc.colptr, csc.rowind, csc.values, x,
                                nrows=csc.nrows)

    nnz = csc.nse
    itm = jnp.dtype(csc.values.dtype).itemsize
    return instrument("csc_spmv", run, nnz=nnz, flops=2 * nnz,
                      bytes=(itm * 2 + 4) * nnz)


def csc_matmat(csc, X: jax.Array) -> jax.Array:
    from ..utils.metrics import instrument

    def run():
        if _csc_concrete(csc):
            return csr_matmat(_csc_mirror(csc), X)
        return _csc_spmm_kernel(csc.colptr, csc.rowind, csc.values, X,
                                nrows=csc.nrows)

    nnz, k = csc.nse, int(X.shape[1])
    itm = jnp.dtype(csc.values.dtype).itemsize
    return instrument("csc_spmm", run, nnz=nnz, flops=2 * nnz * k,
                      bytes=(itm * (1 + 2 * k) + 4) * nnz)


def matmul_dense(mat, other):
    """Dispatch ``A @ dense`` to SpMV (1-D rhs) or SpMM (2-D rhs)."""
    other = jnp.asarray(other) if not isinstance(other, jax.core.Tracer) else other
    if other.ndim not in (1, 2):
        raise ShapeError(f"dense rhs must be 1-D or 2-D, got ndim={other.ndim}")
    if other.shape[0] != mat.ncols:
        raise ShapeError(
            f"dimension mismatch: {mat.shape} @ {other.shape} "
            "(reference: csr/ops/mul.rs:8)"
        )
    from ..formats.compressed import CscMatrix

    if isinstance(mat, CscMatrix):
        return csc_matvec(mat, other) if other.ndim == 1 else csc_matmat(mat, other)
    return csr_matvec(mat, other) if other.ndim == 1 else csr_matmat(mat, other)
