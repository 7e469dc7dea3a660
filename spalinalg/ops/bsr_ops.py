"""BSR compute: batched dense-block products (north-star N4).

``Y[i] += B[i,j] @ X[j]`` over stored blocks. Two implementations:

- **XLA** (every backend, every dtype, SpMV and SpMM): gather the
  operand blocks by block-column index, one batched ``einsum``, one
  block-row scatter-add.
- **Triton kernel** (``kernels/bsr_triton.py``, GPU only, f32/bf16
  SpMV): one Pallas program per band of block rows, accumulating in
  registers, so the gathered blocks, the per-block products and the
  scatter never reach device memory.

:func:`bsr_path` picks between them from what it can observe (platform,
operation, dtype, block shape); nothing falls back after an error.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from ..convert.engine import major_ids_device
from .matvec import acc_dtype

__all__ = ["bsr_matvec", "bsr_matmat", "bsr_path"]

_HIGHEST = jax.lax.Precision.HIGHEST


def bsr_path(bsr, operand) -> str:
    """``"triton"`` or ``"xla"`` for ``bsr @ operand``.

    On a GPU the kernel serves SpMV for f32/bf16 values and power-of-two
    blocks of at least 16: on an H100 it streams the bench's 201 MB SpMV
    at 2.3x the XLA path's rate. SpMM runs XLA there too: its batched
    GEMM beat a Triton SpMM kernel by 10x (``PERF.md``). Everything else
    — other devices, f64, other block shapes — runs the XLA formulation.
    """
    from .kernels.bsr_triton import triton_eligible

    if jax.default_backend() != "gpu" or operand.ndim != 1:
        return "xla"
    if acc_dtype(bsr.dtype, operand.dtype) != jnp.float32:
        return "xla"
    return "triton" if triton_eligible(bsr.blocksize, bsr.dtype) else "xla"


@partial(jax.jit, static_argnames=("nbr",))
def _segment_rows(prod, indptr, *, nbr):
    # Deliberately not indices_are_sorted=True, although block rows are
    # sorted: on a GPU XLA then emits a scatter that holds a whole
    # (br, K) update window per thread, whose launch ran out of device
    # memory for SpMM at br=128, K=64 (f32 and f64, on an H100). The
    # unsorted scatter adds element by element and was faster as well.
    n_blocks = prod.shape[0]
    brow = major_ids_device(indptr, n_blocks)
    return jax.ops.segment_sum(prod, brow, num_segments=nbr)


def _xla_matvec(indptr, indices, data, x, *, nbr):
    bc = data.shape[2]
    xb = x.reshape(-1, bc)[indices]                          # (n_blocks, bc)
    prod = jnp.einsum("kij,kj->ki", data, xb,
                      preferred_element_type=acc_dtype(data.dtype, x.dtype),
                      precision=_HIGHEST)                    # (n_blocks, br)
    return _segment_rows(prod, indptr, nbr=nbr).reshape(-1)


def _xla_matmat(indptr, indices, data, X, *, nbr):
    bc, K = data.shape[2], X.shape[1]
    Xb = X.reshape(-1, bc, K)[indices]                       # (n_blocks, bc, K)
    prod = jnp.einsum("kij,kjl->kil", data, Xb,
                      preferred_element_type=acc_dtype(data.dtype, X.dtype),
                      precision=_HIGHEST)                    # (n_blocks, br, K)
    return _segment_rows(prod, indptr, nbr=nbr).reshape(-1, K)


@partial(jax.custom_vjp, nondiff_argnums=(4, 5))
def _triton_apply(indptr, indices, data, x, nbr, interpret):
    """``A @ x`` (SpMV) through the Triton kernel."""
    from .kernels.bsr_triton import bsr_matvec_call

    return bsr_matvec_call(indptr, indices, data, x, nbr=nbr,
                           interpret=interpret)


def _triton_apply_fwd(indptr, indices, data, x, nbr, interpret):
    y = _triton_apply(indptr, indices, data, x, nbr, interpret)
    return y, (indptr, indices, data, x)


def _triton_apply_bwd(nbr, interpret, res, g):
    # the transpose products in plain XLA: dA[k] = g[row_k] x[col_k]^T,
    # dx[col] = sum over blocks in that column of A[k]^T g[row_k]
    indptr, indices, data, x = res
    n_blocks, br, bc = data.shape
    brow = major_ids_device(indptr, n_blocks)   # padding blocks -> nbr
    gb = g.reshape(nbr, br).at[brow].get(mode="fill", fill_value=0)
    xb = x.reshape(-1, bc)[indices].astype(g.dtype)
    d_data = (gb[:, :, None] * xb[:, None, :]).astype(data.dtype)
    d_xb = jnp.einsum("kij,ki->kj", data.astype(g.dtype), gb,
                      precision=_HIGHEST)
    d_x = jax.ops.segment_sum(d_xb, indices, num_segments=x.shape[0] // bc)
    return None, None, d_data, d_x.reshape(x.shape).astype(x.dtype)


_triton_apply.defvjp(_triton_apply_fwd, _triton_apply_bwd)


def _apply(bsr, X, op, flops):
    from ..utils.metrics import instrument

    nbr = bsr.nrows // bsr.blocksize[0]
    if bsr_path(bsr, X) == "triton":
        def run():
            return _triton_apply(bsr.indptr, bsr.indices, bsr.data, X,
                                 nbr, False)
    else:
        xla = _xla_matvec if X.ndim == 1 else _xla_matmat

        def run():
            return xla(bsr.indptr, bsr.indices, bsr.data, X, nbr=nbr)
    return instrument(op, run, nnz=bsr.nnz, flops=flops,
                      bytes=jnp.dtype(bsr.dtype).itemsize * bsr.nnz)


def bsr_matvec(bsr, x: jax.Array) -> jax.Array:
    """``y = A @ x`` for BSR A (path from :func:`bsr_path`)."""
    return _apply(bsr, x, "bsr_spmv", 2 * bsr.nnz)


def bsr_matmat(bsr, X: jax.Array) -> jax.Array:
    """``Y = A @ X`` for BSR A and dense X (path from :func:`bsr_path`)."""
    return _apply(bsr, X, "bsr_spmm", 2 * bsr.nnz * int(X.shape[1]))
