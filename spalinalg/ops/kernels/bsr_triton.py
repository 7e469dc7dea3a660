"""BSR SpMV as one Pallas kernel on the Triton route (GPU).

Each program owns a band of ``band`` consecutive block rows. For every
block row of its band it walks that row's blocks, loading ``indptr`` and
``indices`` itself, keeps the partial sum in registers, and writes its
slice of ``y`` once: no atomics, no cross-program reduction, and none of
the XLA path's intermediates — the gathered operand blocks and the
per-block products — ever reach device memory.

Per block a ``(br, bc)`` tile times a ``bc`` slice of ``x``, reduced
along the row on the CUDA cores (elementwise products: no TF32 is
involved). Values may be f32 or bf16; the accumulator is f32. Block
sizes must be powers of two of at least 16 (Triton's tile minimum).

SpMM has no kernel: a Triton SpMM of this shape (``pl.dot`` per block
into a register accumulator) ran 10x slower on an H100 than XLA's
batched GEMM plus block-row scatter (``PERF.md``). ``interpret=True`` runs
the same kernel on the CPU, which is how the tests reach it; the library
calls it only with ``interpret=False`` on a GPU.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

__all__ = ["triton_eligible", "bsr_matvec_call"]

def _pow2(v: int) -> bool:
    return v >= 16 and v & (v - 1) == 0


def triton_eligible(blocksize, dtype) -> bool:
    """Shapes and dtypes the kernel compiles for."""
    br, bc = blocksize
    return _pow2(br) and _pow2(bc) and jnp.dtype(dtype) in (
        jnp.dtype(jnp.float32), jnp.dtype(jnp.bfloat16))


def _band(br: int) -> int:
    # about 128 output rows per program: enough work per program to
    # cover the loads, and nbr/band programs to fill the SMs
    return max(1, 128 // br)


def _num_warps(br: int, bc: int) -> int:
    return 8 if br * bc >= 128 * 128 else 4


def _pad_rows(indptr, nbr: int, band: int):
    """Pad ``indptr`` with empty block rows up to a multiple of band."""
    nbr_p = -(-nbr // band) * band
    if nbr_p != nbr:
        indptr = jnp.concatenate(
            [indptr, jnp.full((nbr_p - nbr,), indptr[-1], indptr.dtype)])
    return indptr, nbr_p


def _spmv_kernel(indptr_ref, indices_ref, data_ref, x_ref, y_ref, *,
                 band, br, bc):
    b = pl.program_id(0)
    for r in range(band):                                 # static unroll
        row = b * band + r

        def body(k, acc):
            j = indices_ref[k]
            a = data_ref[k].astype(jnp.float32)           # (br, bc)
            xb = x_ref[pl.ds(j * bc, bc)].astype(jnp.float32)
            return acc + jnp.sum(a * xb[None, :], axis=1)

        acc = lax.fori_loop(indptr_ref[row], indptr_ref[row + 1], body,
                            jnp.zeros((br,), jnp.float32))
        y_ref[pl.ds(r * br, br)] = acc.astype(y_ref.dtype)


@partial(jax.jit, static_argnames=("nbr", "interpret"))
def bsr_matvec_call(indptr, indices, data, x, *, nbr, interpret=False):
    """``y = A @ x`` from BSR arrays (f32 result)."""
    br, bc = data.shape[1:]
    band = _band(br)
    indptr, nbr_p = _pad_rows(indptr, nbr, band)
    y = pl.pallas_call(
        partial(_spmv_kernel, band=band, br=br, bc=bc),
        grid=(nbr_p // band,),
        in_specs=[pl.no_block_spec] * 4,
        out_specs=pl.BlockSpec((band * br,), lambda b: (b,)),
        out_shape=jax.ShapeDtypeStruct((nbr_p * br,), jnp.float32),
        compiler_params=plgpu.CompilerParams(
            num_warps=_num_warps(br, bc), num_stages=2),
        backend="triton",
        interpret=interpret,
        name="bsr_spmv_triton",
    )(indptr, indices, data, x)
    return y[: nbr * br]
