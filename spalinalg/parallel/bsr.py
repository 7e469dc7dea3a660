"""Distributed BSR: block-row partitioning with the batched block
product running inside ``shard_map``.

Every shard is padded to a uniform block count (dummy zero blocks) and a
uniform block-row count, so the per-shard shapes are identical — one
compile serves all devices. The operand vector is all-gathered across
the mesh (block structures with long-range block columns; a halo variant
rides :func:`spalinalg.parallel.spmv.dist_spmv`'s plan for banded
cases at the scalar level).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
from jax import shard_map

from ..dtypes import INDEX_DTYPE

__all__ = ["DistBsr", "partition_bsr", "dist_bsr_spmv"]


@dataclass(frozen=True, eq=False)
class DistBsr:
    """Block-row-partitioned BSR over a 1-D mesh (uniform shards)."""

    nrows: int                # global logical rows
    ncols: int
    br: int
    bc: int
    nbr_per_shard: int        # padded block-rows per shard
    nblk_per_shard: int       # padded blocks per shard
    rows: jax.Array           # (P, nblk) int32 LOCAL block-row ids
    cols: jax.Array           # (P, nblk) int32 GLOBAL block-col ids
    data: jax.Array           # (P, nblk, br, bc)
    mesh: object
    axis: str

    @property
    def n_shards(self) -> int:
        return int(np.prod([self.mesh.shape[a]
                            for a in self.mesh.axis_names]))


def partition_bsr(bsr, mesh, *, axis=None) -> DistBsr:
    """Partition a concrete BSR matrix block-row-wise over ``mesh``.

    Host structure work, once: contiguous block-row slabs, dummy zero
    blocks pad every shard to the global maximum so kernel shapes are
    uniform."""
    if axis is None:
        axis = mesh.axis_names[0]
    P_ = int(np.prod([mesh.shape[a] for a in mesh.axis_names]))
    br, bc = bsr.blocksize
    nbr = bsr.nrows // br
    ip = np.asarray(bsr.indptr, dtype=np.int64)
    ix = np.asarray(bsr.indices, dtype=np.int64)
    dat = np.asarray(bsr.data)

    bl_per = -(-nbr // P_)
    counts = [int(ip[min((p + 1) * bl_per, nbr)] - ip[min(p * bl_per, nbr)])
              for p in range(P_)]
    nblk = max(max(counts), 1)

    rows = np.zeros((P_, nblk), dtype=np.int32)
    cols = np.zeros((P_, nblk), dtype=np.int32)
    data = np.zeros((P_, nblk, br, bc), dtype=dat.dtype)
    brow_of = np.repeat(np.arange(nbr, dtype=np.int64), np.diff(ip))
    for p in range(P_):
        lo = int(ip[min(p * bl_per, nbr)])
        hi = int(ip[min((p + 1) * bl_per, nbr)])
        k = hi - lo
        rows[p, :k] = (brow_of[lo:hi] - p * bl_per).astype(np.int32)
        cols[p, :k] = ix[lo:hi].astype(np.int32)
        data[p, :k] = dat[lo:hi]

    spec = NamedSharding(mesh, P(axis))
    return DistBsr(
        nrows=bsr.nrows, ncols=bsr.ncols, br=br, bc=bc,
        nbr_per_shard=bl_per, nblk_per_shard=nblk,
        rows=jax.device_put(jnp.asarray(rows), spec),
        cols=jax.device_put(jnp.asarray(cols), spec),
        data=jax.device_put(jnp.asarray(data), spec),
        mesh=mesh, axis=axis,
    )


def shard_bsr_vector(x, d: DistBsr) -> jax.Array:
    """Pad a global operand vector to the shard grid, block-row-sharded."""
    n_pad = d.n_shards * d.nbr_per_shard * d.bc
    x = jnp.asarray(x)
    xp = jnp.pad(x, (0, max(0, n_pad - x.shape[0])))
    return jax.device_put(xp, NamedSharding(d.mesh, P(d.axis)))


def dist_bsr_spmv(d: DistBsr, x_sharded: jax.Array) -> jax.Array:
    """``y = A @ x``; A block-row-partitioned, x/y sharded alike.

    Per shard: all-gather x, then the batched block product and a
    block-row ``segment_sum`` (the single-device XLA formulation of
    :func:`spalinalg.ops.bsr_ops.bsr_matvec`)."""
    from ..ops.matvec import acc_dtype

    mesh, axis = d.mesh, d.axis
    nbr_l, bc = d.nbr_per_shard, d.bc
    acc = acc_dtype(d.data.dtype, x_sharded.dtype)

    def kernel(rows, cols, data, xl):
        rows, cols, data = rows[0], cols[0], data[0]
        xg = jax.lax.all_gather(xl, axis, tiled=True)
        xb = xg.reshape(-1, bc)[cols]                   # (nblk, bc)
        prod = jnp.einsum("kij,kj->ki", data, xb,
                          preferred_element_type=acc,
                          precision=jax.lax.Precision.HIGHEST)
        y = jax.ops.segment_sum(prod, rows, num_segments=nbr_l)
        return y.reshape(-1)

    fn = shard_map(
        kernel,
        mesh=mesh,
        in_specs=(P(axis, None), P(axis, None), P(axis, None, None, None),
                  P(axis)),
        out_specs=P(axis),
    )
    return fn(d.rows, d.cols, d.data, x_sharded)
