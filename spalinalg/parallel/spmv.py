"""Distributed SpMV/SpMM over a row-partitioned mesh (north-star N7).

The communication backend: XLA collectives inside ``shard_map`` over a
``jax.sharding.Mesh``, which XLA hands to NCCL on GPUs (the reference has no
communication layer at all, `Cargo.toml:13-14`).

Two data paths, chosen per structure at partition time:

- **all-gather**: operand vector gathered to every shard (scattered column
  dependencies). One ``all_gather``, then pure-local SpMV.
- **halo**: banded structures exchange fixed-width slabs with left/right
  neighbours via two ``ppermute``s, which XLA runs asynchronously and
  overlaps with the local-interior compute.

Both end with ``y`` sharded by rows — the same partition as the matrix, so
iterative solvers chain SpMVs without resharding. Reductions (dot products)
are ``psum`` over the mesh axis.
"""

from __future__ import annotations

from functools import partial

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
from jax import shard_map

from .partition import DistCsr

__all__ = ["shard_vector", "unshard_vector", "dist_spmv", "dist_spmm",
           "dist_dot"]


def _padded_len(n: int, p: int) -> int:
    return p * (-(-n // p))


def shard_vector(x, dist: DistCsr, *, by: str = "cols") -> jax.Array:
    """Pad a global vector to the shard grid and place it row-sharded.

    ``by="cols"`` shards the SpMV *operand* (length ncols); ``by="rows"``
    the result layout (length nrows).
    """
    n = dist.ncols if by == "cols" else dist.nrows
    pad = _padded_len(n, dist.n_shards) - n
    x = jnp.asarray(x)
    xp = jnp.pad(x, (0, pad))
    return jax.device_put(xp, NamedSharding(dist.mesh, P(dist.axis)))


def unshard_vector(y: jax.Array, dist: DistCsr) -> jax.Array:
    """Strip row padding from a sharded result (returns a global array)."""
    return y[: dist.nrows]


def _local_spmv(rows, colind, values, x_local_cols, nrows_local):
    """Per-device CSR×dense on the local block; colind already localised.

    ``rows`` is the partition-time per-entry local row id (DistCsr.brow)
    — rebuilding it per call from rowptr costs a full sort inside every
    SpMV (measured 40x on the CPU-mesh probe).
    """
    safe_col = jnp.clip(colind, 0, x_local_cols.shape[0] - 1)
    prod = values * x_local_cols[safe_col]
    prod = jnp.where(colind == safe_col, prod, 0)
    return jax.ops.segment_sum(
        prod, rows, num_segments=nrows_local, indices_are_sorted=True
    )


def dist_spmv(dist: DistCsr, x_sharded: jax.Array) -> jax.Array:
    """``y = A @ x`` with A row-partitioned and x/y row-sharded.

    ``x_sharded`` comes from :func:`shard_vector` (padded global length);
    the result is sharded the same way (padded nrows; use
    :func:`unshard_vector` for the logical vector).
    """
    mesh, axis = dist.mesh, dist.axis
    rows_per = dist.rows_per_shard
    cols_per = _padded_len(dist.ncols, dist.n_shards) // dist.n_shards
    halo = dist.halo_width

    if dist.comm == "allgather":

        def kernel(br, ci, vv, xl):
            br, ci, vv = br[0], ci[0], vv[0]
            xg = jax.lax.all_gather(xl, axis, tiled=True)  # (ncols_padded,)
            y = _local_spmv(br, ci, vv, xg, rows_per)
            return y

    else:  # halo exchange via neighbour ppermute

        def kernel(br, ci, vv, xl):
            br, ci, vv = br[0], ci[0], vv[0]
            p = jax.lax.axis_index(axis)
            n = jax.lax.axis_size(axis)
            h = min(halo, cols_per) if halo > 0 else 0
            if h > 0:
                # slab from left neighbour (their top rows feed our lows)
                left = jax.lax.ppermute(
                    xl[-h:], axis,
                    [(i, i + 1) for i in range(n - 1)],
                )
                right = jax.lax.ppermute(
                    xl[:h], axis,
                    [(i + 1, i) for i in range(n - 1)],
                )
                x_ext = jnp.concatenate([left, xl, right])
            else:
                x_ext = xl
            # Localise global colind: offset of x_ext[0] is p*cols_per - h
            local_ci = ci - (p * cols_per - h)
            y = _local_spmv(br, local_ci, vv, x_ext, rows_per)
            return y

    fn = shard_map(
        kernel,
        mesh=mesh,
        in_specs=(P(axis, None), P(axis, None), P(axis, None), P(axis)),
        out_specs=P(axis),
    )
    return fn(dist.brow, dist.colind, dist.values, x_sharded)


def _local_spmm(rows, colind, values, X_local, nrows_local):
    safe_col = jnp.clip(colind, 0, X_local.shape[0] - 1)
    prod = values[:, None] * X_local[safe_col, :]
    prod = jnp.where((colind == safe_col)[:, None], prod, 0)
    return jax.ops.segment_sum(
        prod, rows, num_segments=nrows_local, indices_are_sorted=True
    )


def dist_spmm(dist: DistCsr, X_sharded: jax.Array) -> jax.Array:
    """``Y = A @ X`` with A row-partitioned and X/Y row-sharded ``(n, K)``.

    Dense tall-skinny right-hand sides (BASELINE config[1]/[4]). Banded
    structures exchange halo row-slabs of X with their neighbours (two
    ``ppermute``s, K columns wide, overlapped by XLA with the local
    compute); scattered structures all-gather the operand rows.
    """
    mesh, axis = dist.mesh, dist.axis
    rows_per = dist.rows_per_shard
    cols_per = _padded_len(dist.ncols, dist.n_shards) // dist.n_shards
    halo = dist.halo_width

    if dist.comm == "allgather":

        def kernel(rp, ci, vv, Xl):
            rp, ci, vv = rp[0], ci[0], vv[0]
            Xg = jax.lax.all_gather(Xl, axis, tiled=True)  # (ncols_pad, K)
            return _local_spmm(rp, ci, vv, Xg, rows_per)

    else:  # halo slabs, same plan as dist_spmv

        def kernel(rp, ci, vv, Xl):
            rp, ci, vv = rp[0], ci[0], vv[0]
            p = jax.lax.axis_index(axis)
            n = jax.lax.axis_size(axis)
            h = min(halo, cols_per) if halo > 0 else 0
            if h > 0:
                left = jax.lax.ppermute(
                    Xl[-h:], axis, [(i, i + 1) for i in range(n - 1)])
                right = jax.lax.ppermute(
                    Xl[:h], axis, [(i + 1, i) for i in range(n - 1)])
                X_ext = jnp.concatenate([left, Xl, right], axis=0)
            else:
                X_ext = Xl
            local_ci = ci - (p * cols_per - h)
            return _local_spmm(rp, local_ci, vv, X_ext, rows_per)

    fn = shard_map(
        kernel,
        mesh=mesh,
        in_specs=(P(axis, None), P(axis, None), P(axis, None), P(axis, None)),
        out_specs=P(axis, None),
    )
    return fn(dist.brow, dist.colind, dist.values, X_sharded)


def shard_matrix_rows(X, dist: DistCsr, *, by: str = "cols") -> jax.Array:
    """Pad + row-shard a dense operand matrix ``(n, K)``."""
    n = dist.ncols if by == "cols" else dist.nrows
    pad = _padded_len(n, dist.n_shards) - n
    X = jnp.asarray(X)
    Xp = jnp.pad(X, ((0, pad), (0, 0)))
    return jax.device_put(Xp, NamedSharding(dist.mesh, P(dist.axis, None)))


def dist_dot(a: jax.Array, b: jax.Array, dist: DistCsr) -> jax.Array:
    """Global dot product of two row-sharded vectors (``psum``)."""
    mesh, axis = dist.mesh, dist.axis

    def kernel(u, v):
        return jax.lax.psum(
            jnp.vdot(u, v, precision=jax.lax.Precision.HIGHEST), axis)

    return shard_map(
        kernel, mesh=mesh, in_specs=(P(axis), P(axis)), out_specs=P()
    )(a, b)
