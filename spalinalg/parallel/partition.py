"""Matrix partitioning for multi-chip execution (north-star N6).

The reference is single-address-space with zero parallelism (SURVEY.md §2.2);
this module is the scaling axis: **1-D row partitioning** of CSR
matrices over a ``jax.sharding.Mesh``, the sparse-linalg counterpart of data/
context parallelism.

Representation: :class:`DistCsr` stores the matrix as *stacked per-shard
blocks* — ``rowptr (P, rows_per_shard + 1)``, ``colind (P, nse_per_shard)``,
``values (P, nse_per_shard)`` — sharded along the leading axis. Inside
``shard_map`` each device sees exactly its local CSR block with **global**
column indices. Rows and nse are padded per shard (sentinel convention from
``convert/engine.py``) so every shard has identical static shapes — the SPMD
requirement.

Communication strategy is chosen per structure at partition time (host):
- ``"allgather"``: each shard all-gathers the dense operand vector — right
  for scattered column dependencies (power-law graphs).
- ``"halo"``: banded structures touch only neighbouring shards' entries;
  shards exchange fixed-width halo slabs with ``ppermute`` (left+right),
  overlapping with local compute (XLA async collectives).

Examples
--------
>>> import numpy as np
>>> from spalinalg import CsrMatrix
>>> from spalinalg.parallel import (make_row_mesh, partition_csr,
...                                     shard_vector, dist_spmv,
...                                     unshard_vector)
>>> A = CsrMatrix.eye(8)
>>> mesh = make_row_mesh()                       # all local devices
>>> dist = partition_csr(A, mesh)
>>> x = shard_vector(np.arange(8.0), dist)
>>> y = unshard_vector(dist_spmv(dist, x), dist)
>>> [float(v) for v in y]
[0.0, 1.0, 2.0, 3.0, 4.0, 5.0, 6.0, 7.0]
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..dtypes import INDEX_DTYPE

__all__ = ["DistCsr", "partition_csr", "make_row_mesh"]


def make_row_mesh(n_devices: Optional[int] = None,
                  axis: Optional[str] = None) -> Mesh:
    """1-D device mesh over all (or the first ``n_devices``) devices.

    The axis name defaults to :func:`config.current_config`'s
    ``partition_axis``."""
    if axis is None:
        from ..config import current_config

        axis = current_config().partition_axis
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.asarray(devs), (axis,))


@dataclass(frozen=True, eq=False)
class DistCsr:
    """Row-partitioned CSR over a 1-D mesh (stacked-block layout)."""

    nrows: int              # global logical rows (un-padded)
    ncols: int
    rows_per_shard: int     # padded local row count
    rowptr: jax.Array       # (P, rows_per_shard + 1) int32, sharded on axis 0
    colind: jax.Array       # (P, nse_per_shard) int32 — GLOBAL column ids
    values: jax.Array       # (P, nse_per_shard)
    brow: jax.Array         # (P, nse_per_shard) int32 local row id per
                            # entry (pad slots -> rows_per_shard); static
                            # per structure so the hot kernels never
                            # rebuild it (a per-call searchsorted sort
                            # cost 40x on the CPU-mesh probe)
    mesh: Mesh
    axis: str
    comm: str               # "allgather" | "halo"
    halo_width: int         # valid when comm == "halo": max |col - row_block|

    @property
    def n_shards(self) -> int:
        return self.rowptr.shape[0]

    @property
    def nse_per_shard(self) -> int:
        return self.colind.shape[1]

    # first-class operand surface: lets the solver/spectral tier
    # (cg/gmres/bicgstab/eigsh/expm_multiply/chebyshev) treat a DistCsr
    # like any other matrix. Shapes are the LOGICAL dims; the operand
    # vectors are the padded sharded ones from `shard_vector`.
    @property
    def shape(self):
        return (self.nrows, self.ncols)

    @property
    def dtype(self):
        return self.values.dtype

    @property
    def padded_dim(self) -> int:
        """Length of the padded sharded operand vectors."""
        return self.n_shards * self.rows_per_shard

    def __matmul__(self, other):
        from .spmv import dist_spmm, dist_spmv

        if getattr(other, "ndim", 1) == 2:
            return dist_spmm(self, other)
        return dist_spmv(self, other)

    def _structure_host(self):
        """Global (rowptr, colind) plus the map from each global entry
        to its flat padded shard slot — STRUCTURE only; values stay on
        the device mesh."""
        rp = np.asarray(self.rowptr, dtype=np.int64)
        ci = np.asarray(self.colind, dtype=np.int64)
        nse = self.nse_per_shard
        rows_l, cols_l, flat_l = [], [], []
        for p in range(self.n_shards):
            n_ent = int(rp[p, -1])
            local_rows = np.repeat(
                np.arange(self.rows_per_shard, dtype=np.int64),
                np.diff(rp[p]))
            grows = local_rows + p * self.rows_per_shard
            keep = grows < self.nrows
            rows_l.append(grows[keep])
            cols_l.append(ci[p, :n_ent][keep])
            flat_l.append((p * nse
                           + np.arange(n_ent, dtype=np.int64))[keep])
        rows = np.concatenate(rows_l)
        cols = np.concatenate(cols_l)
        flat = np.concatenate(flat_l)
        # shard-major + within-shard row-major + sorted columns ==
        # global row-major sorted order already
        ptr = np.zeros(self.nrows + 1, np.int64)
        np.add.at(ptr, rows + 1, 1)
        np.cumsum(ptr, out=ptr)
        return ptr, cols, flat

    def __mul__(self, other):
        """Sparse·sparse product with another ``DistCsr`` (setup-class).

        The SYMBOLIC phase runs on host over structure only (the output
        sparsity is data-dependent and cannot stay shard-static); the
        NUMERIC phase runs entirely ON DEVICE: operand values are
        gathered across the mesh by XLA collectives, the product values
        come from the single-device SpGEMM numeric path, and the result
        lands row-sharded — values never round-trip through the host.
        """
        if not isinstance(other, DistCsr):
            return NotImplemented
        if self.ncols != other.nrows:
            from ..errors import ShapeError

            raise ShapeError(
                f"matmul dim mismatch {self.shape} x {other.shape}")
        if other.mesh is not self.mesh or other.axis != self.axis:
            raise ValueError(
                "DistCsr * DistCsr needs both operands on the same mesh "
                "and axis (re-partition one operand first); a silent "
                "re-home onto the left operand's mesh is more likely a "
                "caller bug than an intent")
        import dataclasses

        import jax
        import jax.numpy as jnp

        from ..dtypes import INDEX_DTYPE
        from ..formats.compressed import CsrMatrix
        from ..ops import spgemm as sg

        # ---- symbolic (host, structure only) ------------------------
        ptrA, colA, flatA = self._structure_host()
        ptrB, colB, flatB = other._structure_host()
        nnz_a, nnz_b = int(ptrA[-1]), int(ptrB[-1])
        zeros = lambda n: np.zeros(n, np.dtype(self.dtype))
        As = CsrMatrix._from_parts(
            self.nrows, self.ncols,
            jnp.asarray(ptrA, dtype=INDEX_DTYPE),
            jnp.asarray(colA, dtype=INDEX_DTYPE),
            jnp.asarray(zeros(nnz_a)))
        Bs = CsrMatrix._from_parts(
            other.nrows, other.ncols,
            jnp.asarray(ptrB, dtype=INDEX_DTYPE),
            jnp.asarray(colB, dtype=INDEX_DTYPE),
            jnp.asarray(zeros(nnz_b)))
        plan = sg.spgemm_plan(As, Bs)

        # C shard layout (mirrors partition_csr's slicing)
        cptr = np.asarray(plan.rowptr, dtype=np.int64)
        nnz_c = int(cptr[-1])
        P_ = self.n_shards
        rows_per = self.rows_per_shard
        row_starts = np.minimum(np.arange(P_ + 1) * rows_per,
                                self.nrows)
        ent_starts = cptr[row_starts]
        c_nse = max(int((ent_starts[1:] - ent_starts[:-1]).max()), 1)
        cmap = np.full((P_, c_nse), nnz_c, np.int64)  # sentinel -> 0
        for p in range(P_):
            e0, e1 = int(ent_starts[p]), int(ent_starts[p + 1])
            cmap[p, : e1 - e0] = np.arange(e0, e1)

        # ---- numeric (device; XLA gathers ride the mesh) ------------
        gmap_a = jnp.asarray(flatA)
        gmap_b = jnp.asarray(flatB)
        cmap_d = jnp.asarray(cmap)
        a_idx_d = jnp.asarray(np.asarray(plan.a_idx, np.int64))
        b_idx_d = jnp.asarray(np.asarray(plan.b_idx, np.int64))
        gid_d = jnp.asarray(np.asarray(plan.gid, np.int64))
        spec = NamedSharding(self.mesh, P(self.axis))

        def _numeric(avv, bvv):
            ag = avv.reshape(-1)[gmap_a]
            bg = bvv.reshape(-1)[gmap_b]
            cv = sg._spgemm_numeric(a_idx_d, b_idx_d, gid_d,
                                    ag, bg, n_out=plan.n_out)
            return jnp.concatenate(
                [cv, jnp.zeros(1, cv.dtype)])[cmap_d]

        cvals = jax.jit(_numeric, out_shardings=spec)(self.values,
                                                       other.values)

        # structure via partition_csr on a values-free CSR; device
        # values swapped in with the mesh sharding
        cs = CsrMatrix._from_parts(
            self.nrows, other.ncols,
            jnp.asarray(cptr, dtype=INDEX_DTYPE),
            jnp.asarray(np.asarray(plan.colind, np.int64),
                        dtype=INDEX_DTYPE),
            jnp.asarray(zeros(nnz_c)))
        shell = partition_csr(cs, self.mesh, axis=self.axis)
        assert shell.nse_per_shard == c_nse
        return dataclasses.replace(shell, values=cvals)

    def to_csr(self):
        """Gather the shards back into one host-side CSR (setup-class
        op — O(nnz) host traffic, not a hot path)."""
        import jax.numpy as jnp

        from ..convert.engine import compress_host
        from ..dtypes import INDEX_DTYPE
        from ..formats.compressed import CsrMatrix

        rp = np.asarray(self.rowptr, dtype=np.int64)
        ci = np.asarray(self.colind, dtype=np.int64)
        vv = np.asarray(self.values)
        rows_l, cols_l, vals_l = [], [], []
        for p in range(self.n_shards):
            nse = int(rp[p, -1])
            local_rows = np.repeat(
                np.arange(self.rows_per_shard, dtype=np.int64),
                np.diff(rp[p]))
            grows = local_rows + p * self.rows_per_shard
            keep = grows < self.nrows          # drop pad rows
            rows_l.append(grows[keep])
            cols_l.append(ci[p, :nse][keep])
            vals_l.append(vv[p, :nse][keep])
        ptr, minor, values = compress_host(
            np.concatenate(rows_l), np.concatenate(cols_l),
            np.concatenate(vals_l), self.nrows,
            dedup=False, drop_zeros=False)
        return CsrMatrix._from_parts(
            self.nrows, self.ncols,
            jnp.asarray(ptr, dtype=INDEX_DTYPE),
            jnp.asarray(minor, dtype=INDEX_DTYPE),
            jnp.asarray(values))

    def transpose(self) -> "DistCsr":
        """Distributed transpose via the host path: gather, transpose,
        re-partition on the same mesh (the comm plan is re-chosen for
        the transposed structure)."""
        return partition_csr(self.to_csr().transpose(), self.mesh,
                             axis=self.axis)

    def tree_flatten(self):
        return (self.rowptr, self.colind, self.values, self.brow), (
            self.nrows, self.ncols, self.rows_per_shard, self.mesh,
            self.axis, self.comm, self.halo_width,
        )

    @classmethod
    def tree_unflatten(cls, aux, children):
        rowptr, colind, values, brow = children
        nrows, ncols, rps, mesh, axis, comm, halo = aux
        return cls(nrows, ncols, rps, rowptr, colind, values, brow, mesh,
                   axis, comm, halo)


jax.tree_util.register_pytree_node(
    DistCsr,
    lambda d: d.tree_flatten(),
    DistCsr.tree_unflatten,
)


def partition_csr(
    csr,
    mesh: Mesh,
    *,
    axis: Optional[str] = None,
    comm: Optional[str] = None,
) -> DistCsr:
    """Partition a (host-concrete) CSR matrix row-wise over ``mesh``.
    ``axis`` defaults to the mesh's first axis name.

    Host-side structure work, once per matrix: slice rows into P equal
    blocks (padded), equalise per-shard nse with sentinel padding, choose
    the communication strategy from the bandwidth of the structure unless
    forced via ``comm``.
    """
    if axis is None:
        axis = mesh.axis_names[0]
    P_ = int(np.prod([mesh.shape[a] for a in mesh.axis_names]))
    ptr = np.asarray(csr._ptr, dtype=np.int64)
    minor = np.asarray(csr._minor, dtype=np.int64)
    vals = np.asarray(csr._values)
    nnz = int(ptr[-1])
    minor, vals = minor[:nnz], vals[:nnz]

    nrows, ncols = csr.nrows, csr.ncols
    rows_per = -(-nrows // P_)

    # Per-shard row ranges and entry counts.
    row_starts = np.minimum(np.arange(P_ + 1) * rows_per, nrows)
    ent_starts = ptr[row_starts]
    local_nse = int((ent_starts[1:] - ent_starts[:-1]).max()) if P_ else 0
    local_nse = max(local_nse, 1)

    rp = np.zeros((P_, rows_per + 1), dtype=np.int64)
    ci = np.zeros((P_, local_nse), dtype=np.int64)
    vv = np.zeros((P_, local_nse), dtype=vals.dtype)
    br = np.full((P_, local_nse), rows_per, dtype=np.int64)
    halo = 0
    for p in range(P_):
        r0, r1 = int(row_starts[p]), int(row_starts[p + 1])
        e0, e1 = int(ent_starts[p]), int(ent_starts[p + 1])
        n_loc_rows = r1 - r0
        rp[p, : n_loc_rows + 1] = ptr[r0 : r1 + 1] - e0
        rp[p, n_loc_rows + 1 :] = e1 - e0  # padded rows are empty
        ci[p, : e1 - e0] = minor[e0:e1]
        vv[p, : e1 - e0] = vals[e0:e1]
        br[p, : e1 - e0] = np.repeat(
            np.arange(n_loc_rows, dtype=np.int64), np.diff(ptr[r0:r1 + 1]))
        if e1 > e0:
            lo = int(minor[e0:e1].min()) - r0
            hi = int(minor[e0:e1].max()) - (r1 - 1)
            halo = max(halo, -lo, hi, 0)

    if comm is None:
        # Banded enough that two halo slabs beat a full all-gather?
        comm = "halo" if halo <= rows_per // 2 else "allgather"

    spec_row = NamedSharding(mesh, P(axis))
    return DistCsr(
        nrows=nrows,
        ncols=ncols,
        rows_per_shard=rows_per,
        rowptr=jax.device_put(jnp.asarray(rp, dtype=INDEX_DTYPE), spec_row),
        colind=jax.device_put(jnp.asarray(ci, dtype=INDEX_DTYPE), spec_row),
        values=jax.device_put(jnp.asarray(vv), spec_row),
        brow=jax.device_put(jnp.asarray(br, dtype=INDEX_DTYPE), spec_row),
        mesh=mesh,
        axis=axis,
        comm=comm,
        halo_width=int(halo),
    )
