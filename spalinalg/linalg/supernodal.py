"""Supernodal multifrontal Cholesky: the general-sparsity device numeric
phase (north-star N5; the reference documents intent only, `csr.rs:16-17`).

Device mapping: the assembly tree is processed level by level (leaves first);
within a level, independent frontal matrices are padded to power-of-2 size
classes and factored as one batched dense partial Cholesky per class —
batched dense matmuls — with host-precomputed index plans for A-entry
assembly and child extend-add (gather + one scatter per bucket pair).
Frontal matrices use the lower-triangular convention throughout (the
strict upper triangle of a front/update is never read).

Front layout per size class ``(nsp, mup)``: rows/cols ``[0, nsp)`` hold the
(padded) supernode columns, rows ``[nsp, nsp+mup)`` the (padded) below-row
block — padding never collides with real entries. The symbolic phase
(`linalg.symbolic`) and this numeric plan are built once per structure;
repeated factorizations with new values reuse them.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import Dict, List, Tuple

import numpy as np

import jax
import jax.numpy as jnp

from .symbolic import SupernodalSymbolic

_HIGHEST = jax.lax.Precision.HIGHEST

__all__ = ["SupernodalPlan", "build_supernodal_plan", "supernodal_factor",
           "supernodal_factor_sharded", "supernodal_solve",
           "SupernodalFactor"]


def _pad_class(x: int) -> int:
    if x <= 0:
        return 0
    p = 8
    while p < x:
        p *= 2
    return p


@dataclass(eq=False)
class _Bucket:
    """One (level, size-class) batch of supernodes."""

    sids: np.ndarray          # (B,) supernode ids
    nsp: int                  # padded #columns
    mup: int                  # padded #below-rows
    # A assembly: F.ravel()[a_dst] += A.values[a_src]
    a_dst: np.ndarray
    a_src: np.ndarray
    pad_diag: np.ndarray      # identity slots for padded diagonal columns
    # extend-add, grouped by source bucket: ((lvl, bkt), src, dst) flats
    ext: List[Tuple[Tuple[int, int], np.ndarray, np.ndarray]]
    # solve-phase index matrices (pad -> n sentinel)
    colg: np.ndarray          # (B, nsp) global col ids
    rowg: np.ndarray          # (B, mup) global below-row ids

    @property
    def mp(self) -> int:
        return self.nsp + self.mup


@dataclass(eq=False)
class SupernodalPlan:
    n: int
    sym: SupernodalSymbolic
    levels: List[List[_Bucket]]   # per level, list of buckets
    l_nnz: int


@dataclass(eq=False)
class SupernodalFactor:
    plan: SupernodalPlan
    panels: Dict[Tuple[int, int], jax.Array]  # (level,bucket) -> (B,mp,nsp)
    dtype: object


def build_supernodal_plan(sym: SupernodalSymbolic, ptr: np.ndarray,
                          ind: np.ndarray) -> SupernodalPlan:
    """Host index plans for the batched numeric phase.

    ``ptr``/``ind`` is the full symmetric (postordered) CSR structure the
    symbolic phase ran on; value indices in the plan refer to entries of
    that matrix's value array (lower triangle used).
    """
    n = sym.n
    nsn = sym.nsn
    sp, rp, ri = sym.snode_ptr, sym.rows_ptr, sym.rows_idx
    snode_of = sym.snode_of_col()
    width = np.diff(sp)
    msz = np.diff(rp)

    # bucket assignment: class = (pad(ns), pad(m - ns)) per level
    slot: Dict[int, Tuple[int, int, int]] = {}
    shape_levels: List[List[Tuple[int, int, np.ndarray]]] = []
    for l, sids in enumerate(sym.levels):
        classes: Dict[Tuple[int, int], List[int]] = {}
        for s in sids:
            key = (_pad_class(int(width[s])),
                   _pad_class(int(msz[s] - width[s])))
            classes.setdefault(key, []).append(int(s))
        lvl = []
        for (nsp, mup), ss in sorted(classes.items()):
            bi = len(lvl)
            for b, s in enumerate(ss):
                slot[s] = (l, bi, b)
            lvl.append((nsp, mup, np.asarray(ss, dtype=np.int64)))
        shape_levels.append(lvl)

    # A lower-triangle entries grouped by owning snode (by column)
    ptr = np.asarray(ptr, dtype=np.int64)
    ind = np.asarray(ind, dtype=np.int64)
    rows_of_entry = np.repeat(np.arange(n, dtype=np.int64), np.diff(ptr))
    lower = rows_of_entry >= ind
    e_i = rows_of_entry[lower]
    e_j = ind[lower]
    e_v = np.flatnonzero(lower)   # value index into A.values
    e_s = snode_of[e_j]
    order = np.argsort(e_s, kind="stable")
    e_i, e_j, e_v, e_s = e_i[order], e_j[order], e_v[order], e_s[order]
    sbounds = np.searchsorted(e_s, np.arange(nsn + 1))

    def local_row(pos, ns_s, nsp):
        """struct position -> front row (cols at [0,ns); below at nsp+)."""
        return np.where(pos < ns_s, pos, pos - ns_s + nsp)

    out_levels: List[List[_Bucket]] = []
    children_of: Dict[int, List[int]] = {}
    for c in range(nsn):
        p = int(sym.sn_parent[c])
        if p >= 0:
            children_of.setdefault(p, []).append(c)

    for l, lvl in enumerate(shape_levels):
        buckets: List[_Bucket] = []
        for nsp, mup, ss in lvl:
            B = ss.size
            mp = nsp + mup
            a_dst, a_src, pad_diag = [], [], []
            colg = np.full((B, max(nsp, 1)), n, dtype=np.int64)
            rowg = np.full((B, max(mup, 1)), n, dtype=np.int64)
            ext: Dict[Tuple[int, int], Tuple[list, list]] = {}
            for b, s in enumerate(ss):
                c0, c1 = int(sp[s]), int(sp[s + 1])
                ns_s = c1 - c0
                struct = ri[rp[s]:rp[s + 1]]
                m_s = struct.size
                colg[b, :ns_s] = np.arange(c0, c1)
                below = struct[ns_s:]
                rowg[b, : m_s - ns_s] = below
                # A entries of this snode's columns
                lo, hi = sbounds[s], sbounds[s + 1]
                ii, jj, vv = e_i[lo:hi], e_j[lo:hi], e_v[lo:hi]
                r_loc = local_row(np.searchsorted(struct, ii), ns_s, nsp)
                c_loc = jj - c0
                a_dst.append((b * mp + r_loc) * mp + c_loc)
                a_src.append(vv)
                pd = np.arange(ns_s, nsp, dtype=np.int64)
                pad_diag.append((b * mp + pd) * mp + pd)
                # extend-add from children
                for c in children_of.get(int(s), ()):
                    lc, bc, slot_c = slot[c]
                    cb = out_levels[lc][bc]
                    cs = ri[rp[c]:rp[c + 1]]
                    rows_c = cs[int(width[c]):]
                    mu_c = rows_c.size
                    if mu_c == 0:
                        continue
                    pos = local_row(np.searchsorted(struct, rows_c),
                                    ns_s, nsp)
                    mup_c = cb.mup
                    li, lj = np.tril_indices(mu_c)
                    src = (slot_c * mup_c + li) * mup_c + lj
                    dst = (b * mp + pos[li]) * mp + pos[lj]
                    sl, dl = ext.setdefault((lc, bc), ([], []))
                    sl.append(src)
                    dl.append(dst)
            ext_list = [
                (key, np.concatenate(sl).astype(np.int64),
                 np.concatenate(dl).astype(np.int64))
                for key, (sl, dl) in ext.items()
            ]
            buckets.append(_Bucket(
                sids=ss, nsp=nsp, mup=mup,
                a_dst=(np.concatenate(a_dst) if a_dst
                       else np.zeros(0, np.int64)),
                a_src=(np.concatenate(a_src) if a_src
                       else np.zeros(0, np.int64)),
                pad_diag=(np.concatenate(pad_diag) if pad_diag
                          else np.zeros(0, np.int64)),
                ext=ext_list, colg=colg, rowg=rowg,
            ))
        out_levels.append(buckets)
    return SupernodalPlan(n=n, sym=sym, levels=out_levels,
                          l_nnz=sym.l_nnz)


# ----------------------------------------------------------------------
# device kernels (jitted per size class)
# ----------------------------------------------------------------------


@partial(jax.jit, static_argnames=("size",))
def _assemble(avals, a_dst, a_src, pad_diag, *, size):
    F = jnp.zeros((size,), avals.dtype)
    F = F.at[a_dst].add(avals[a_src])
    F = F.at[pad_diag].add(jnp.ones((), avals.dtype))
    return F


@jax.jit
def _extend(F, U, src, dst):
    return F.at[dst].add(U.reshape(-1)[src])


@partial(jax.jit, static_argnames=("B", "nsp", "mup"))
def _factor_bucket(F, *, B, nsp, mup):
    mp = nsp + mup
    F = F.reshape(B, mp, mp)
    F11 = F[:, :nsp, :nsp]
    F11 = jnp.tril(F11) + jnp.swapaxes(jnp.tril(F11, -1), 1, 2)
    L11 = jnp.linalg.cholesky(F11)
    if mup:
        F21 = F[:, nsp:, :nsp]
        # L21 = F21 L11^{-T}  (batched right-side triangular solve)
        L21 = jax.lax.linalg.triangular_solve(
            L11, F21, left_side=False, lower=True, transpose_a=True)
        U = F[:, nsp:, nsp:] - jnp.matmul(L21, jnp.swapaxes(L21, 1, 2),
                                          precision=_HIGHEST)
    else:
        L21 = jnp.zeros((B, 0, nsp), F.dtype)
        U = jnp.zeros((B, 0, 0), F.dtype)
    panel = jnp.concatenate([jnp.tril(L11), L21], axis=1)
    return panel, U


def _plan_index_arrays(plan):
    """Deterministic enumeration of every index table the numeric
    phase reads (assembly scatters + extend-add flats, bucket order).
    Serves the Cholesky and the LU plans, whose buckets share these
    fields."""
    for buckets in plan.levels:
        for bk in buckets:
            yield bk.a_dst
            yield bk.a_src
            yield bk.pad_diag
            for (_lb, src, dst) in bk.ext:
                yield src
                yield dst


def _plan_tables(plan):
    """One flat device copy of ALL the plan's index tables, cached on
    the plan.

    Threaded through jit as an ARGUMENT rather than captured constants:
    a constant-embedded program carries its tables in every compile and
    cache entry. A single concatenated array keeps it to ONE host-to-
    device transfer. The kernel slices it back with static offsets
    (free under XLA)."""
    flat = getattr(plan, "_dev_tables", None)
    if flat is None:
        parts = [np.asarray(a, np.int64).ravel()
                 for a in _plan_index_arrays(plan)]
        flat = jnp.asarray(np.concatenate(parts) if parts
                           else np.zeros(0, np.int64))
        plan._dev_tables = flat
    return flat


def _table_views(plan, tables):
    """``cv(a)`` for the numeric phase: with ``tables`` (the flat array
    of :func:`_plan_tables`, a jit argument) the static slice that holds
    the plan array ``a``, found by identity, so callers may ask in any
    order; without, ``a`` embedded as a constant (the sharded factor
    path — GSPMD partitions constants)."""
    if tables is None:
        return jnp.asarray
    span, off = {}, 0
    for a in _plan_index_arrays(plan):
        span[id(a)] = (off, off + a.size)
        off += a.size

    def cv(a):
        lo, hi = span[id(a)]                # KeyError: not a plan table
        return tables[lo:hi].reshape(np.shape(a))  # static slice
    return cv


def _factor_all(plan: SupernodalPlan, values: jax.Array, tables=None):
    """The whole numeric phase as one traced computation (all buckets).

    ``tables``: see :func:`_table_views`."""
    cv = _table_views(plan, tables)
    panels: Dict[Tuple[int, int], jax.Array] = {}
    updates: Dict[Tuple[int, int], jax.Array] = {}
    for l, buckets in enumerate(plan.levels):
        for bi, bk in enumerate(buckets):
            B, nsp, mup = bk.sids.size, bk.nsp, bk.mup
            mp = nsp + mup
            F = _assemble(values, cv(bk.a_dst),
                          cv(bk.a_src), cv(bk.pad_diag),
                          size=B * mp * mp)
            for (lc, bc), src, dst in bk.ext:
                F = _extend(F, updates[(lc, bc)], cv(src), cv(dst))
            panel, U = _factor_bucket(F, B=B, nsp=nsp, mup=mup)
            panels[(l, bi)] = panel
            updates[(l, bi)] = U
    return panels


def supernodal_factor(plan: SupernodalPlan, values: jax.Array
                      ) -> SupernodalFactor:
    """Numeric factorization: batched partial Cholesky per level bucket.

    ``values`` is the (postordered) matrix's CSR value array; only
    lower-triangle entries are read (via the plan's ``a_src``). The
    whole level sweep is compiled as ONE program per plan (cached on
    the plan): per-bucket dispatch cost — 100s of launches on a
    remote-attached device — dominated the numeric phase otherwise."""
    values = jnp.asarray(values)
    fn = getattr(plan, "_factor_jit", None)
    if fn is None:
        fn = jax.jit(lambda v, t: _factor_all(plan, v, tables=t))
        plan._factor_jit = fn
    panels = fn(values, _plan_tables(plan))
    return SupernodalFactor(plan=plan, panels=panels, dtype=values.dtype)


def supernodal_factor_sharded(plan: SupernodalPlan, values: jax.Array,
                              mesh, axis: str = None
                              ) -> SupernodalFactor:
    """Distributed numeric factorization over a device mesh.

    Each (level, size-class) batch of independent frontal matrices is
    sharded on its batch dimension — the assembly tree's level-
    parallelism maps directly onto the mesh, and XLA/GSPMD inserts the
    collectives that carry child Schur updates across shards for the
    extend-add. Batches smaller than the mesh
    (the tree's top levels) stay replicated: near the root the DAG is
    sequential and replication is the communication-optimal layout.

    Solve parity: the returned factor's panels carry their shardings;
    :func:`supernodal_solve` works unchanged (GSPMD partitions the
    per-bucket triangular solves the same way).
    """
    from jax.sharding import NamedSharding, PartitionSpec

    axis = axis or mesh.axis_names[0]
    nd = int(mesh.shape[axis])
    values = jnp.asarray(values)

    def _constrain(arr, B):
        spec = (PartitionSpec(axis, None, None) if B % nd == 0
                else PartitionSpec(None, None, None))
        return jax.lax.with_sharding_constraint(
            arr, NamedSharding(mesh, spec))

    def _fall(vals_):
        panels: Dict[Tuple[int, int], jax.Array] = {}
        updates: Dict[Tuple[int, int], jax.Array] = {}
        for l, buckets in enumerate(plan.levels):
            for bi, bk in enumerate(buckets):
                B, nsp, mup = bk.sids.size, bk.nsp, bk.mup
                mp = nsp + mup
                F = _assemble(vals_, jnp.asarray(bk.a_dst),
                              jnp.asarray(bk.a_src),
                              jnp.asarray(bk.pad_diag), size=B * mp * mp)
                for (lc, bc), src, dst in bk.ext:
                    F = _extend(F, updates[(lc, bc)], jnp.asarray(src),
                                jnp.asarray(dst))
                Fb = _constrain(F.reshape(B, mp, mp), B)
                panel, U = _factor_bucket(Fb.reshape(-1), B=B, nsp=nsp,
                                          mup=mup)
                panels[(l, bi)] = _constrain(panel, B)
                updates[(l, bi)] = U
        return panels

    cache = getattr(plan, "_factor_sharded_jit", None)
    if cache is None:
        cache = {}
        plan._factor_sharded_jit = cache
    key = (mesh, axis)
    fn = cache.get(key)
    if fn is None:
        fn = jax.jit(_fall)
        cache[key] = fn
    panels = fn(values)
    return SupernodalFactor(plan=plan, panels=panels, dtype=values.dtype)


@partial(jax.jit, static_argnames=("nsp",))
def _fwd_bucket(w, panel, colg, rowg, *, nsp):
    b1 = w[colg]                                  # (B, nsp)
    L11 = panel[:, :nsp, :]
    y1 = jax.lax.linalg.triangular_solve(
        L11, b1[..., None], left_side=True, lower=True)[..., 0]
    w = w.at[colg].set(y1)
    L21 = panel[:, nsp:, :]
    if L21.shape[1]:
        upd = jnp.einsum("bij,bj->bi", L21, y1, precision=_HIGHEST)
        w = w.at[rowg].add(-upd)
    return w


@partial(jax.jit, static_argnames=("nsp",))
def _bwd_bucket(w, panel, colg, rowg, *, nsp):
    L11 = panel[:, :nsp, :]
    L21 = panel[:, nsp:, :]
    rhs = w[colg]
    if L21.shape[1]:
        g = w[rowg]                               # (B, mup)
        rhs = rhs - jnp.einsum("bij,bi->bj", L21, g, precision=_HIGHEST)
    x1 = jax.lax.linalg.triangular_solve(
        L11, rhs[..., None], left_side=True, lower=True,
        transpose_a=True)[..., 0]
    return w.at[colg].set(x1)


def _solve_all(plan: SupernodalPlan, panels, b, perm=None, iperm=None):
    n = plan.n
    dtype = next(iter(panels.values())).dtype if panels else b.dtype
    if perm is not None:
        b = jnp.asarray(b)[perm]
    w = jnp.zeros(n + 1, dtype).at[:n].set(jnp.asarray(b, dtype))
    for l, buckets in enumerate(plan.levels):
        for bi, bk in enumerate(buckets):
            w = _fwd_bucket(w, panels[(l, bi)],
                            jnp.asarray(bk.colg), jnp.asarray(bk.rowg),
                            nsp=bk.nsp)
    for l in range(len(plan.levels) - 1, -1, -1):
        for bi, bk in enumerate(plan.levels[l]):
            w = _bwd_bucket(w, panels[(l, bi)],
                            jnp.asarray(bk.colg), jnp.asarray(bk.rowg),
                            nsp=bk.nsp)
    x = w[:n]
    if iperm is not None:
        x = x[iperm]
    return x


def supernodal_solve(fac: SupernodalFactor, b: jax.Array,
                     perm=None) -> jax.Array:
    """Solve ``A x = b`` (postordered coordinates, or original ones
    when the factor's fill-reducing ``perm`` is passed).

    Everything — permutation, both triangular sweeps, inverse
    permutation — compiles as ONE program per plan (cached): on a
    remote-attached device the eager ``b[perm]``/``x[iperm]`` steps
    each paid a full ~40 ms dispatch (the r3 bench's 187 ms "solve"
    was three dispatches around a 24 ms device program)."""
    plan = fac.plan
    key = "_solve_jit" if perm is None else "_solve_jit_p"
    fn = getattr(plan, key, None)
    if fn is None:
        fn = jax.jit(partial(_solve_all, plan))
        setattr(plan, key, fn)
    if perm is None:
        return fn(fac.panels, b)
    perm = np.asarray(perm)
    iperm = np.empty(perm.size, dtype=np.int64)
    iperm[perm] = np.arange(perm.size)
    return fn(fac.panels, b, jnp.asarray(perm), jnp.asarray(iperm))
