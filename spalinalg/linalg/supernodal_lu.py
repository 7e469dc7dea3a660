"""Supernodal multifrontal sparse LU for general (unsymmetric) matrices
(north-star N5; the reference names lu as intended scope only,
`csr.rs:16-17`, `csc.rs:16-17`).

Design — the unsymmetric sibling of `supernodal.py`:

- **Structure**: symbolic analysis runs on the symmetrized structure
  ``struct(A + Aᵀ)`` (values untouched), so the Cholesky machinery —
  AMD ordering, elimination tree, postorder, fundamental supernodes with
  relaxed amalgamation, level-scheduled assembly tree — is reused
  verbatim (`linalg/symbolic.py`). Entries of A are scattered onto the
  symmetrized pattern (missing slots hold explicit zeros).
- **Fronts**: full ``mp × mp`` frontal matrices (rows AND columns both
  indexed by the supernode's row structure), not the lower triangle:
  the front carries the L panel ``[L11; L21]`` and the U panel
  ``[U11, U12]`` simultaneously.
- **Pivoting**: restricted partial pivoting — batched dense LU with row
  pivoting *inside* each diagonal block ``F11`` (``jax.lax.linalg.lu``
  per size class), the SuperLU-DIST-style static stance: the global row
  permutation is block-diagonal over supernodes, fixed by
  the elimination order. Optionally a diagonal perturbation
  (``perturb``) bounds pivot growth on near-singular blocks; pair with
  iterative refinement for ill-conditioned systems.
- **Schur update**: ``F22 - L21 @ U12`` — a full (not triangular)
  ``mu × mu`` extend-add into ancestor fronts.

Everything numeric is batched per (level, size-class) exactly as in the
Cholesky plan, so the device sees a handful of dense batched kernels per
level rather than per-column scalar work.
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

__all__ = ["SupernodalLuPlan", "build_supernodal_lu_plan",
           "supernodal_lu_factor", "supernodal_lu_solve",
           "SupernodalLuFactor", "symmetrize_structure",
           "map_values_to_structure"]


def symmetrize_structure(ptr: np.ndarray, ind: np.ndarray, n: int
                         ) -> Tuple[np.ndarray, np.ndarray]:
    """CSR structure of ``A + Aᵀ`` (host; values untouched)."""
    ptr = np.asarray(ptr, dtype=np.int64)
    ind = np.asarray(ind, dtype=np.int64)
    nnz = int(ptr[-1])
    ind = ind[:nnz]
    rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(ptr))
    keys = np.unique(np.concatenate([rows * n + ind, ind * n + rows]))
    s_rows = keys // n
    s_cols = keys % n
    s_ptr = np.zeros(n + 1, dtype=np.int64)
    np.add.at(s_ptr, s_rows + 1, 1)
    np.cumsum(s_ptr, out=s_ptr)
    return s_ptr, s_cols


def map_values_to_structure(ptr, ind, s_ptr, s_ind, n) -> np.ndarray:
    """Position of each entry of (ptr, ind) inside the superset
    structure (s_ptr, s_ind); both must have sorted column indices."""
    ptr = np.asarray(ptr, dtype=np.int64)
    ind = np.asarray(ind, dtype=np.int64)[: int(ptr[-1])]
    s_ind = np.asarray(s_ind, dtype=np.int64)
    rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(ptr))
    s_rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(s_ptr))
    keys_s = s_rows * n + s_ind
    keys_a = rows * n + ind
    pos = np.searchsorted(keys_s, keys_a)
    if np.any(pos >= keys_s.size) or not np.array_equal(keys_s[pos], keys_a):
        raise ValueError("structure is not a superset of the operand")
    return pos


def _pad_class(x: int) -> int:
    if x <= 0:
        return 0
    p = 8
    while p < x:
        p *= 2
    return p


@dataclass(eq=False)
class _LuBucket:
    """One (level, size-class) batch of supernodal LU fronts."""

    sids: np.ndarray
    nsp: int
    mup: int
    # A assembly into full fronts: F.ravel()[a_dst] += vals[a_src]
    a_dst: np.ndarray
    a_src: np.ndarray
    pad_diag: np.ndarray
    # extend-add of full child Schur blocks, grouped by source bucket
    ext: List[Tuple[Tuple[int, int], np.ndarray, np.ndarray]]
    colg: np.ndarray          # (B, nsp) global col ids (pad -> n)
    rowg: np.ndarray          # (B, mup) global below-row ids (pad -> n)

    @property
    def mp(self) -> int:
        return self.nsp + self.mup


@dataclass(eq=False)
class SupernodalLuPlan:
    n: int
    sym: SupernodalSymbolic
    levels: List[List[_LuBucket]]
    lu_nnz: int               # stored L+U entries (panel area, no padding)


@dataclass(eq=False)
class SupernodalLuFactor:
    plan: SupernodalLuPlan
    # per (level, bucket): combined LU of F11 (B,nsp,nsp), local row
    # permutation (B,nsp), L21 (B,mup,nsp), U12 (B,nsp,mup)
    lu11: Dict[Tuple[int, int], jax.Array]
    perm11: Dict[Tuple[int, int], jax.Array]
    l21: Dict[Tuple[int, int], jax.Array]
    u12: Dict[Tuple[int, int], jax.Array]
    dtype: object


def build_supernodal_lu_plan(sym: SupernodalSymbolic, ptr: np.ndarray,
                             ind: np.ndarray) -> SupernodalLuPlan:
    """Host index plans for the batched LU numeric phase.

    ``ptr``/``ind`` is the full symmetrized (postordered) structure the
    symbolic phase ran on; ``a_src`` indexes that matrix's value array
    (BOTH triangles are assembled — unlike the Cholesky plan)."""
    n = sym.n
    nsn = sym.nsn
    sp, rp, ri = sym.snode_ptr, sym.rows_ptr, sym.rows_idx
    snode_of = sym.snode_of_col()
    width = np.diff(sp)
    msz = np.diff(rp)

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

    # Every entry (i, j) of the symmetrized structure belongs to the
    # front of snode_of[min(i, j)]: both i and j are then in that
    # supernode's row structure (struct is the L-column pattern; the
    # U-row pattern equals it by structural symmetry).
    ptr = np.asarray(ptr, dtype=np.int64)
    ind = np.asarray(ind, dtype=np.int64)
    e_i = np.repeat(np.arange(n, dtype=np.int64), np.diff(ptr))
    e_j = ind[: int(ptr[-1])]
    e_v = np.arange(e_j.size, dtype=np.int64)
    e_s = snode_of[np.minimum(e_i, e_j)]
    order = np.argsort(e_s, kind="stable")
    e_i, e_j, e_v, e_s = e_i[order], e_j[order], e_v[order], e_s[order]
    sbounds = np.searchsorted(e_s, np.arange(nsn + 1))

    def local(pos, ns_s, nsp):
        """struct position -> front index (cols at [0,ns); below at nsp+)."""
        return np.where(pos < ns_s, pos, pos - ns_s + nsp)

    out_levels: List[List[_LuBucket]] = []
    children_of: Dict[int, List[int]] = {}
    for c in range(nsn):
        p = int(sym.sn_parent[c])
        if p >= 0:
            children_of.setdefault(p, []).append(c)

    lu_nnz = 0
    for l, lvl in enumerate(shape_levels):
        buckets: List[_LuBucket] = []
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
                lu_nnz += ns_s * m_s * 2 - ns_s * ns_s
                lo, hi = sbounds[s], sbounds[s + 1]
                ii, jj, vv = e_i[lo:hi], e_j[lo:hi], e_v[lo:hi]
                r_loc = local(np.searchsorted(struct, ii), ns_s, nsp)
                c_loc = local(np.searchsorted(struct, jj), ns_s, nsp)
                a_dst.append((b * mp + r_loc) * mp + c_loc)
                a_src.append(vv)
                pd = np.arange(ns_s, nsp, dtype=np.int64)
                pad_diag.append((b * mp + pd) * mp + pd)
                for c in children_of.get(int(s), ()):
                    lc, bc, slot_c = slot[c]
                    cb = out_levels[lc][bc]
                    cs = ri[rp[c]:rp[c + 1]]
                    rows_c = cs[int(width[c]):]
                    mu_c = rows_c.size
                    if mu_c == 0:
                        continue
                    pos = local(np.searchsorted(struct, rows_c), ns_s, nsp)
                    mup_c = cb.mup
                    li = np.repeat(np.arange(mu_c), mu_c)
                    lj = np.tile(np.arange(mu_c), mu_c)
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
            buckets.append(_LuBucket(
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
    return SupernodalLuPlan(n=n, sym=sym, levels=out_levels, lu_nnz=lu_nnz)


@partial(jax.jit, static_argnames=("size",))
def _assemble(avals, a_dst, a_src, pad_diag, *, size):
    F = jnp.zeros((size,), avals.dtype)
    F = F.at[a_dst].add(avals[a_src])
    F = F.at[pad_diag].add(jnp.ones((), avals.dtype))
    return F


@jax.jit
def _extend(F, U, src, dst):
    return F.at[dst].add(U.reshape(-1)[src])


@partial(jax.jit, static_argnames=("B", "nsp", "mup", "perturb"))
def _lu_factor_bucket(F, scale, real, *, B, nsp, mup, perturb):
    mp = nsp + mup
    F = F.reshape(B, mp, mp)
    F11 = F[:, :nsp, :nsp]
    if perturb:
        # Static pivoting safeguard: lift tiny diagonals to
        # sqrt(eps)·scale (SuperLU-DIST stance; refine afterwards).
        # ``scale`` is the OPERAND's max |value| — the per-block max
        # would include the artificial 1.0 pad diagonals, turning the
        # relative threshold absolute and corrupting small-magnitude
        # matrices (confirmed: rel. error ~1 on a 1e-6-scaled system).
        # ``real`` (B, nsp) masks the injected pad diagonals out of the
        # lift explicitly — without it, scale > 1/sqrt(eps) would lift
        # the inert 1.0 pads too.
        eps = jnp.sqrt(jnp.finfo(F.dtype).eps)
        d = jnp.diagonal(F11, axis1=1, axis2=2)
        sgn = jnp.where(jnp.real(d) < 0, -1.0, 1.0).astype(F.dtype)
        lift = jnp.where(real & (jnp.abs(d) < eps * scale),
                         eps * scale * sgn, 0.0)
        F11 = F11 + jax.vmap(jnp.diag)(lift)
    lu11, _piv, perm = jax.lax.linalg.lu(F11)
    L11 = jnp.tril(lu11, -1) + jnp.eye(nsp, dtype=F.dtype)[None]
    U11 = jnp.triu(lu11)
    if mup:
        F12 = F[:, :nsp, nsp:]
        F21 = F[:, nsp:, :nsp]
        F12p = jnp.take_along_axis(F12, perm[:, :, None], axis=1)
        U12 = jax.lax.linalg.triangular_solve(
            L11, F12p, left_side=True, lower=True, unit_diagonal=True)
        L21 = jax.lax.linalg.triangular_solve(
            U11, F21, left_side=False, lower=False)
        schur = F[:, nsp:, nsp:] - jnp.matmul(L21, U12,
                                              precision=_HIGHEST)
    else:
        U12 = jnp.zeros((B, nsp, 0), F.dtype)
        L21 = jnp.zeros((B, 0, nsp), F.dtype)
        schur = jnp.zeros((B, 0, 0), F.dtype)
    return lu11, perm, L21, U12, schur


def _lu_factor_all(plan: SupernodalLuPlan, perturb: bool,
                   values: jax.Array, tables=None):
    from .supernodal import _table_views

    cv = _table_views(plan, tables)
    scale = jnp.max(jnp.abs(values))
    lu11: Dict[Tuple[int, int], jax.Array] = {}
    perm11: Dict[Tuple[int, int], jax.Array] = {}
    l21: Dict[Tuple[int, int], jax.Array] = {}
    u12: Dict[Tuple[int, int], jax.Array] = {}
    updates: Dict[Tuple[int, int], jax.Array] = {}
    for l, buckets in enumerate(plan.levels):
        for bi, bk in enumerate(buckets):
            B, nsp, mup = bk.sids.size, bk.nsp, bk.mup
            mp = nsp + mup
            F = _assemble(values, cv(bk.a_dst), cv(bk.a_src),
                          cv(bk.pad_diag), size=B * mp * mp)
            for (lc, bc), src, dst in bk.ext:
                F = _extend(F, updates[(lc, bc)], cv(src), cv(dst))
            real = jnp.asarray(bk.colg[:, :nsp] < plan.n)
            lu_b, perm_b, l21_b, u12_b, schur = _lu_factor_bucket(
                F, scale, real, B=B, nsp=nsp, mup=mup, perturb=perturb)
            lu11[(l, bi)] = lu_b
            perm11[(l, bi)] = perm_b
            l21[(l, bi)] = l21_b
            u12[(l, bi)] = u12_b
            updates[(l, bi)] = schur
    return lu11, perm11, l21, u12


def supernodal_lu_factor(plan: SupernodalLuPlan, values: jax.Array,
                         *, perturb: bool = False) -> SupernodalLuFactor:
    """Numeric LU: batched restricted-pivoting dense LU per level bucket.

    ``values`` is the value array of the postordered SYMMETRIZED matrix
    (entries absent from A hold zero — see
    :func:`map_values_to_structure`). The whole level sweep compiles as
    ONE program per (plan, perturb) — per-bucket dispatch cost would
    dominate otherwise."""
    values = jnp.asarray(values)
    cache = getattr(plan, "_factor_jit", None)
    if cache is None:
        cache = {}
        plan._factor_jit = cache
    key = bool(perturb)
    fn = cache.get(key)
    if fn is None:
        # index tables enter as one argument, not as compiled-in
        # constants (hundreds of MB for a 3-D problem)
        fn = jax.jit(partial(_lu_factor_all, plan, key))
        cache[key] = fn
    from .supernodal import _plan_tables

    lu11, perm11, l21, u12 = fn(values, _plan_tables(plan))
    return SupernodalLuFactor(plan=plan, lu11=lu11, perm11=perm11,
                              l21=l21, u12=u12, dtype=values.dtype)


@partial(jax.jit, static_argnames=("nsp",))
def _lu_fwd_bucket(w, lu11, perm, l21, colg, rowg, *, nsp):
    b1 = w[colg]                                   # (B, nsp)
    b1 = jnp.take_along_axis(b1, perm, axis=1)     # local row pivoting
    L11 = jnp.tril(lu11, -1) + jnp.eye(nsp, dtype=lu11.dtype)[None]
    y1 = jax.lax.linalg.triangular_solve(
        L11, b1[..., None], left_side=True, lower=True,
        unit_diagonal=True)[..., 0]
    w = w.at[colg].set(y1)
    if l21.shape[1]:
        w = w.at[rowg].add(-jnp.einsum("bij,bj->bi", l21, y1,
                                       precision=_HIGHEST))
    return w


@partial(jax.jit, static_argnames=("nsp",))
def _lu_bwd_bucket(w, lu11, u12, colg, rowg, *, nsp):
    rhs = w[colg]
    if u12.shape[2]:
        rhs = rhs - jnp.einsum("bij,bj->bi", u12, w[rowg],
                               precision=_HIGHEST)
    U11 = jnp.triu(lu11)
    x1 = jax.lax.linalg.triangular_solve(
        U11, rhs[..., None], left_side=True, lower=False)[..., 0]
    return w.at[colg].set(x1)


def _lu_solve_all(plan: SupernodalLuPlan, lu11, perm11, l21, u12, b,
                  perm=None, iperm=None):
    n = plan.n
    dtype = next(iter(lu11.values())).dtype if lu11 else b.dtype
    if perm is not None:
        b = jnp.asarray(b)[perm]
    w = jnp.zeros(n + 1, dtype).at[:n].set(jnp.asarray(b, dtype))
    for l, buckets in enumerate(plan.levels):
        for bi, bk in enumerate(buckets):
            w = _lu_fwd_bucket(w, lu11[(l, bi)], perm11[(l, bi)],
                               l21[(l, bi)], jnp.asarray(bk.colg),
                               jnp.asarray(bk.rowg), nsp=bk.nsp)
    for l in range(len(plan.levels) - 1, -1, -1):
        for bi, bk in enumerate(plan.levels[l]):
            w = _lu_bwd_bucket(w, lu11[(l, bi)], u12[(l, bi)],
                               jnp.asarray(bk.colg), jnp.asarray(bk.rowg),
                               nsp=bk.nsp)
    x = w[:n]
    if iperm is not None:
        x = x[iperm]
    return x


def supernodal_lu_solve(fac: SupernodalLuFactor, b: jax.Array,
                       perm=None) -> jax.Array:
    """Solve ``A x = b`` (postordered coordinates, or original ones
    when the factorization's row/col ``perm`` is passed — fused into
    the one cached program to avoid one dispatch per bucket)."""
    plan = fac.plan
    key = "_solve_jit" if perm is None else "_solve_jit_p"
    fn = getattr(plan, key, None)
    if fn is None:
        fn = jax.jit(partial(_lu_solve_all, plan))
        setattr(plan, key, fn)
    if perm is None:
        return fn(fac.lu11, fac.perm11, fac.l21, fac.u12, b)
    perm = np.asarray(perm)
    iperm = np.empty(perm.size, dtype=np.int64)
    iperm[perm] = np.arange(perm.size)
    return fn(fac.lu11, fac.perm11, fac.l21, fac.u12, b,
              jnp.asarray(perm), jnp.asarray(iperm))
