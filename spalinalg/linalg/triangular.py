"""Sparse triangular solves (north-star N5).

Level-scheduled formulation (SURVEY.md §7 phase 5): rows are grouped into
dependency levels host-side (`ordering.level_schedule`); rows within a level
solve in parallel on device. The solution vector is built **in level order**
so each level writes one contiguous slab (``dynamic_update_slice``, no
scatter), and a single inverse-permutation gather restores row order at the
end — the same scatter-free discipline as `ops/reduction.py`.

Deeply sequential structures (e.g. unordered band matrices whose level count
approaches n) would unroll into enormous XLA graphs; those fall back to a
host sweep, and the banded path (`banded.py`) is the right tool anyway.

Examples
--------
>>> import numpy as np
>>> from spalinalg import CsrMatrix
>>> from spalinalg.linalg import solve_triangular_csr
>>> L = CsrMatrix(3, 3, [0, 1, 3, 5], [0, 0, 1, 1, 2],
...               [2.0, 1.0, 2.0, 1.0, 2.0])
>>> x = solve_triangular_csr(L, np.array([2.0, 5.0, 6.0]), lower=True)
>>> [round(float(v), 6) for v in x]
[1.0, 2.0, 2.0]
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np

import jax
import jax.numpy as jnp

from ..dtypes import INDEX_DTYPE
from ..errors import StructureError
from .ordering import level_schedule

__all__ = ["TriangularPlan", "plan_triangular", "solve_triangular_csr"]

_MAX_DEVICE_LEVELS = 256


@dataclass(frozen=True, eq=False)
class TriangularPlan:
    """Host-built level schedule + gather layout for one triangular matrix."""

    lower: bool
    unit_diag: bool
    n: int
    order: np.ndarray        # rows in level order
    iperm_dev: jax.Array     # (n,) position of each row in level order
    bounds: np.ndarray       # (n_levels+1,) row-group boundaries in `order`
    # per level: (value gather idx, col position idx, reduce plan)
    levels: Tuple
    diag_dev: jax.Array      # (n,) diagonal values in level order
    n_levels: int

    @property
    def use_device(self) -> bool:
        return self.n_levels <= _MAX_DEVICE_LEVELS


def plan_triangular(csr, *, lower: bool, unit_diag: bool = False
                    ) -> TriangularPlan:
    """Analyse a triangular CSR matrix once (host symbolic phase)."""
    from ..ops.reduction import build_segment_reduce_plan

    n = csr.nrows
    ptr = np.asarray(csr._ptr, dtype=np.int64)
    ind = np.asarray(csr._minor, dtype=np.int64)[: int(ptr[-1])]
    val = np.asarray(csr._values)[: int(ptr[-1])]
    rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(ptr))

    bounds, order = level_schedule(ptr, ind, n, lower=lower)
    iperm = np.empty(n, dtype=np.int64)
    iperm[order] = np.arange(n)

    offdiag = ind < rows if lower else ind > rows
    diag_mask = ind == rows
    diag = np.zeros(n, dtype=val.dtype)
    diag[rows[diag_mask]] = val[diag_mask]
    if unit_diag:
        diag[:] = 1.0
    elif np.any(diag == 0):
        raise StructureError(
            "triangular matrix has a zero/missing diagonal entry"
        )

    n_levels = bounds.size - 1
    levels = []
    if n_levels <= _MAX_DEVICE_LEVELS:
        e_row_pos = iperm[rows]  # row position in level order, per entry
        for lv in range(n_levels):
            lo, hi = int(bounds[lv]), int(bounds[lv + 1])
            sel = offdiag & (e_row_pos >= lo) & (e_row_pos < hi)
            e_idx = np.nonzero(sel)[0]
            # sort entries by their row's level-order position
            o = np.argsort(e_row_pos[e_idx], kind="stable")
            e_idx = e_idx[o]
            sizes = np.bincount(e_row_pos[e_idx] - lo, minlength=hi - lo)
            plan = build_segment_reduce_plan(sizes)
            levels.append((
                jnp.asarray(e_idx, dtype=INDEX_DTYPE),
                jnp.asarray(iperm[ind[e_idx]], dtype=INDEX_DTYPE),
                plan,
            ))

    return TriangularPlan(
        lower=lower,
        unit_diag=unit_diag,
        n=n,
        order=order,
        iperm_dev=jnp.asarray(iperm, dtype=INDEX_DTYPE),
        bounds=bounds,
        levels=tuple(levels),
        diag_dev=jnp.asarray(diag[order]),
        n_levels=n_levels,
    )


def _solve_device(plan: TriangularPlan, values, b):
    from ..ops.reduction import segment_reduce

    b_ord = b[jnp.asarray(plan.order)]
    x_ord = jnp.zeros_like(b_ord)
    for lv, (e_idx, col_pos, rplan) in enumerate(plan.levels):
        lo, hi = int(plan.bounds[lv]), int(plan.bounds[lv + 1])
        if hi == lo:
            continue
        contrib = segment_reduce(rplan, values[e_idx] * x_ord[col_pos])
        xs = (b_ord[lo:hi] - contrib) / plan.diag_dev[lo:hi]
        x_ord = jax.lax.dynamic_update_slice(x_ord, xs, (lo,))
    return x_ord[plan.iperm_dev]


def _solve_host(plan: TriangularPlan, csr, b):
    n = plan.n
    ptr = np.asarray(csr._ptr, dtype=np.int64)
    ind = np.asarray(csr._minor, dtype=np.int64)[: int(ptr[-1])]
    val = np.asarray(csr._values)[: int(ptr[-1])]
    x = np.zeros(n, dtype=np.result_type(val.dtype, np.asarray(b).dtype))
    bh = np.asarray(b)
    rows = range(n) if plan.lower else range(n - 1, -1, -1)
    for i in rows:
        s = bh[i]
        d = 1.0 if plan.unit_diag else None
        for k in range(int(ptr[i]), int(ptr[i + 1])):
            j = int(ind[k])
            if j == i:
                d = val[k] if not plan.unit_diag else 1.0
            elif (j < i) if plan.lower else (j > i):
                s -= val[k] * x[j]
        x[i] = s / d
    return jnp.asarray(x)


def solve_triangular_csr(csr, b, *, lower: bool = True,
                         unit_diag: bool = False,
                         plan: TriangularPlan = None) -> jax.Array:
    """Solve ``L x = b`` (or ``U x = b``) for sparse triangular CSR.

    Pass a precomputed ``plan`` to amortise the symbolic phase across many
    solves with the same structure.
    """
    if plan is None:
        plan = plan_triangular(csr, lower=lower, unit_diag=unit_diag)
    b = jnp.asarray(b)
    if plan.use_device:
        return _solve_device(plan, csr.values, b)
    return _solve_host(plan, csr, b)
