"""Fill-reducing / bandwidth-reducing orderings (host-side symbolic tier).

The factorization pipeline (SURVEY.md §7 phase 5) keeps all symbolic
analysis on the host, once per structure: reverse Cuthill–McKee to compress
the band, elimination levels for triangular solves. These are pure-NumPy
(native C++ acceleration hooks live in ``spalinalg.native``).
"""

from __future__ import annotations

from collections import deque
from typing import Tuple

import numpy as np

__all__ = ["rcm_ordering", "bandwidth", "level_schedule"]


def _adjacency(ptr: np.ndarray, ind: np.ndarray, n: int):
    return lambda i: ind[ptr[i] : ptr[i + 1]]


def rcm_ordering(csr) -> np.ndarray:
    """Reverse Cuthill–McKee permutation of a (structurally symmetric)
    matrix; returns ``perm`` such that ``A[perm][:, perm]`` has reduced
    bandwidth. BFS from a pseudo-peripheral vertex, neighbours by degree.
    """
    ptr = np.asarray(csr._ptr, dtype=np.int64)
    ind = np.asarray(csr._minor, dtype=np.int64)[: int(ptr[-1])]
    n = csr.nrows

    if n > 2048:
        from ..native import lib as _native

        if _native.available():
            return _native.rcm(ptr, ind, n)

    deg = np.diff(ptr)
    visited = np.zeros(n, dtype=bool)
    order = []

    def bfs(start):
        comp = []
        visited[start] = True
        q = deque([start])
        while q:
            u = q.popleft()
            comp.append(u)
            nbrs = ind[ptr[u] : ptr[u + 1]]
            nbrs = nbrs[~visited[nbrs]]
            for v in nbrs[np.argsort(deg[nbrs], kind="stable")]:
                if not visited[v]:
                    visited[v] = True
                    q.append(int(v))
        return comp

    for comp_start in range(n):
        if visited[comp_start]:
            continue
        # pseudo-peripheral start: run one BFS, restart from the last level
        first = bfs(comp_start)
        for u in first:
            visited[u] = False
        start = first[-1]
        order.extend(bfs(start))

    return np.asarray(order[::-1], dtype=np.int64)


def bandwidth(csr) -> int:
    """Half-bandwidth ``max |i - j|`` over stored entries."""
    ptr = np.asarray(csr._ptr, dtype=np.int64)
    ind = np.asarray(csr._minor, dtype=np.int64)[: int(ptr[-1])]
    rows = np.repeat(np.arange(csr.nrows, dtype=np.int64), np.diff(ptr))
    if rows.size == 0:
        return 0
    return int(np.abs(rows - ind).max())


def level_schedule(ptr: np.ndarray, ind: np.ndarray, n: int,
                   *, lower: bool) -> Tuple[np.ndarray, np.ndarray]:
    """Dependency levels for sparse triangular solves.

    ``level[i] = 1 + max(level[j])`` over off-diagonal entries ``j`` of row
    ``i`` (lower) / reversed rows (upper). Returns ``(levels, order)`` where
    ``order`` lists rows grouped by level and ``levels`` is the per-group
    boundary pointer (like a rowptr over the groups).
    """
    ptr = np.asarray(ptr, dtype=np.int64)
    ind = np.asarray(ind, dtype=np.int64)
    if n > 2048:
        from ..native import lib as _native

        if _native.available():
            n_levels, lev = _native.level_schedule(ptr, ind, n, lower=lower)
            order = np.argsort(lev, kind="stable")
            bounds = np.searchsorted(lev[order], np.arange(n_levels + 1))
            return bounds.astype(np.int64), order.astype(np.int64)
    lev = np.zeros(n, dtype=np.int64)
    rows = range(n) if lower else range(n - 1, -1, -1)
    for i in rows:
        deps = ind[ptr[i] : ptr[i + 1]]
        deps = deps[deps < i] if lower else deps[deps > i]
        if deps.size:
            lev[i] = lev[deps].max() + 1
    n_levels = int(lev.max()) + 1 if n else 0
    order = np.argsort(lev, kind="stable")
    bounds = np.searchsorted(lev[order], np.arange(n_levels + 1))
    return bounds.astype(np.int64), order.astype(np.int64)
