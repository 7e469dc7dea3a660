"""Dictionary-of-keys sparse matrix builder (reference: `src/dok.rs`).

DOK is inherently a hash-map — random keyed access with overwrite-on-insert
(`dok.rs:54-58`, `dok.rs:462-482`). A hash map is sequential host work with
no device analogue worth having, so this is the one deliberately host-only
format (SURVEY.md §7 phase 1): a Python dict keyed by ``(row, col)``,
finalised to COO/CSR/CSC arrays before any device compute.

Semantics preserved from the reference:
- no duplicates: ``insert`` overwrites and returns the previous value
  (`dok.rs:462-482`)
- unordered iteration (`dok.rs:503-522`)
- zero-dim shapes rejected (`dok.rs:106-107`)
- out-of-range keys rejected (`dok.rs:465-466` and accessor asserts)
- ``+``/``-`` merge by key with add/sub-assign (`dok.rs:722-752`); the
  reference omits the shape assert here (SURVEY.md C7 quirk) — we *do*
  validate shapes and document the divergence (panic-free merge of
  mismatched shapes is a reference bug, not a feature)
- ``transpose`` swaps key components (`dok.rs:547-559`)
"""

from __future__ import annotations

from typing import Dict, Iterable, Iterator, Optional, Tuple

import numpy as np

from ..dtypes import canonical_value_dtype, result_dtype
from ..errors import IndexError_, ShapeError

__all__ = ["DokMatrix"]


class DokMatrix:
    """Hash-map sparse matrix (host builder), mirroring ``spalinalg::DokMatrix``.

    Examples
    --------
    Keyed access with overwrite-on-insert (`dok.rs:462-482`):

    >>> from spalinalg import DokMatrix
    >>> m = DokMatrix(2, 2)
    >>> m.insert(0, 1, 3.0) is None
    True
    >>> m.insert(0, 1, 4.0)     # returns the previous value
    3.0
    >>> m.get(0, 1)
    4.0
    >>> m.contains(1, 0)
    False

    Merge arithmetic keeps cancelled sums as stored zeros
    (`dok.rs:722-752`):

    >>> a = DokMatrix.with_entries(2, 2, [(0, 0, 1.0)])
    >>> b = DokMatrix.with_entries(2, 2, [(0, 0, -1.0)])
    >>> (a + b).get(0, 0)
    0.0
    """

    __slots__ = ("_nrows", "_ncols", "_map", "_dtype")

    def __init__(self, nrows: int, ncols: int, *, dtype=np.float64):
        # Reference `DokMatrix::new` (dok.rs:105-126).
        if nrows <= 0 or ncols <= 0:
            raise ShapeError(
                f"matrix dimensions must be positive, got {nrows}x{ncols} "
                "(reference: dok.rs:106-107)"
            )
        self._nrows = int(nrows)
        self._ncols = int(ncols)
        self._dtype = np.dtype(canonical_value_dtype(dtype))
        self._map: Dict[Tuple[int, int], float] = {}

    # ------------------------------------------------------------------
    # Constructors (dok.rs:105-299)
    # ------------------------------------------------------------------

    @classmethod
    def new(cls, nrows: int, ncols: int, *, dtype=np.float64) -> "DokMatrix":
        return cls(nrows, ncols, dtype=dtype)

    @classmethod
    def eye(cls, size: int, *, dtype=np.float64) -> "DokMatrix":
        """Identity matrix (dok.rs:128-161)."""
        out = cls(size, size, dtype=dtype)
        one = out._dtype.type(1)
        out._map = {(i, i): one for i in range(size)}
        return out

    @classmethod
    def with_capacity(
        cls, nrows: int, ncols: int, capacity: int, *, dtype=np.float64
    ) -> "DokMatrix":
        """Python dicts manage capacity internally; shape/validation parity
        with dok.rs:163-203."""
        del capacity
        return cls(nrows, ncols, dtype=dtype)

    @classmethod
    def with_entries(
        cls,
        nrows: int,
        ncols: int,
        entries: Iterable[Tuple[int, int, float]],
        *,
        dtype=np.float64,
    ) -> "DokMatrix":
        """Build from ``(row, col, value)`` iterable; later duplicates
        overwrite earlier ones (insert semantics, dok.rs:205-253)."""
        out = cls(nrows, ncols, dtype=dtype)
        for row, col, value in entries:
            out.insert(row, col, value)
        return out

    @classmethod
    def with_triplets(
        cls, nrows: int, ncols: int, rows, cols, values, *, dtype=None
    ) -> "DokMatrix":
        """Build from parallel sequences (dok.rs:255-299)."""
        rows = list(rows)
        cols = list(cols)
        values = list(values)
        if not (len(rows) == len(cols) == len(values)):
            raise ShapeError(
                f"triplet length mismatch: {len(rows)} rows, {len(cols)} cols, "
                f"{len(values)} values (reference: dok.rs:255-299)"
            )
        if dtype is None:
            dtype = np.result_type(*[np.float64] if not values else
                                   [np.asarray(values).dtype, np.float32])
            if np.dtype(dtype).kind != "f":
                dtype = np.float64
        out = cls(nrows, ncols, dtype=dtype)
        for row, col, value in zip(rows, cols, values):
            out.insert(row, col, value)
        return out

    # ------------------------------------------------------------------
    # Accessors (dok.rs:301-460)
    # ------------------------------------------------------------------

    @property
    def nrows(self) -> int:
        return self._nrows

    @property
    def ncols(self) -> int:
        return self._ncols

    @property
    def shape(self) -> Tuple[int, int]:
        return (self._nrows, self._ncols)

    @property
    def dtype(self) -> np.dtype:
        return self._dtype

    @property
    def length(self) -> int:
        """Number of stored entries (dok.rs:350-365)."""
        return len(self._map)

    @property
    def nnz(self) -> int:
        return len(self._map)

    @property
    def capacity(self) -> int:
        """Documented divergence from `dok.rs:367-391`: the reference
        reports the HashMap's real allocated capacity (>= len); Python
        dicts hide theirs, so this returns the current length. Only the
        `capacity >= nnz` contract is preserved."""
        return len(self._map)

    def _check_key(self, row: int, col: int) -> None:
        if not 0 <= row < self._nrows:
            raise IndexError_(
                f"row index {row} out of range for {self._nrows}x{self._ncols} "
                "matrix (reference: dok.rs:465)"
            )
        if not 0 <= col < self._ncols:
            raise IndexError_(
                f"column index {col} out of range for {self._nrows}x{self._ncols} "
                "matrix (reference: dok.rs:466)"
            )

    def contains(self, row: int, col: int) -> bool:
        """Whether an entry is stored at ``(row, col)`` (dok.rs:393-414)."""
        self._check_key(row, col)
        return (row, col) in self._map

    def get(self, row: int, col: int) -> Optional[float]:
        """Stored value at ``(row, col)`` or ``None`` (dok.rs:416-437)."""
        self._check_key(row, col)
        val = self._map.get((row, col))
        return None if val is None else float(val)

    def insert(self, row: int, col: int, value) -> Optional[float]:
        """Insert/overwrite; returns the previous value if any (dok.rs:462-482)."""
        self._check_key(row, col)
        old = self._map.get((row, col))
        self._map[(row, col)] = self._dtype.type(value)
        return None if old is None else float(old)

    def remove(self, row: int, col: int) -> Optional[float]:
        """Remove an entry, returning it if present (idiomatic dict surface)."""
        self._check_key(row, col)
        old = self._map.pop((row, col), None)
        return None if old is None else float(old)

    def clear(self) -> None:
        """Remove all entries (dok.rs:484-501)."""
        self._map.clear()

    def extend(self, entries: Iterable[Tuple[int, int, float]]) -> None:
        """Insert entries from an iterable (``Extend`` impl, dok.rs:561-587)."""
        for row, col, value in entries:
            self.insert(row, col, value)

    # ------------------------------------------------------------------
    # Iteration (dok.rs:503-545, 589-637)
    # ------------------------------------------------------------------

    def iter(self) -> Iterator[Tuple[int, int, float]]:
        """Iterate stored entries (unordered, dok.rs:503-522)."""
        for (row, col), value in self._map.items():
            yield (row, col, float(value))

    __iter__ = iter

    def map_values(self, fn) -> "DokMatrix":
        """Apply ``fn`` to every stored value (stand-in for ``iter_mut``,
        dok.rs:524-545)."""
        out = self.copy()
        for key in out._map:
            out._map[key] = out._dtype.type(fn(out._map[key]))
        return out

    # ------------------------------------------------------------------
    # Structure ops
    # ------------------------------------------------------------------

    def transpose(self) -> "DokMatrix":
        """Swap key components (dok.rs:547-559)."""
        out = DokMatrix(self._ncols, self._nrows, dtype=self._dtype)
        out._map = {(c, r): v for (r, c), v in self._map.items()}
        return out

    @property
    def T(self) -> "DokMatrix":
        return self.transpose()

    def copy(self) -> "DokMatrix":
        out = DokMatrix(self._nrows, self._ncols, dtype=self._dtype)
        out._map = dict(self._map)
        return out

    # ------------------------------------------------------------------
    # Arithmetic (dok.rs:722-769): keyed merge semantics
    # ------------------------------------------------------------------

    def _merge(self, other: "DokMatrix", sign: int) -> "DokMatrix":
        if self.shape != other.shape:
            # The reference forgot this assert for DOK (SURVEY.md C7); we
            # validate deliberately — divergence documented.
            raise ShapeError(
                f"shape mismatch {self.shape} vs {other.shape} "
                "(reference omits this check for DOK; intentional divergence)"
            )
        dt = result_dtype(self._dtype, other._dtype)
        out = DokMatrix(self._nrows, self._ncols, dtype=dt)
        out._map = {k: dt.type(v) for k, v in self._map.items()}
        for key, value in other._map.items():
            out._map[key] = dt.type(out._map.get(key, dt.type(0)) + sign * value)
        return out

    def __add__(self, other: "DokMatrix") -> "DokMatrix":
        """Keyed merge with add-assign (dok.rs:722-736). Cancelled sums are
        kept as explicit zeros, like the reference's ``entry().or_default()``."""
        if not isinstance(other, DokMatrix):
            return NotImplemented
        return self._merge(other, +1)

    def __sub__(self, other: "DokMatrix") -> "DokMatrix":
        """Keyed merge with sub-assign (dok.rs:738-752)."""
        if not isinstance(other, DokMatrix):
            return NotImplemented
        return self._merge(other, -1)

    def __neg__(self) -> "DokMatrix":
        """Negate every stored value (dok.rs:754-769)."""
        out = self.copy()
        for key in out._map:
            out._map[key] = -out._map[key]
        return out

    # ------------------------------------------------------------------
    # Export
    # ------------------------------------------------------------------

    def to_arrays(self):
        """Return ``(rows, cols, values)`` host arrays (unspecified order —
        matching the reference's unordered iteration)."""
        n = len(self._map)
        rows = np.empty(n, dtype=np.int64)
        cols = np.empty(n, dtype=np.int64)
        vals = np.empty(n, dtype=self._dtype)
        for i, ((r, c), v) in enumerate(self._map.items()):
            rows[i] = r
            cols[i] = c
            vals[i] = v
        return rows, cols, vals

    def to_dense(self) -> np.ndarray:
        out = np.zeros(self.shape, dtype=self._dtype)
        for (r, c), v in self._map.items():
            out[r, c] = v
        return out

    def __repr__(self) -> str:
        return (
            f"DokMatrix(shape={self.shape}, length={self.length}, "
            f"dtype={self._dtype.name})"
        )

    def __eq__(self, other) -> bool:
        if not isinstance(other, DokMatrix):
            return NotImplemented
        return self.shape == other.shape and self._map == other._map
