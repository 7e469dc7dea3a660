"""Compressed sparse formats: CSR and CSC (reference: `src/csr.rs`, `src/csc.rs`).

The reference implements CSR and CSC as literal mirrors of each other (511
LoC each, identical structure — SURVEY.md C4/C5). Here both are thin
subclasses of one ``_CompressedMatrix`` parameterised by the compression
axis: CSR compresses the **row** (major) axis, CSC the **column** axis.

Design:
- a compressed matrix is a **pytree of device arrays** — ``ptr`` (int32,
  ``n_major + 1``), ``minor`` indices (int32, ``nse``), ``values`` — with
  static aux data ``(nrows, ncols)``. It passes through ``jit`` /
  ``shard_map`` / ``vmap`` like any other JAX value.
- structure is immutable (like the reference: no insert/remove on CSR/CSC,
  `csr.rs:20-23`); values are replaced functionally via :meth:`with_values`
  (the reference's ``values_mut``, `csr.rs:270-285`).
- ``nse`` (number of stored elements, the static array length) may exceed
  the logical ``nnz`` (= ``ptr[-1]``): jit-produced results carry sentinel
  padding (see ``convert/engine.py``). Eagerly constructed matrices are
  exact (``nse == nnz``) like the reference.
- transpose and all conversions run the device sort/segment engine — the
  reference's 2-pass counting sorts (`csr.rs:358-406`, `src/csr/conv/*`)
  have no separate implementation here.

Validation mirrors every constructor assert in `csr.rs:144-156` /
`csc.rs:144-156`, raising :class:`StructureError` host-side.
"""

from __future__ import annotations

from typing import Iterator, Tuple

import numpy as np

import jax
import jax.numpy as jnp

from ..dtypes import INDEX_DTYPE, canonical_value_dtype
from ..errors import ShapeError, StructureError

__all__ = ["CsrMatrix", "CscMatrix"]


def _is_concrete(*arrays) -> bool:
    return not any(isinstance(a, jax.core.Tracer) for a in arrays)


from ..utils.plancache import StructureCache

_TRANSPOSE_CACHE = StructureCache(maxsize=32)


class _CompressedMatrix:
    """Shared implementation of CSR/CSC. ``_MAJOR_AXIS`` = 0 for CSR (rows
    compressed), 1 for CSC (columns compressed)."""

    _MAJOR_AXIS = 0  # overridden in CscMatrix

    __slots__ = ("_ptr", "_minor", "_values", "_nrows", "_ncols")

    def __init__(self, nrows: int, ncols: int, ptr, minor, values):
        """Validating constructor (reference ``new``: `csr.rs:137-177`).

        All eight reference asserts are checked host-side when the inputs
        are concrete; traced inputs skip validation (structure produced
        inside jit comes from trusted engine code).
        """
        nrows, ncols = int(nrows), int(ncols)
        if nrows <= 0 or ncols <= 0:
            raise ShapeError(
                f"matrix dimensions must be positive, got {nrows}x{ncols} "
                "(reference: csr.rs:144-145)"
            )
        self._nrows, self._ncols = nrows, ncols
        concrete = _is_concrete(ptr, minor, values)
        if concrete:
            self._validate(nrows, ncols, np.asarray(ptr), np.asarray(minor),
                           np.asarray(values))
            values = jnp.asarray(values, dtype=canonical_value_dtype(
                np.asarray(values).dtype if np.asarray(values).dtype.kind == "f"
                else np.float64))
        self._ptr = jnp.asarray(ptr, dtype=INDEX_DTYPE) if concrete else ptr
        self._minor = jnp.asarray(minor, dtype=INDEX_DTYPE) if concrete else minor
        self._values = jnp.asarray(values) if concrete else values

    @classmethod
    def _major_dim(cls, nrows: int, ncols: int) -> int:
        return nrows if cls._MAJOR_AXIS == 0 else ncols

    @classmethod
    def _minor_dim(cls, nrows: int, ncols: int) -> int:
        return ncols if cls._MAJOR_AXIS == 0 else nrows

    @classmethod
    def _validate(cls, nrows, ncols, ptr, minor, values):
        n_major = cls._major_dim(nrows, ncols)
        n_minor = cls._minor_dim(nrows, ncols)
        what = "rowptr" if cls._MAJOR_AXIS == 0 else "colptr"
        ind = "colind" if cls._MAJOR_AXIS == 0 else "rowind"
        if ptr.ndim != 1 or ptr.size != n_major + 1:
            raise StructureError(
                f"{what} length must be {n_major + 1}, got {ptr.size} "
                "(reference: csr.rs:146)"
            )
        if ptr.size and ptr[0] != 0:
            raise StructureError(
                f"{what}[0] must be 0, got {ptr[0]} (reference: csr.rs:147)"
            )
        nnz = int(ptr[-1])
        if minor.ndim != 1 or minor.size != nnz:
            raise StructureError(
                f"{ind} length must equal {what}[-1] ({nnz}), got {minor.size} "
                "(reference: csr.rs:148)"
            )
        if values.ndim != 1 or values.size != nnz:
            raise StructureError(
                f"values length must equal {what}[-1] ({nnz}), got {values.size} "
                "(reference: csr.rs:149)"
            )
        if np.any(np.diff(ptr) < 0):
            raise StructureError(
                f"{what} must be monotonically non-decreasing "
                "(reference: csr.rs:150-151)"
            )
        if minor.size and (minor.min() < 0 or minor.max() >= n_minor):
            raise StructureError(
                f"{ind} entries must be in [0, {n_minor}) "
                "(reference: csr.rs:152-153)"
            )
        # Strictly increasing minor indices within each major slice
        # (reference: csr.rs:154-156).
        if minor.size:
            d = np.diff(minor.astype(np.int64))
            boundary = np.zeros(minor.size - 1, dtype=bool)
            inner_starts = ptr[1:-1]
            boundary[inner_starts[(inner_starts > 0) &
                                  (inner_starts < minor.size)] - 1] = True
            if np.any((d <= 0) & ~boundary):
                raise StructureError(
                    f"{ind} must be strictly increasing within each "
                    f"{'row' if cls._MAJOR_AXIS == 0 else 'column'} "
                    "(reference: csr.rs:154-156)"
                )

    # ------------------------------------------------------------------
    # Pytree protocol
    # ------------------------------------------------------------------

    def tree_flatten(self):
        return (self._ptr, self._minor, self._values), (self._nrows, self._ncols)

    @classmethod
    def tree_unflatten(cls, aux, children):
        nrows, ncols = aux
        ptr, minor, values = children
        return cls._from_parts(nrows, ncols, ptr, minor, values)

    @classmethod
    def _from_parts(cls, nrows, ncols, ptr, minor, values):
        """Trusted constructor: no validation, no dtype coercion."""
        obj = object.__new__(cls)
        obj._nrows, obj._ncols = int(nrows), int(ncols)
        obj._ptr, obj._minor, obj._values = ptr, minor, values
        return obj

    # ------------------------------------------------------------------
    # Constructors
    # ------------------------------------------------------------------

    @classmethod
    def from_dense(cls, dense, *, drop_zeros: bool = True):
        """Compress a dense host/device array (zeros dropped by default)."""
        from ..convert.engine import compress_host

        d = np.asarray(dense)
        if d.ndim != 2:
            raise ShapeError(f"dense input must be 2-D, got shape {d.shape}")
        rows, cols = np.nonzero(d) if drop_zeros else np.indices(d.shape).reshape(2, -1)
        vals = d[rows, cols]
        n_major = cls._major_dim(*d.shape)
        major, minor = (rows, cols) if cls._MAJOR_AXIS == 0 else (cols, rows)
        ptr, minor, values = compress_host(
            major, minor, vals, n_major, dedup=False, drop_zeros=False
        )
        return cls._from_parts(
            d.shape[0], d.shape[1],
            jnp.asarray(ptr, dtype=INDEX_DTYPE),
            jnp.asarray(minor, dtype=INDEX_DTYPE),
            jnp.asarray(values),
        )

    @classmethod
    def eye(cls, size: int, *, dtype=np.float64) -> "_CompressedMatrix":
        """Identity matrix (reference ``eye``, csr.rs:179-198)."""
        dtype = canonical_value_dtype(dtype)
        ptr = jnp.arange(size + 1, dtype=INDEX_DTYPE)
        minor = jnp.arange(size, dtype=INDEX_DTYPE)
        values = jnp.ones(size, dtype=dtype)
        return cls._from_parts(size, size, ptr, minor, values)

    # ------------------------------------------------------------------
    # Accessors (csr.rs:200-301)
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
    def dtype(self):
        return self._values.dtype

    @property
    def values(self) -> jax.Array:
        """Stored values (csr.rs:256-268). Length ``nse``; slots beyond
        ``nnz`` are zero padding."""
        return self._values

    @property
    def nse(self) -> int:
        """Static number of stored-element slots (>= logical nnz)."""
        return int(self._minor.shape[0])

    @property
    def nnz(self) -> int:
        """Logical number of stored entries, ``ptr[-1]`` (csr.rs:287-301).

        Host-synchronising; under a jit trace use :meth:`nnz_device`.
        """
        return int(self._ptr[-1])

    def nnz_device(self) -> jax.Array:
        """``ptr[-1]`` as a device scalar (trace-safe)."""
        return self._ptr[-1]

    def with_values(self, values: jax.Array) -> "_CompressedMatrix":
        """Functional replacement of the value array — same structure, new
        values (the reference's ``values_mut``, csr.rs:270-285)."""
        if not isinstance(values, jax.core.Tracer):
            values = jnp.asarray(values)
        if values.shape != self._values.shape:
            raise ShapeError(
                f"values length must stay {self._values.shape[0]}, "
                f"got {values.shape}"
            )
        return type(self)._from_parts(
            self._nrows, self._ncols, self._ptr, self._minor, values
        )

    def astype(self, dtype) -> "_CompressedMatrix":
        """Cast stored values to ``dtype`` (same structure).

        The dtype must stay inside the supported scalar set (f32/f64 +
        the bf16 storage extension — `dtypes.py`); DTypeError otherwise,
        mirroring the constructors.

        >>> from spalinalg import CsrMatrix
        >>> CsrMatrix.eye(2).astype("float32").dtype.name
        'float32'
        """
        from ..dtypes import canonical_value_dtype

        dtype = canonical_value_dtype(dtype)
        return self.with_values(self._values.astype(dtype))

    def map_values(self, fn) -> "_CompressedMatrix":
        """Apply ``fn`` elementwise to stored values.

        Functional stand-in for ``iter_mut`` (csr.rs:330-356). The reference
        version iterates ``0..ncols`` instead of ``0..nrows`` — a bug
        (SURVEY.md §2.1 quirks) we deliberately do not reproduce.
        """
        return self.with_values(fn(self._values))

    # ------------------------------------------------------------------
    # Iteration (csr.rs:303-328, 409-440) — host-side, eager
    # ------------------------------------------------------------------

    def iter(self) -> Iterator[Tuple[int, int, float]]:
        """Yield ``(row, col, value)`` in major-sorted order (csr.rs:303-328).

        Unlike the reference — which materialises an O(nnz) triplet ``Vec``
        up front (`csr.rs:303-316`) — this yields lazily from host copies.
        """
        ptr = np.asarray(self._ptr)
        minor = np.asarray(self._minor)
        values = np.asarray(self._values)
        for maj in range(self._major_dim(self._nrows, self._ncols)):
            for k in range(int(ptr[maj]), int(ptr[maj + 1])):
                if self._MAJOR_AXIS == 0:
                    yield (maj, int(minor[k]), values[k].item())
                else:
                    yield (int(minor[k]), maj, values[k].item())

    __iter__ = iter

    # ------------------------------------------------------------------
    # Structure ops
    # ------------------------------------------------------------------

    def transpose(self):
        """Transpose via the device sort engine (replaces the reference's
        2-pass counting sort, csr.rs:358-406). CSR.T -> CSR of the
        transposed matrix (same class, like the reference).

        Memoised per concrete structure+values (id-keyed, like the CSC
        mirror cache) so repeated ``A.T @ x`` reuses the result AND its
        downstream SpMV plans instead of rebuilding per call."""
        import jax as _jax

        from ..convert.engine import transpose_compressed_device

        concrete = not any(
            isinstance(a, _jax.core.Tracer)
            for a in (self._ptr, self._minor, self._values))

        def build():
            n_major = self._major_dim(self._nrows, self._ncols)
            n_minor = self._minor_dim(self._nrows, self._ncols)
            ptr, minor, values = transpose_compressed_device(
                self._ptr, self._minor, self._values,
                n_major=n_major, n_minor=n_minor,
            )
            return type(self)._from_parts(self._ncols, self._nrows, ptr,
                                          minor, values)

        if not concrete:
            return build()
        key = (type(self), id(self._ptr), id(self._minor),
               id(self._values), self._nrows, self._ncols)
        return _TRANSPOSE_CACHE.get(
            key, (self._ptr, self._minor, self._values), build)

    @property
    def T(self):
        return self.transpose()

    # ------------------------------------------------------------------
    # Reductions / queries (scipy-style surface; ops/reduce_api.py)
    # ------------------------------------------------------------------

    def sum(self, axis=None):
        from ..ops.reduce_api import mat_sum

        return mat_sum(self, axis)

    def mean(self, axis=None):
        from ..ops.reduce_api import mat_mean

        return mat_mean(self, axis)

    def diagonal(self, k: int = 0):
        from ..ops.reduce_api import diagonal

        return diagonal(self, k)

    def multiply(self, other):
        """Elementwise (Hadamard) product — NOT SpGEMM (`*` is, matching
        the reference operator); scipy's ``A.multiply(B)`` semantics."""
        from ..ops.reduce_api import multiply

        return multiply(self, other)

    def norm(self, ord="fro"):
        from ..ops.reduce_api import norm

        return norm(self, ord)

    # ------------------------------------------------------------------
    # Export helpers
    # ------------------------------------------------------------------

    def _coo_arrays_host(self):
        """Host ``(rows, cols, values)`` in major-sorted order, exact nnz."""
        ptr = np.asarray(self._ptr, dtype=np.int64)
        minor = np.asarray(self._minor, dtype=np.int64)
        values = np.asarray(self._values)
        nnz = int(ptr[-1])
        major = np.repeat(np.arange(ptr.size - 1, dtype=np.int64), np.diff(ptr))
        minor, values = minor[:nnz], values[:nnz]
        if self._MAJOR_AXIS == 0:
            return major, minor, values
        return minor, major, values

    def to_dense(self) -> jax.Array:
        """Dense device array (padding contributes nothing)."""
        nse = self.nse
        from ..convert.engine import major_ids_device

        major = major_ids_device(self._ptr, nse)
        n_major = self._major_dim(self._nrows, self._ncols)
        valid = major < n_major
        maj_c = jnp.where(valid, major, 0)
        dense_majmin = jnp.zeros(
            (n_major, self._minor_dim(self._nrows, self._ncols)),
            dtype=self._values.dtype,
        ).at[maj_c, self._minor].add(jnp.where(valid, self._values, 0))
        return dense_majmin if self._MAJOR_AXIS == 0 else dense_majmin.T

    def __repr__(self) -> str:
        name = type(self).__name__
        try:
            nnz = self.nnz
        except Exception:  # under trace
            nnz = "?"
        return f"{name}(shape={self.shape}, nnz={nnz}, nse={self.nse}, dtype={self.dtype})"

    # ------------------------------------------------------------------
    # Arithmetic operators — implementations live in spalinalg.ops
    # ------------------------------------------------------------------

    def __add__(self, other):
        from ..ops import elementwise

        if isinstance(other, type(self)):
            return elementwise.compressed_add(self, other, sign=+1)
        return NotImplemented

    def __sub__(self, other):
        from ..ops import elementwise

        if isinstance(other, type(self)):
            return elementwise.compressed_add(self, other, sign=-1)
        return NotImplemented

    def __neg__(self):
        """Copy structure, negate values (csr/ops/neg.rs:5-18)."""
        return self.with_values(-self._values)

    def __pow__(self, k):
        """Matrix power ``A**k`` by binary exponentiation over the
        SpGEMM tier (each squaring's plan is cached by structure).
        ``A**0`` is the identity (scipy semantics); needs a square
        matrix and integer ``k >= 0``."""
        from ..errors import ShapeError

        if not isinstance(k, (int, np.integer)) or isinstance(k, bool):
            return NotImplemented
        if self._nrows != self._ncols:
            raise ShapeError(
                f"matrix power needs a square matrix, got {self.shape}")
        if k < 0:
            raise ValueError(f"matrix power needs k >= 0, got {k}")
        if k == 0:
            return type(self).eye(self._nrows, dtype=self._values.dtype)
        result = None
        base = self
        while k:
            if k & 1:
                result = base if result is None else result * base
            k >>= 1
            if k:
                base = base * base
        return result

    def __mul__(self, other):
        """SpGEMM for sparse*sparse (the reference's ``Mul``,
        csr/ops/mul.rs / csc/ops/mul.rs); scalar scaling for numbers."""
        if isinstance(other, type(self)):
            from ..ops import spgemm

            return spgemm.spgemm(self, other)
        if isinstance(other, (int, float)) or (
            hasattr(other, "ndim") and getattr(other, "ndim", None) == 0
        ):
            return self.with_values(self._values * other)
        return NotImplemented

    def __rmul__(self, other):
        if isinstance(other, (int, float)):
            return self.with_values(other * self._values)
        return NotImplemented

    def __matmul__(self, other):
        """``A @ x`` SpMV / ``A @ X`` SpMM for dense rhs; SpGEMM for sparse."""
        if isinstance(other, type(self)):
            from ..ops import spgemm

            return spgemm.spgemm(self, other)
        if isinstance(other, (jax.Array, np.ndarray)) or isinstance(
            other, jax.core.Tracer
        ):
            from ..ops import matvec

            return matvec.matmul_dense(self, other)
        return NotImplemented


@jax.tree_util.register_pytree_node_class
class CsrMatrix(_CompressedMatrix):
    """Compressed sparse row matrix (reference: `src/csr.rs:66-511`).

    Structure arrays: ``rowptr`` (nrows+1), ``colind`` (nse), ``values``
    (nse). Minor (column) indices are strictly increasing within each row.

    Examples
    --------
    The 4x4 example from the reference docs (`csr.rs:24-63`):

    >>> from spalinalg import CsrMatrix
    >>> m = CsrMatrix(4, 4, [0, 2, 3, 5, 6], [0, 2, 1, 2, 3, 3],
    ...               [1.0, 2.0, 3.0, 4.0, 5.0, 6.0])
    >>> m.nnz
    6
    >>> list(m)[:2]
    [(0, 0, 1.0), (0, 2, 2.0)]

    SpMV / SpGEMM / union-add on device:

    >>> import numpy as np
    >>> y = m @ np.ones(4)
    >>> np.asarray(y).tolist()
    [3.0, 3.0, 9.0, 6.0]
    >>> (m + m).nnz
    6
    >>> (m * m).shape
    (4, 4)

    Transpose and format conversion share one device engine:

    >>> m.transpose().shape
    (4, 4)
    >>> type(m.to_csc()).__name__
    'CscMatrix'
    """

    _MAJOR_AXIS = 0
    __slots__ = ()

    def __init__(self, nrows, ncols, rowptr, colind, values):
        super().__init__(nrows, ncols, rowptr, colind, values)

    @property
    def rowptr(self) -> jax.Array:
        """Row pointer array (csr.rs:228-240)."""
        return self._ptr

    @property
    def colind(self) -> jax.Array:
        """Column index array (csr.rs:242-254)."""
        return self._minor

    # ---- conversions (implementations in spalinalg.convert) ----

    @classmethod
    def from_coo(cls, coo) -> "CsrMatrix":
        from ..convert import conversions

        return conversions.coo_to_csr(coo)

    @classmethod
    def from_dok(cls, dok) -> "CsrMatrix":
        from ..convert import conversions

        return conversions.dok_to_csr(dok)

    @classmethod
    def from_csc(cls, csc) -> "CsrMatrix":
        from ..convert import conversions

        return conversions.csc_to_csr(csc)

    def to_coo(self):
        from ..convert import conversions

        return conversions.csr_to_coo(self)

    def to_dok(self):
        from ..convert import conversions

        return conversions.csr_to_dok(self)

    def to_csc(self) -> "CscMatrix":
        from ..convert import conversions

        return conversions.csr_to_csc(self)

    def to_bsr(self, blocksize):
        from .bsr import BsrMatrix

        return BsrMatrix.from_csr(self, blocksize)


@jax.tree_util.register_pytree_node_class
class CscMatrix(_CompressedMatrix):
    """Compressed sparse column matrix (reference: `src/csc.rs:66-511`).

    Structure arrays: ``colptr`` (ncols+1), ``rowind`` (nse), ``values``
    (nse). Minor (row) indices are strictly increasing within each column.
    """

    _MAJOR_AXIS = 1
    __slots__ = ()

    def __init__(self, nrows, ncols, colptr, rowind, values):
        super().__init__(nrows, ncols, colptr, rowind, values)

    @property
    def colptr(self) -> jax.Array:
        """Column pointer array (csc.rs:228-240)."""
        return self._ptr

    @property
    def rowind(self) -> jax.Array:
        """Row index array (csc.rs:242-254)."""
        return self._minor

    # ---- conversions ----

    @classmethod
    def from_coo(cls, coo) -> "CscMatrix":
        from ..convert import conversions

        return conversions.coo_to_csc(coo)

    @classmethod
    def from_dok(cls, dok) -> "CscMatrix":
        from ..convert import conversions

        return conversions.dok_to_csc(dok)

    @classmethod
    def from_csr(cls, csr) -> "CscMatrix":
        from ..convert import conversions

        return conversions.csr_to_csc(csr)

    def to_coo(self):
        from ..convert import conversions

        return conversions.csc_to_coo(self)

    def to_dok(self):
        from ..convert import conversions

        return conversions.csc_to_dok(self)

    def to_csr(self) -> "CsrMatrix":
        from ..convert import conversions

        return conversions.csc_to_csr(self)
