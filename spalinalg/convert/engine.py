"""The conversion engine: one sort/segment pipeline for every format change.

The reference implements 12 directed conversions with bespoke counting-sort
pipelines (`src/csr/conv/*`, `src/csc/conv/*`, `src/coo.rs:629-749`,
`src/dok.rs:640-775`) and a 2-pass counting-sort ``transpose``
(`csr.rs:358-406`) that every L3 op calls three times.

This design collapses all of that into ONE engine:

    lexsort by (major, minor)  →  [duplicate merge via segment ids]
                               →  [explicit-zero drop via re-sort]
                               →  ptr = searchsorted(major, arange)

- **Host path** (NumPy): exact output sizes; used by the eager constructor
  API (``CsrMatrix.from_coo`` etc.) where the reference also does host work.
- **Device path** (jnp, jit-able): static-shape padded output. Padding slots
  carry the sentinel ``major == nrows`` so they sort to the end and never
  appear under ``ptr[-1]``; their indices are clamped in-range and their
  values are zero so gathers stay safe and contribute nothing.

Transpose is the same engine keyed the other way — the reference's
"transpose sandwich" (SURVEY.md §3.4) disappears because sorted output is a
*construction invariant* here, not something re-established by transposes.

Reference-semantic switches (SURVEY.md §2.1 invariants):
- COO→CSR/CSC: ``dedup=True, drop_zeros=True`` (`csr/conv/coo.rs:37-74`)
- DOK→CSR/CSC: ``dedup=False, drop_zeros=False`` (`csr/conv/dok.rs:4-85`)
- CSR↔CSC / transpose: ``dedup=False, drop_zeros=False`` (`csr/conv/csc.rs`)
- add/sub union merge: ``dedup=True, drop_zeros=False`` (cancelled entries
  stay as explicit zeros, `csr/ops/add.rs:31-56`)
"""

from __future__ import annotations

from functools import partial
from typing import Tuple

import numpy as np

import jax
import jax.numpy as jnp

from ..dtypes import INDEX_DTYPE

__all__ = [
    "compress_host",
    "compress_device",
    "expand_ptr_host",
    "major_ids_device",
    "ptr_from_major_device",
]


# ======================================================================
# Host path (exact sizes; NumPy)
# ======================================================================


def compress_host(
    major: np.ndarray,
    minor: np.ndarray,
    values: np.ndarray,
    n_major: int,
    *,
    dedup: bool,
    drop_zeros: bool,
    sum_duplicates: bool = True,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Sort triplets by (major, minor) and compress to (ptr, minor, values).

    Returns exact-size arrays: ``ptr`` (``n_major + 1``, int64 host), sorted
    ``minor`` and ``values``. With ``dedup`` duplicates are summed (the
    reference's last-seen-pointer merge, `csr/conv/coo.rs:37-58`); with
    ``drop_zeros`` exact numeric zeros are removed (`csr/conv/coo.rs:61-74`).
    """
    major = np.asarray(major, dtype=np.int64)
    minor = np.asarray(minor, dtype=np.int64)
    values = np.asarray(values)

    # Native fast path (f64 values, summing semantics): C++ sort+merge.
    if sum_duplicates and values.dtype == np.float64 and major.size > 4096:
        from ..native import lib as _native

        if _native.available():
            return _native.compress(
                major, minor, values, n_major,
                dedup=dedup, drop_zeros=drop_zeros,
            )

    order = np.lexsort((minor, major))
    major, minor, values = major[order], minor[order], values[order]

    if dedup and major.size:
        is_new = np.empty(major.size, dtype=bool)
        is_new[0] = True
        is_new[1:] = (major[1:] != major[:-1]) | (minor[1:] != minor[:-1])
        gid = np.cumsum(is_new) - 1
        n_groups = int(gid[-1]) + 1
        if sum_duplicates:
            summed = np.zeros(n_groups, dtype=values.dtype)
            np.add.at(summed, gid, values)
        else:
            # last-write-wins (DOK insert semantics)
            summed = np.empty(n_groups, dtype=values.dtype)
            summed[gid] = values
        major, minor, values = major[is_new], minor[is_new], summed

    if drop_zeros:
        keep = values != 0
        major, minor, values = major[keep], minor[keep], values[keep]

    ptr = np.zeros(n_major + 1, dtype=np.int64)
    np.add.at(ptr, major + 1, 1)
    np.cumsum(ptr, out=ptr)
    return ptr, minor, values


def expand_ptr_host(ptr: np.ndarray) -> np.ndarray:
    """Expand a compressed pointer into per-entry major ids (host)."""
    ptr = np.asarray(ptr, dtype=np.int64)
    return np.repeat(np.arange(ptr.size - 1, dtype=np.int64), np.diff(ptr))


# ======================================================================
# Device path (static shapes; jit-able)
# ======================================================================
#
# Convention: triplet arrays have static length ``nse``. A slot is padding
# iff ``major == n_major`` (one-past-the-end sentinel). Padding sorts last;
# ``ptr[n_major]`` (== searchsorted position of the sentinel) equals the true
# nnz as a device scalar.


def major_ids_device(ptr: jax.Array, nse: int) -> jax.Array:
    """Per-entry major ids from a device pointer array.

    Positions at or beyond ``ptr[-1]`` (padding) map to the sentinel
    ``n_major``. Equivalent of the reference's implicit row loop when
    iterating CSR (`csr.rs:303-328`), vectorised as a searchsorted.
    """
    # method="sort" lowers to one fused sort over the needles, in place of
    # one binary search per needle.
    pos = jnp.arange(nse, dtype=INDEX_DTYPE)
    return (
        jnp.searchsorted(ptr, pos, side="right", method="sort") - 1
    ).astype(INDEX_DTYPE)


def ptr_from_major_device(major_sorted: jax.Array, n_major: int) -> jax.Array:
    """``ptr[i] = #entries with major < i`` over sorted majors (with sentinel
    padding at the end). ``ptr[n_major]`` = true nnz."""
    targets = jnp.arange(n_major + 1, dtype=major_sorted.dtype)
    return jnp.searchsorted(
        major_sorted, targets, side="left", method="sort"
    ).astype(INDEX_DTYPE)


def _sort_triplets(major, minor, values, n_major, n_minor):
    """Stable lexsort of triplets by (major, minor).

    When the fused (major, minor) key fits in int32 a single key sort is
    used (one XLA sort beats two); otherwise two stable passes. Sentinel
    padding (major == n_major) sorts to the end by construction.
    """
    if (n_major + 1) * (n_minor + 1) < 2**31:
        key = major.astype(jnp.int32) * jnp.int32(n_minor + 1) + minor.astype(
            jnp.int32
        )
        order = jnp.argsort(key, stable=True)
    else:
        order = jnp.argsort(minor, stable=True)
        order = order[jnp.argsort(major[order], stable=True)]
    return major[order], minor[order], values[order]


@partial(jax.jit, static_argnames=("n_major", "n_minor", "dedup", "drop_zeros"))
def compress_device(
    major: jax.Array,
    minor: jax.Array,
    values: jax.Array,
    *,
    n_major: int,
    n_minor: int,
    dedup: bool,
    drop_zeros: bool,
):
    """Device-side compress: returns ``(ptr, minor, values)`` with static
    shapes (``nse`` preserved; merged/dropped slots become sentinel padding).

    This is the jit-able core behind every conversion and the add/sub union
    merge. ``ptr`` has length ``n_major + 1``; ``ptr[-1]`` is the true nnz.
    """
    nse = major.shape[0]
    if nse == 0:
        return (
            jnp.zeros(n_major + 1, dtype=INDEX_DTYPE),
            minor.astype(INDEX_DTYPE),
            values,
        )

    major = major.astype(INDEX_DTYPE)
    minor = minor.astype(INDEX_DTYPE)
    major, minor, values = _sort_triplets(major, minor, values, n_major, n_minor)

    if dedup:
        prev_major = jnp.concatenate([major[:1] - 1, major[:-1]])
        prev_minor = jnp.concatenate([minor[:1] - 1, minor[:-1]])
        is_new = (major != prev_major) | (minor != prev_minor)
        # Padding slots are all (n_major, minor_sentinel): they collapse into
        # one group whose sum is 0 — then we re-mark them as padding below.
        gid = jnp.cumsum(is_new.astype(INDEX_DTYPE)) - 1
        summed = jax.ops.segment_sum(
            values, gid, num_segments=nse, indices_are_sorted=True
        ).astype(values.dtype)
        # Representative (major, minor) per group: scatter first occurrence.
        rep_major = jnp.full((nse,), n_major, dtype=INDEX_DTYPE).at[gid].set(major)
        rep_minor = jnp.zeros((nse,), dtype=INDEX_DTYPE).at[gid].set(minor)
        n_groups = gid[-1] + 1
        slot = jnp.arange(nse, dtype=INDEX_DTYPE)
        live = slot < n_groups
        major = jnp.where(live, rep_major, n_major)
        minor = jnp.where(live, rep_minor, 0)
        values = jnp.where(live, summed, jnp.zeros((), values.dtype))
        # Groups are in sorted slot order already — no re-sort needed.

    if drop_zeros:
        drop = (values == 0) | (major >= n_major)
        major = jnp.where(drop, n_major, major)
        minor = jnp.where(drop, 0, minor)
        # Compact: stable re-sort pushes dropped slots (sentinel) to the end.
        major, minor, values = _sort_triplets(major, minor, values, n_major, n_minor)
        values = jnp.where(major >= n_major, jnp.zeros((), values.dtype), values)

    ptr = ptr_from_major_device(major, n_major)
    return ptr, minor, values


@partial(jax.jit, static_argnames=("n_major", "n_minor"))
def transpose_compressed_device(ptr, minor, values, *, n_major, n_minor):
    """Transpose a compressed structure on device: re-key the same entries by
    (minor, major) and rebuild the pointer. Replaces the reference's 2-pass
    counting sort (`csr.rs:358-406`) with the sort engine."""
    nse = minor.shape[0]
    major = major_ids_device(ptr, nse)
    pad = major >= n_major
    new_major = jnp.where(pad, n_minor, minor.astype(INDEX_DTYPE))
    new_minor = jnp.where(pad, 0, major)
    new_major, new_minor, new_values = _sort_triplets(
        new_major, new_minor, values, n_minor, n_major
    )
    new_ptr = ptr_from_major_device(new_major, n_minor)
    return new_ptr, new_minor, new_values
