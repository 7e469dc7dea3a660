"""Scalar tier: supported dtypes and promotion rules.

Counterpart of the reference's ``Scalar`` trait family (`scalar.rs:8-57`):
``Zero`` / ``One`` / ``Ops`` / ``Scalar`` implemented for ``f32`` and
``f64``. Here the same contract is a closed set of value dtypes plus an
index dtype policy:

- value dtypes: ``float32``, ``float64`` (f64 requires ``jax_enable_x64``),
  plus the extension ``bfloat16`` for block storage (BSR), accumulated in
  f32.
- index dtype: ``int32`` everywhere on device (half the index bytes of
  i64; matrices beyond 2^31 nnz are handled by partitioning, not by wider
  indices).
"""

from __future__ import annotations

import numpy as np

import jax.numpy as jnp

from .errors import DTypeError

# The closed scalar set (reference: `scalar.rs:56-57` impls for f32/f64;
# bfloat16 is an extension for block storage).
VALUE_DTYPES = (jnp.float32, jnp.float64, jnp.bfloat16)

INDEX_DTYPE = jnp.int32

_VALUE_DTYPE_NAMES = {np.dtype(d).name for d in ("float32", "float64")} | {
    "bfloat16"
}


def canonical_value_dtype(dtype) -> np.dtype:
    """Validate and canonicalise a value dtype.

    Raises :class:`DTypeError` for anything outside the supported scalar set,
    mirroring the closed ``Scalar`` trait in `scalar.rs:55-57`.
    """
    d = jnp.dtype(dtype)
    if d.name not in _VALUE_DTYPE_NAMES:
        raise DTypeError(
            f"unsupported value dtype {d.name!r}: spalinalg supports "
            f"float32, float64 and bfloat16 (reference scalar set is f32/f64)"
        )
    return d


def zero(dtype):
    """``Zero::zero()`` (`scalar.rs:8-22`)."""
    return jnp.zeros((), dtype=canonical_value_dtype(dtype))


def one(dtype):
    """``One::one()`` (`scalar.rs:24-38`)."""
    return jnp.ones((), dtype=canonical_value_dtype(dtype))


def result_dtype(*dtypes):
    """Promotion rule for mixed-dtype ops: follow jnp promotion within the
    supported set."""
    out = jnp.result_type(*dtypes)
    return canonical_value_dtype(out)
