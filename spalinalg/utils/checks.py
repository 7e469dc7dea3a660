"""In-jit safety checks (aux subsystem, SURVEY.md §5 "race detection /
sanitizers").

JAX's functional purity is the structural race-freedom story; what remains
is index validity *inside* compiled code, where Python validation can't
reach. These helpers wrap compute in ``jax.experimental.checkify`` so
out-of-range structure indices surface as errors instead of silent clamps,
plus a determinism audit for reductions.
"""

from __future__ import annotations

from typing import Callable

import jax
import jax.numpy as jnp
from jax.experimental import checkify

__all__ = ["checked_structure", "checked_call", "determinism_audit"]


def checked_structure(mat) -> Callable:
    """Return a checkify-wrapped callable validating ``mat``'s device
    structure: pointer monotonicity, index ranges, padding discipline.

    Usage::

        err = checked_structure(csr)()
        err.throw()   # raises with a message if the structure is corrupt
    """

    ptr, minor = mat._ptr, mat._minor
    n_major = type(mat)._major_dim(mat.nrows, mat.ncols)
    n_minor = type(mat)._minor_dim(mat.nrows, mat.ncols)

    def check():
        checkify.check(jnp.all(jnp.diff(ptr) >= 0),
                       "ptr must be monotone non-decreasing")
        checkify.check(ptr[0] == 0, "ptr[0] must be 0")
        checkify.check(ptr[-1] <= minor.shape[0],
                       "nnz exceeds stored-element capacity")
        live = jnp.arange(minor.shape[0]) < ptr[-1]
        ok = jnp.where(live, (minor >= 0) & (minor < n_minor), True)
        checkify.check(jnp.all(ok), "minor index out of range")
        checkify.check(ptr.shape[0] == n_major + 1, "ptr length mismatch")
        return jnp.zeros(())

    return lambda: checkify.checkify(check)()[0]


def checked_call(fn, *args):
    """Run ``fn(*args)`` under checkify; returns ``(err, out)``."""
    return checkify.checkify(fn)(*args)


def determinism_audit(fn, *args, repeats: int = 3) -> bool:
    """Re-run a compiled reduction and verify bitwise-identical results —
    the determinism contract our sorted segment reductions rely on."""
    import numpy as np

    first = np.asarray(fn(*args))
    for _ in range(repeats - 1):
        if not np.array_equal(np.asarray(fn(*args)), first):
            return False
    return True
