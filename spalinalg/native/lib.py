"""ctypes bindings for the native host-kernel library.

Builds ``libspalinalg_host-<hash>.so`` on first use (g++, no external
deps) and exposes the symbolic-phase accelerators. The file name carries
a hash of ``src/host_kernels.cpp``, so a library built from other source
is never loaded; the build targets the generic x86-64/aarch64 ISA, so a
library copied with the checkout to another host still runs there. Every
caller has a NumPy fallback: ``available()`` gating keeps the package
fully functional without a toolchain.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import Optional

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "src", "host_kernels.cpp")
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False

_I64 = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
_F64 = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")


def so_path() -> str:
    """Library path keyed by the hash of the source it is built from."""
    with open(_SRC, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    return os.path.join(_DIR, f"libspalinalg_host-{digest}.so")


def _build(so: str) -> bool:
    tmp = f"{so}.tmp{os.getpid()}"
    try:
        subprocess.run(
            ["g++", "-O3", "-fPIC", "-std=c++17", "-shared", "-o", tmp,
             _SRC],
            check=True, capture_output=True, timeout=120,
        )
        os.replace(tmp, so)  # atomic: a concurrent loader never sees half
        return True
    except (OSError, subprocess.SubprocessError):
        return False


def get() -> Optional[ctypes.CDLL]:
    """Load (building if needed) the native library, or None."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        try:
            so = so_path()
        except OSError:
            return None
        if not os.path.exists(so) and not _build(so):
            return None
        try:
            lib = ctypes.CDLL(so)
        except OSError:
            return None

        lib.spal_compress.restype = ctypes.c_int64
        lib.spal_compress.argtypes = [
            _I64, _I64, _F64, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int32, ctypes.c_int32, _I64, _I64, _F64,
        ]
        lib.spal_rcm.restype = None
        lib.spal_rcm.argtypes = [_I64, _I64, ctypes.c_int64, _I64]
        lib.spal_level_schedule.restype = ctypes.c_int64
        lib.spal_level_schedule.argtypes = [
            _I64, _I64, ctypes.c_int64, ctypes.c_int32, _I64,
        ]
        lib.spal_spgemm_symbolic.restype = ctypes.c_int64
        lib.spal_spgemm_symbolic.argtypes = [
            _I64, _I64, ctypes.c_int64, _I64, _I64, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p,
        ]
        lib.spal_etree.restype = None
        lib.spal_etree.argtypes = [_I64, _I64, ctypes.c_int64, _I64]
        lib.spal_chol_symbolic.restype = ctypes.c_int64
        lib.spal_chol_symbolic.argtypes = [
            _I64, _I64, ctypes.c_int64, _I64, _I64, _I64, _I64,
            ctypes.c_void_p,
        ]
        lib.spal_amd.restype = None
        lib.spal_amd.argtypes = [_I64, _I64, ctypes.c_int64, _I64]
        lib.spal_ilu0.restype = ctypes.c_int64
        lib.spal_ilu0.argtypes = [_I64, _I64, _F64, ctypes.c_int64]
        lib.spal_ic0.restype = ctypes.c_int64
        lib.spal_ic0.argtypes = [_I64, _I64, _F64, ctypes.c_int64]
        _lib = lib
        return _lib


def available() -> bool:
    return get() is not None


# ----------------------------------------------------------------------
# High-level wrappers (NumPy in, NumPy out)
# ----------------------------------------------------------------------


def compress(major, minor, values, n_major, *, dedup, drop_zeros):
    """Native counterpart of ``convert.engine.compress_host`` (f64 values)."""
    lib = get()
    assert lib is not None
    major = np.ascontiguousarray(major, dtype=np.int64)
    minor = np.ascontiguousarray(minor, dtype=np.int64)
    values = np.ascontiguousarray(values, dtype=np.float64)
    nnz = major.size
    ptr = np.zeros(n_major + 1, dtype=np.int64)
    out_minor = np.empty(max(nnz, 1), dtype=np.int64)
    out_values = np.empty(max(nnz, 1), dtype=np.float64)
    w = lib.spal_compress(major, minor, values, nnz, n_major,
                          int(dedup), int(drop_zeros),
                          ptr, out_minor, out_values)
    return ptr, out_minor[:w].copy(), out_values[:w].copy()


def rcm(ptr, ind, n):
    lib = get()
    assert lib is not None
    ptr = np.ascontiguousarray(ptr, dtype=np.int64)
    ind = np.ascontiguousarray(ind, dtype=np.int64)
    perm = np.empty(n, dtype=np.int64)
    lib.spal_rcm(ptr, ind, n, perm)
    return perm


def level_schedule(ptr, ind, n, *, lower):
    lib = get()
    assert lib is not None
    ptr = np.ascontiguousarray(ptr, dtype=np.int64)
    ind = np.ascontiguousarray(ind, dtype=np.int64)
    lev = np.zeros(n, dtype=np.int64)
    n_levels = lib.spal_level_schedule(ptr, ind, n, int(lower), lev)
    return int(n_levels), lev


def spgemm_symbolic(aptr, acol, nrows_a, bptr, bcol, ncols_b):
    """Returns (a_idx, b_idx, gid, out_rowptr, out_colind)."""
    lib = get()
    assert lib is not None
    aptr = np.ascontiguousarray(aptr, dtype=np.int64)
    acol = np.ascontiguousarray(acol, dtype=np.int64)
    bptr = np.ascontiguousarray(bptr, dtype=np.int64)
    bcol = np.ascontiguousarray(bcol, dtype=np.int64)
    total = lib.spal_spgemm_symbolic(aptr, acol, nrows_a, bptr, bcol,
                                     ncols_b, None, None, None, None, None)
    a_idx = np.empty(max(total, 1), dtype=np.int64)
    b_idx = np.empty(max(total, 1), dtype=np.int64)
    gid = np.empty(max(total, 1), dtype=np.int64)
    out_rowptr = np.zeros(nrows_a + 1, dtype=np.int64)
    out_colind = np.empty(max(total, 1), dtype=np.int64)
    pv = lambda a: a.ctypes.data_as(ctypes.c_void_p)
    n_out = lib.spal_spgemm_symbolic(
        aptr, acol, nrows_a, bptr, bcol, ncols_b,
        pv(a_idx), pv(b_idx), pv(gid), pv(out_rowptr), pv(out_colind),
    )
    return (a_idx[:total], b_idx[:total], gid[:total], out_rowptr,
            out_colind[:n_out].copy())


def etree(ptr, ind, n):
    lib = get()
    assert lib is not None
    ptr = np.ascontiguousarray(ptr, dtype=np.int64)
    ind = np.ascontiguousarray(ind, dtype=np.int64)
    parent = np.empty(n, dtype=np.int64)
    lib.spal_etree(ptr, ind, n, parent)
    return parent


def chol_symbolic(ptr, ind, n):
    """Supernodal symbolic phase on a POSTORDERED symmetric structure.

    Returns (parent, snode_ptr, rows_ptr, rows_idx): supernode column
    boundaries plus the concatenated per-supernode row structures."""
    lib = get()
    assert lib is not None
    ptr = np.ascontiguousarray(ptr, dtype=np.int64)
    ind = np.ascontiguousarray(ind, dtype=np.int64)
    parent = np.empty(max(n, 1), dtype=np.int64)
    nsn_out = np.zeros(1, dtype=np.int64)
    snode_ptr = np.zeros(n + 1, dtype=np.int64)
    rows_ptr = np.zeros(n + 1, dtype=np.int64)
    total = lib.spal_chol_symbolic(ptr, ind, n, parent, nsn_out,
                                   snode_ptr, rows_ptr, None)
    rows_idx = np.empty(max(total, 1), dtype=np.int64)
    lib.spal_chol_symbolic(ptr, ind, n, parent, nsn_out, snode_ptr,
                           rows_ptr,
                           rows_idx.ctypes.data_as(ctypes.c_void_p))
    nsn = int(nsn_out[0])
    return (parent, snode_ptr[: nsn + 1].copy(),
            rows_ptr[: nsn + 1].copy(), rows_idx[:total])


def amd(ptr, ind, n):
    lib = get()
    assert lib is not None
    ptr = np.ascontiguousarray(ptr, dtype=np.int64)
    ind = np.ascontiguousarray(ind, dtype=np.int64)
    perm = np.empty(n, dtype=np.int64)
    lib.spal_amd(ptr, ind, n, perm)
    return perm


def ilu0_values(ptr, ind, values, n):
    """In-place-style ILU(0) numeric sweep; returns (values, bad_row)."""
    lib = get()
    assert lib is not None
    ptr = np.ascontiguousarray(ptr, dtype=np.int64)
    ind = np.ascontiguousarray(ind, dtype=np.int64)
    values = np.array(values, dtype=np.float64, copy=True, order="C")
    bad = int(lib.spal_ilu0(ptr, ind, values, int(n)))
    return values, bad


def ic0_values(lptr, lind, lvalues, n):
    """IC(0) numeric sweep on the lower pattern; (values, bad_row)."""
    lib = get()
    assert lib is not None
    lptr = np.ascontiguousarray(lptr, dtype=np.int64)
    lind = np.ascontiguousarray(lind, dtype=np.int64)
    lvalues = np.array(lvalues, dtype=np.float64, copy=True, order="C")
    bad = int(lib.spal_ic0(lptr, lind, lvalues, int(n)))
    return lvalues, bad
