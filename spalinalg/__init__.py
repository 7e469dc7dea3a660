"""spalinalg — a sparse linear-algebra framework on JAX.

A from-scratch JAX/XLA/Pallas framework with the capabilities of the Rust
reference library ``lokyhark/spalinalg`` (storage formats COO/DOK/CSR/CSC,
the full conversion graph, transpose, add/sub/neg, SpGEMM) extended with an
accelerator ops tier: BSR, SpMV, SpMM, sparse Cholesky/LU with triangular
solve, iterative solvers, and multi-chip row-partitioned execution over
``jax.sharding`` meshes.

Design stance (SURVEY.md §7): builder formats (COO, DOK) live on the host;
compute formats (CSR, CSC, BSR) are pytrees of device arrays; every
structure-changing operation is one sort/segment engine; numeric hot paths
are gather pipelines planned host-side per structure.

f64 note: the reference's scalar set is f32/f64 (`scalar.rs:56-57`); both
run natively on CPUs and GPUs. x64 is enabled at import unless
``SPALINALG_NO_X64=1``.
"""

from __future__ import annotations

import os as _os

import jax as _jax

if not _os.environ.get("SPALINALG_NO_X64"):
    _jax.config.update("jax_enable_x64", True)

from .config import Config, default_config  # noqa: E402
from .errors import (  # noqa: E402
    DTypeError,
    IndexError_,
    ShapeError,
    SpalinalgError,
    StructureError,
)
from .formats.coo import CooMatrix  # noqa: E402
from .formats.dok import DokMatrix  # noqa: E402
from .formats.compressed import CscMatrix, CsrMatrix  # noqa: E402
from .formats.bsr import BsrMatrix  # noqa: E402
from .formats.device import DeviceCoo  # noqa: E402
from .formats.dia import DiaMatrix  # noqa: E402
from .ops.matvec import csr_matvec, csr_matmat, csc_matvec, csc_matmat  # noqa: E402
from .ops.spgemm import spgemm, spgemm_plan, spgemm_apply, SpgemmPlan  # noqa: E402
from .ops.structure import (bmat, block_diag, hstack, kron,  # noqa: E402
                            tril, triu, vstack)
from .ops.construct import diags, sprandom  # noqa: E402
from .ops.reduce_api import diagonal, mat_mean, mat_sum, multiply, norm  # noqa: E402
from .ops.indexing import getcol, getrow, row_slice, select_cols, select_rows, submatrix  # noqa: E402
from . import linalg  # noqa: E402
from . import io  # noqa: E402
from . import utils  # noqa: E402

__version__ = "0.1.0"

__all__ = [
    "DiaMatrix",
    "kron", "hstack", "vstack", "block_diag", "bmat", "tril", "triu",
    "diags", "sprandom",
    "mat_sum", "mat_mean", "diagonal", "multiply", "norm",
    "row_slice", "select_rows", "select_cols", "submatrix", "getrow", "getcol",
    "CooMatrix",
    "DokMatrix",
    "CsrMatrix",
    "CscMatrix",
    "BsrMatrix",
    "DeviceCoo",
    "Config",
    "default_config",
    "SpalinalgError",
    "ShapeError",
    "IndexError_",
    "StructureError",
    "DTypeError",
    "csr_matvec",
    "csr_matmat",
    "csc_matvec",
    "csc_matmat",
    "spgemm",
    "spgemm_plan",
    "spgemm_apply",
    "SpgemmPlan",
    "__version__",
]
