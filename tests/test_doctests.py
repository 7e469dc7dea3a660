"""Run the docstring examples — the reference's doctest surface (~75
rustdoc examples run by ``cargo test --doc``, `x.sh:8`). These double as
API-regression tests. Every public module with a user-facing API carries
examples."""

import doctest
import importlib

import pytest

# importlib (not attribute access): `spalinalg.linalg.cg` the *module*
# is shadowed by the re-exported `cg` *function* in linalg/__init__.py.
MODULE_NAMES = [
    "spalinalg.config",
    "spalinalg.formats.bsr",
    "spalinalg.formats.compressed",
    "spalinalg.formats.coo",
    "spalinalg.formats.device",
    "spalinalg.formats.dia",
    "spalinalg.formats.dok",
    "spalinalg.io.checkpoint",
    "spalinalg.io.jax_interop",
    "spalinalg.io.matrix_market",
    "spalinalg.io.scipy_interop",
    "spalinalg.linalg.cg",
    "spalinalg.linalg.iterative",
    "spalinalg.linalg.cholesky",
    "spalinalg.linalg.eigen",
    "spalinalg.linalg.funm",
    "spalinalg.linalg.lu",
    "spalinalg.linalg.precond",
    "spalinalg.linalg.qr",
    "spalinalg.linalg.solve",
    "spalinalg.linalg.triangular",
    "spalinalg.ops.elementwise",
    "spalinalg.ops.indexing",
    "spalinalg.ops.reduce_api",
    "spalinalg.ops.spgemm",
    "spalinalg.ops.construct",
    "spalinalg.ops.structure",
    "spalinalg.parallel.partition",
    "spalinalg.utils.metrics",
]

MODULES = [importlib.import_module(n) for n in MODULE_NAMES]


@pytest.mark.parametrize("mod", MODULES, ids=lambda m: m.__name__)
def test_doctests(mod):
    results = doctest.testmod(mod, verbose=False)
    assert results.failed == 0, f"{results.failed} doctest failures in {mod.__name__}"
    assert results.attempted > 0, f"no doctests collected in {mod.__name__}"
