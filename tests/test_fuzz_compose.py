"""Compositional fuzz: random chains of framework ops mirrored against
scipy.sparse oracles. Catches interaction bugs no single-op test sees
(format round-trips feeding arithmetic feeding reductions...).

Seeded and deterministic — failures reproduce from the test id.
"""

import numpy as np
import pytest
import scipy.sparse as sps

from spalinalg.io import from_scipy

# each step: (name, framework_fn(mat), scipy_fn(smat))
# mat is CsrMatrix, smat is scipy csr; both stay CSR-shaped after each step
_STEPS = [
    ("transpose", lambda m: m.transpose(), lambda s: sps.csr_matrix(s.T)),
    ("to_csc_back", lambda m: m.to_csc().to_csr(), lambda s: s),
    ("to_coo_back", lambda m: type(m).from_coo(m.to_coo()), lambda s: s),
    ("neg", lambda m: -m, lambda s: -s),
    ("add_self", lambda m: m + m, lambda s: s + s),
    ("sub_half", lambda m: m - m, lambda s: s - s),
    ("square", lambda m: m * m if m.nrows == m.ncols else m,
     lambda s: s @ s if s.shape[0] == s.shape[1] else s),
    ("scale", lambda m: m * 0.5, lambda s: s * 0.5),
    ("rowslice", lambda m: __import__("spalinalg").row_slice(
        m, 0, max(1, m.nrows // 2)),
     lambda s: s[: max(1, s.shape[0] // 2)]),
]


@pytest.mark.parametrize("seed", range(8))
def test_random_op_chain(seed):
    rng = np.random.default_rng(1000 + seed)
    n = int(rng.integers(6, 20))
    d = np.where(rng.random((n, n)) < 0.3, rng.normal(size=(n, n)), 0)
    mat = from_scipy(sps.csr_matrix(d))
    smat = sps.csr_matrix(d)

    chain = rng.choice(len(_STEPS), size=5)
    trace = []
    for si in chain:
        name, ffn, sfn = _STEPS[si]
        trace.append(name)
        mat = ffn(mat)
        smat = sfn(smat)
        got = np.asarray(mat.to_dense())
        ref = smat.toarray()
        np.testing.assert_allclose(
            got, ref, atol=1e-8,
            err_msg=f"diverged after chain {trace} (seed {seed})")


@pytest.mark.parametrize("seed", range(4))
def test_spgemm_chain_vs_scipy(seed):
    """Repeated products with mixed transposes — plan-cache stress."""
    rng = np.random.default_rng(2000 + seed)
    n = int(rng.integers(8, 24))
    d1 = np.where(rng.random((n, n)) < 0.25, rng.normal(size=(n, n)), 0)
    d2 = np.where(rng.random((n, n)) < 0.25, rng.normal(size=(n, n)), 0)
    a, b = from_scipy(sps.csr_matrix(d1)), from_scipy(sps.csr_matrix(d2))
    got = np.asarray((a * b * a.transpose() + b).to_dense())
    ref = (d1 @ d2 @ d1.T) + d2
    np.testing.assert_allclose(got, ref, atol=1e-7)


@pytest.mark.parametrize("seed", range(4))
def test_solver_roundtrip_fuzz(seed):
    """spsolve(A, A @ x) == x for random diagonally-dominant systems."""
    from spalinalg.linalg import spsolve

    rng = np.random.default_rng(3000 + seed)
    n = int(rng.integers(10, 40))
    d = np.where(rng.random((n, n)) < 0.3, rng.normal(size=(n, n)), 0)
    d += np.eye(n) * (np.abs(d).sum(axis=1).max() + 1.0)
    A = from_scipy(sps.csr_matrix(d))
    x_true = rng.normal(size=n)
    x = np.asarray(spsolve(A, d @ x_true))
    np.testing.assert_allclose(x, x_true, atol=1e-6)
