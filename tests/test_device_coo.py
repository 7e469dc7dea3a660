"""DeviceCoo: jit-side triplet format + in-jit conversion engine tests."""

import numpy as np

import jax

from spalinalg import CooMatrix, DeviceCoo


def test_roundtrip(rng):
    coo = CooMatrix.with_entries(4, 5, [(0, 1, 2.0), (3, 4, -1.0)])
    d = coo.to_device()
    assert isinstance(d, DeviceCoo)
    assert d.shape == (4, 5)
    assert d.nse == 2
    back = d.to_host()
    np.testing.assert_array_equal(back.to_dense(), coo.to_dense())


def test_to_csr_device_matches_host(rng):
    # dedup + zero-drop semantics must match the host conversion
    coo = CooMatrix.with_entries(4, 4, [
        (2, 2, 4.0), (0, 0, 1.0), (0, 0, 2.0), (1, 1, 0.0),
        (3, 3, 5.0), (3, 3, -5.0), (0, 2, 7.0),
    ])
    from spalinalg import CsrMatrix

    host = CsrMatrix.from_coo(coo)
    dev = coo.to_device().to_csr_device()
    assert dev.nnz == host.nnz == 3
    np.testing.assert_array_equal(np.asarray(dev.to_dense()),
                                  np.asarray(host.to_dense()))


def test_conversion_under_jit(rng):
    coo = CooMatrix.with_entries(3, 3, [(0, 0, 1.0), (2, 1, 3.0),
                                        (0, 0, 1.0)])
    d = coo.to_device()

    @jax.jit
    def f(dc):
        csr = dc.to_csr_device()
        return csr.to_dense()

    np.testing.assert_array_equal(np.asarray(f(d)), coo.to_dense())


def test_device_coo_matmul(rng):
    coo = CooMatrix.with_entries(3, 4, [(0, 1, 2.0), (2, 3, -1.0),
                                        (0, 1, 1.0)])
    d = coo.to_device()
    x = rng.normal(size=4)
    np.testing.assert_allclose(np.asarray(d @ x), coo.to_dense() @ x,
                               rtol=1e-12)
    X = rng.normal(size=(4, 6))
    np.testing.assert_allclose(np.asarray(d @ X), coo.to_dense() @ X,
                               rtol=1e-12)
