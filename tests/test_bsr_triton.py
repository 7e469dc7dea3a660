"""BSR products: the Triton SpMV kernel (interpret mode on the CPU), the
XLA formulation, the choice between them, and the kernel's gradient
rule.

The compiled kernel exists only on a GPU; ``test_triton_compiled_on_gpu``
carries the ``gpu`` marker and skips elsewhere."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from spalinalg import BsrMatrix
from spalinalg.ops import bsr_ops
from spalinalg.ops.kernels.bsr_triton import (bsr_matvec_call,
                                              triton_eligible)


def _case(rng, nbr, bs, *, band=1, skip=None, ncols_blocks=None,
          dtype=np.float32):
    """Block-banded BSR; ``skip(i, j)`` drops blocks (empty rows etc.)."""
    nbc = ncols_blocks or nbr
    indptr, indices = [0], []
    for i in range(nbr):
        indices.extend(j for j in range(i - band, i + band + 1)
                       if 0 <= j < nbc and not (skip and skip(i, j)))
        indptr.append(len(indices))
    data = rng.normal(size=(len(indices), bs, bs)).astype(dtype)
    bsr = BsrMatrix(nbr * bs, nbc * bs, bs, np.asarray(indptr),
                    np.asarray(indices, dtype=np.int64), data)
    dense = np.zeros((nbr * bs, nbc * bs))
    rows = np.repeat(np.arange(nbr), np.diff(indptr))
    for k, (r, c) in enumerate(zip(rows, indices)):
        dense[r * bs:(r + 1) * bs, c * bs:(c + 1) * bs] += data[k]
    return bsr, dense


def _kernel_mv(bsr, x):
    return bsr_matvec_call(bsr.indptr, bsr.indices, bsr.data,
                           jnp.asarray(x), nbr=bsr.nrows // bsr.blocksize[0],
                           interpret=True)


SHAPES = [
    dict(nbr=3, bs=16),                        # band of 8 rows, padded
    dict(nbr=10, bs=32),                       # band 4, nbr not a multiple
    dict(nbr=2, bs=128),                       # bench block size
    dict(nbr=6, bs=16, skip=lambda i, j: i % 3 == 0),   # empty block rows
    dict(nbr=4, bs=16, band=3, ncols_blocks=9),          # wide operand
]


@pytest.mark.parametrize("shape", SHAPES, ids=range(len(SHAPES)))
def test_kernel_spmv_interpret(rng, shape):
    bsr, dense = _case(rng, **shape)
    x = rng.normal(size=dense.shape[1]).astype(np.float32)
    y = np.asarray(_kernel_mv(bsr, x))
    assert y.dtype == np.float32 and y.shape == (dense.shape[0],)
    np.testing.assert_allclose(y, dense @ x, rtol=1e-5,
                               atol=1e-5 * np.abs(dense @ x).max())


@pytest.mark.parametrize("K", [1, 20, 64, 130])
def test_spmm_matches_dense(rng, K):
    """SpMM (XLA on every backend), empty block rows included."""
    bsr, dense = _case(rng, 5, 16, skip=lambda i, j: i == 2)
    X = rng.normal(size=(dense.shape[1], K)).astype(np.float32)
    Y = np.asarray(bsr @ jnp.asarray(X))
    assert Y.shape == (dense.shape[0], K)
    ref = dense @ X
    np.testing.assert_allclose(Y, ref, rtol=1e-5,
                               atol=1e-5 * np.abs(ref).max())


@pytest.mark.parametrize("x_dtype", [jnp.float32, jnp.bfloat16])
def test_kernel_bf16_storage(rng, x_dtype):
    """bf16 blocks, f32 accumulation."""
    bsr, _ = _case(rng, 4, 16)
    b16 = bsr.astype(jnp.bfloat16)
    dense = np.asarray(b16.to_dense().astype(jnp.float32), np.float64)
    x = jnp.asarray(rng.normal(size=dense.shape[1])).astype(x_dtype)
    xr = np.asarray(x.astype(jnp.float32), np.float64)
    got, ref = _kernel_mv(b16, x), dense @ xr
    assert got.dtype == jnp.float32
    np.testing.assert_allclose(np.asarray(got), ref, rtol=1e-5,
                               atol=1e-5 * np.abs(ref).max())


def test_block_row_reduction_is_unsorted():
    """The XLA path's block-row scatter must not claim sorted indices:
    on a GPU that selects a scatter holding a whole (br, K) window per
    thread, whose launch runs out of memory for SpMM at br=128, K=64."""
    indptr = jnp.asarray([0, 2, 3])
    indices = jnp.asarray([0, 1, 1])
    data = jnp.ones((3, 16, 16), jnp.float32)
    X = jnp.ones((32, 64), jnp.float32)
    jaxpr = str(jax.make_jaxpr(lambda X: bsr_ops._xla_matmat(
        indptr, indices, data, X, nbr=2))(X))
    assert "scatter-add" in jaxpr or "scatter_add" in jaxpr
    assert "indices_are_sorted=True" not in jaxpr


@pytest.mark.parametrize("dtype,tol", [(np.float32, 1e-5),
                                       (np.float64, 1e-12)])
@pytest.mark.parametrize("bs", [8, 128])
def test_xla_path_matches_dense(rng, dtype, tol, bs):
    bsr, dense = _case(rng, 3, bs, band=2, dtype=dtype)
    x = rng.normal(size=dense.shape[1]).astype(dtype)
    X = rng.normal(size=(dense.shape[1], 3)).astype(dtype)
    y = np.asarray(bsr @ jnp.asarray(x))
    Y = np.asarray(bsr @ jnp.asarray(X))
    assert y.dtype == dtype and Y.dtype == dtype
    np.testing.assert_allclose(y, dense @ x,
                               atol=tol * np.abs(dense @ x).max())
    np.testing.assert_allclose(Y, dense @ X,
                               atol=tol * np.abs(dense @ X).max())


def test_triton_eligible_shapes():
    assert triton_eligible((128, 128), jnp.float32)
    assert triton_eligible((16, 32), jnp.bfloat16)
    assert not triton_eligible((8, 8), jnp.float32)       # below 16
    assert not triton_eligible((24, 24), jnp.float32)     # not pow2
    assert not triton_eligible((128, 128), jnp.float64)   # f64: XLA


@pytest.mark.parametrize("backend,bs,dtype,ndim,expect", [
    ("cpu", 128, np.float32, 1, "xla"),
    ("gpu", 128, np.float32, 2, "xla"),         # SpMM: XLA on the GPU
    ("gpu", 128, "bf16", 2, "xla"),
    ("gpu", 128, np.float32, 1, "triton"),
    ("gpu", 128, "bf16", 1, "triton"),
    ("gpu", 128, np.float64, 1, "xla"),
    ("gpu", 8, np.float32, 1, "xla"),
])
def test_bsr_path_choice(rng, monkeypatch, backend, bs, dtype, ndim,
                         expect):
    bsr, _ = _case(rng, 2, bs, dtype=np.float64 if dtype is np.float64
                   else np.float32)
    if dtype == "bf16":
        bsr = bsr.astype(jnp.bfloat16)
    operand = jnp.ones((bsr.ncols,) + (4,) * (ndim - 1),
                       np.float64 if dtype is np.float64 else np.float32)
    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    assert bsr_ops.bsr_path(bsr, operand) == expect


def test_triton_vjp_matches_xla(rng):
    """The kernel's gradient rule (plain XLA transpose products) agrees
    with autodiff through the XLA formulation, padding blocks included
    (against the dense matrix in ``test_triton_vjp_spmv``)."""
    bsr, _ = _case(rng, 4, 16, skip=lambda i, j: i == 1)
    nbr = 4
    x = jnp.asarray(rng.normal(size=bsr.ncols).astype(np.float32))
    w = jnp.asarray(rng.normal(size=bsr.nrows).astype(np.float32))

    def loss_kernel(data, x):
        return jnp.vdot(w, bsr_ops._triton_apply(
            bsr.indptr, bsr.indices, data, x, nbr, True))

    def loss_xla(data, x):
        return jnp.vdot(w, bsr_ops._xla_matvec(
            bsr.indptr, bsr.indices, data, x, nbr=nbr))

    gk = jax.grad(loss_kernel, argnums=(0, 1))(bsr.data, x)
    gx = jax.grad(loss_xla, argnums=(0, 1))(bsr.data, x)
    for a, b in zip(gk, gx):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=1e-5, atol=1e-4)


def test_triton_vjp_spmv(rng):
    bsr, dense = _case(rng, 4, 16, skip=lambda i, j: i == 2)
    x = jnp.asarray(rng.normal(size=bsr.ncols).astype(np.float32))
    w = jnp.asarray(rng.normal(size=bsr.nrows).astype(np.float32))

    def loss(data, x):
        return jnp.vdot(w, bsr_ops._triton_apply(bsr.indptr, bsr.indices,
                                                 data, x, 4, True))

    gd, gx = jax.grad(loss, argnums=(0, 1))(bsr.data, x)
    np.testing.assert_allclose(np.asarray(gx), dense.T @ np.asarray(w),
                               rtol=1e-5, atol=1e-4)
    brow = np.repeat(np.arange(4), np.diff(np.asarray(bsr.indptr)))
    ind = np.asarray(bsr.indices)
    wb = np.asarray(w).reshape(4, 16)
    xb = np.asarray(x).reshape(-1, 16)
    ref = np.einsum("ki,kj->kij", wb[brow], xb[ind])
    np.testing.assert_allclose(np.asarray(gd)[: ref.shape[0]], ref,
                               rtol=1e-5, atol=1e-5)


def test_dispatch_matmat_grad_on_gpu_path(rng, monkeypatch):
    """On the GPU dispatch (interpret mode standing in for the card)
    ``bsr @ x`` runs the kernel and ``bsr @ X`` the XLA path; both
    differentiate to the dense column sums."""
    bsr, dense = _case(rng, 3, 16)
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    calls = []
    orig = bsr_ops._triton_apply

    def interp(indptr, indices, data, x, nbr, interpret):
        calls.append(x.ndim)
        return orig(indptr, indices, data, x, nbr, True)

    monkeypatch.setattr(bsr_ops, "_triton_apply", interp)
    X = jnp.asarray(rng.normal(size=(bsr.ncols, 4)).astype(np.float32))
    g = jax.grad(lambda X: jnp.sum(bsr @ X))(X)
    gv = jax.grad(lambda x: jnp.sum(bsr @ x))(X[:, 0])
    assert calls and set(calls) == {1}     # the kernel saw only SpMV
    colsum = dense.sum(axis=0)
    np.testing.assert_allclose(np.asarray(g), np.tile(colsum[:, None],
                                                      (1, 4)),
                               rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(np.asarray(gv), colsum, rtol=1e-5, atol=1e-4)


@pytest.mark.gpu
def test_triton_compiled_on_gpu(rng):
    """The compiled kernel at the bench block size against XLA, and the
    GPU's XLA SpMM against the dense product."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU: the compiled Triton kernel has "
                    "no CPU lowering (interpret-mode tests cover it here)")
    bsr, dense = _case(rng, 64, 128)
    nbr = 64
    X = jnp.asarray(rng.normal(size=(bsr.ncols, 64)).astype(np.float32))
    for got, ref in (
            (bsr_matvec_call(bsr.indptr, bsr.indices, bsr.data, X[:, 0],
                             nbr=nbr),
             bsr_ops._xla_matvec(bsr.indptr, bsr.indices, bsr.data,
                                 X[:, 0], nbr=nbr)),
            (bsr @ X, dense @ np.asarray(X, np.float64))):
        np.testing.assert_allclose(np.asarray(got), np.asarray(ref),
                                   rtol=1e-5,
                                   atol=1e-5 * float(jnp.max(jnp.abs(ref))))
