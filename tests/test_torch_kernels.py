"""The port's plain kernel versions and dispatch, held against the JAX
package's kernels (Pallas in interpret mode on the CPU, as
tests/test_kernels.py runs them, or their plain reference) on the same
cells that file sweeps.

The CUDA kernels themselves run only on the card (tests/
test_torch_kernels_gpu.py and chip_smoke.py); here the wrappers must refuse
CPU tensors instead of computing anything.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels import ops as r_ops
from repro.kernels import ref as r_ref
from repro_torch.kernels import _build, ops, ref
from repro_torch.kernels.pairwise_batch import pairwise_batch_forces_cuda
from repro_torch.kernels.pairwise_corr import pairwise_corr_cuda
from repro_torch.kernels.pcit_filter import pcit_filter_cuda


@pytest.mark.parametrize("M,N,G", [(128, 128, 128), (64, 96, 50),
                                   (256, 128, 384), (32, 32, 1024)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_pairwise_corr_plain(M, N, G, dtype):
    rng = np.random.default_rng(M * 7 + N + G)
    xi = jnp.asarray(rng.normal(size=(M, G)), dtype)
    xj = jnp.asarray(rng.normal(size=(N, G)), dtype)
    want = np.asarray(r_ops.pairwise_corr(xi, xj))
    tdt = getattr(torch, dtype)
    ti = torch.tensor(np.asarray(xi.astype(jnp.float32))).to(tdt)
    tj = torch.tensor(np.asarray(xj.astype(jnp.float32))).to(tdt)
    got = ops.pairwise_corr(ti[None], tj[None])[0]
    assert got.dtype == torch.float32 and got.shape == (M, N)
    tol = 1e-4 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(got.numpy(), want, rtol=tol, atol=tol)


@pytest.mark.parametrize("M,N,Z,bm", [(32, 32, 64, 16), (16, 48, 96, 16),
                                      (64, 64, 128, 32)])
def test_pcit_filter_plain_exact(M, N, Z, bm):
    rng = np.random.default_rng(M + N + Z)
    rows = rng.normal(size=(Z, 24))
    rows = rows / np.linalg.norm(rows, axis=1, keepdims=True)
    R = (rows @ rows.T).astype(np.float32)
    gx = np.arange(0, M, dtype=np.int32)
    gy = np.arange(Z - N, Z, dtype=np.int32)
    args = (R[:M, Z - N:], R[:M], R[Z - N:], gx, gy)
    want = np.asarray(r_ops.pcit_filter(*(jnp.asarray(a) for a in args),
                                        bm=bm, bn=bm, bz=32))
    np.testing.assert_array_equal(want, np.asarray(
        r_ref.pcit_filter(*(jnp.asarray(a) for a in args))))
    got = ops.pcit_filter(*(torch.as_tensor(a)[None] for a in args))[0]
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("k,block,n_pairs", [(2, 8, 2), (3, 12, 5),
                                             (4, 16, 9), (3, 8, 4)])
def test_pairwise_batch_forces_plain(k, block, n_pairs):
    """Including a self pair (wj = 0), masked pairs, repeated pairs and
    lo > hi, as the reference's sweep draws them."""
    rng = np.random.default_rng(k * 100 + block + n_pairs)
    quorum = np.concatenate([rng.normal(size=(k, block, 3)),
                             rng.uniform(0.5, 2, (k, block, 1))],
                            -1).astype(np.float32)
    lo = rng.integers(0, k, size=n_pairs).astype(np.int32)
    hi = rng.integers(0, k, size=n_pairs).astype(np.int32)
    lo[0] = hi[0] = 0
    wi = rng.integers(0, 2, size=n_pairs).astype(np.float32)
    wi[0] = 1.0
    wj = wi * (lo != hi)
    # the reference's Pallas B1 uses pl.load, which jax 0.9 removed, so it
    # is held through its plain reference (ref.pairwise_batch_forces)
    want = np.asarray(r_ref.pairwise_batch_forces(jnp.asarray(quorum), lo, hi,
                                                  jnp.asarray(wi),
                                                  jnp.asarray(wj)))
    got = ops.pairwise_batch_forces(torch.as_tensor(quorum)[None], lo, hi,
                                    torch.as_tensor(wi)[None],
                                    torch.as_tensor(wj)[None])
    assert got.shape == (1, k, block, 3)
    np.testing.assert_allclose(got[0].numpy(), want, rtol=1e-5, atol=1e-6)


def test_plain_versions_batch_over_leading_axis():
    """A batch of B entries equals B separate calls."""
    g = torch.Generator().manual_seed(0)
    xi, xj = torch.randn(3, 8, 5, generator=g), torch.randn(3, 6, 5,
                                                            generator=g)
    got = ops.pairwise_corr(xi, xj)
    for b in range(3):
        torch.testing.assert_close(got[b], ref.pairwise_corr(xi[b], xj[b]))
    rows = torch.nn.functional.normalize(torch.randn(20, 7, generator=g), dim=1)
    R = rows @ rows.T
    gx = torch.stack([torch.arange(0, 4), torch.arange(8, 12)])
    gy = torch.stack([torch.arange(10, 16), torch.arange(14, 20)])
    args = (torch.stack([R[gx[b]][:, gy[b]] for b in range(2)]), R[gx], R[gy],
            gx, gy)
    keep = ops.pcit_filter(*args)
    for b in range(2):
        assert torch.equal(keep[b], ref.pcit_filter(*(a[b] for a in args)))


def test_cuda_wrappers_refuse_cpu_tensors():
    """A CUDA wrapper never computes on the CPU: it raises before building
    or launching anything."""
    q = torch.zeros(1, 2, 8, 4)
    w = torch.ones(1, 1)
    with pytest.raises(ValueError, match="CUDA"):
        pairwise_batch_forces_cuda(q, [0], [1], w, w)
    with pytest.raises(ValueError, match="CUDA"):
        pairwise_corr_cuda(torch.zeros(1, 4, 3), torch.zeros(1, 5, 3))
    with pytest.raises(ValueError, match="CUDA"):
        pcit_filter_cuda(torch.zeros(1, 2, 3), torch.zeros(1, 2, 6),
                         torch.zeros(1, 3, 6), torch.zeros(1, 2, dtype=int),
                         torch.zeros(1, 3, dtype=int))
    with pytest.raises(ValueError, match="slot ids"):
        pairwise_batch_forces_cuda(q, [0], [2], w, w)
    with pytest.raises(ValueError, match="float32"):
        pairwise_batch_forces_cuda(q.double(), [0], [1], w, w)


def test_build_is_keyed_and_needs_nvcc(monkeypatch, tmp_path):
    """The build key covers every source and flag; without nvcc the build
    raises (there is no path that drops to the plain version)."""
    for src in _build.SOURCES:
        assert (_build.CSRC / src).is_file()
    assert set(_build.SIGNATURES) == {"repro_pairwise_batch_forces",
                                      "repro_pairwise_corr",
                                      "repro_pcit_filter"}
    key = _build.build_key()
    assert key == _build.build_key() and len(key) == 16
    monkeypatch.setitem(_build.FILE_FLAGS, "pcit_filter.cu", ())
    assert _build.build_key() != key
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.nvcc_path()


def test_launch_counts_reset():
    ops.reset_launch_counts()
    assert ops.launch_counts() == {"pairwise_batch": 0, "pairwise_corr": 0,
                                   "pcit_filter": 0}
    # the plain path on the CPU launches nothing
    ops.pairwise_corr(torch.zeros(1, 2, 3), torch.zeros(1, 2, 3))
    assert sum(ops.launch_counts().values()) == 0
