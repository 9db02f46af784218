"""The port's CUDA kernels held against their plain PyTorch versions on the
card, at a small ragged shape and at the main path's shape.

Run on a machine with a CUDA device:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_kernels_gpu.py

Whether a card is present is decided inside the ``cuda`` fixture (never at
import or collection), so every worker collects the same tests; without a
card they skip with the reason.
"""

import numpy as np
import pytest
import torch

from repro_torch.core.scheduler import build_schedule
from repro_torch.core.sweep import pair_mask_table
from repro_torch.kernels import ops, ref
from repro_torch.kernels.pcit_filter import pcit_filter_cuda

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _bodies(rng, *shape):
    return np.concatenate([rng.normal(size=shape + (3,)),
                           rng.uniform(0.5, 2, shape + (1,))],
                          -1).astype(np.float32)


@pytest.mark.parametrize("B,k,block,n_pairs", [(3, 4, 100, 7), (2, 3, 257, 5),
                                               (1, 2, 8, 2)])
def test_pairwise_batch_small(cuda, B, k, block, n_pairs):
    """Arbitrary lo / hi, repeated pairs, lo > hi, masked pairs, ragged
    blocks."""
    rng = np.random.default_rng(B * 100 + block)
    q = torch.as_tensor(_bodies(rng, B, k, block), device=cuda)
    lo = rng.integers(0, k, n_pairs).astype(np.int32)
    hi = rng.integers(0, k, n_pairs).astype(np.int32)
    lo[0] = hi[0] = 0
    wi = torch.as_tensor(rng.integers(0, 2, (B, n_pairs)).astype(np.float32),
                         device=cuda)
    wi[:, 0] = 1
    wj = wi * torch.as_tensor(lo != hi, device=cuda)
    got = ops.pairwise_batch_forces(q, lo, hi, wi, wj)
    want = ref.pairwise_batch_forces(q, lo, hi, wi, wj)
    assert float((got - want).abs().max() / want.abs().max()) < 1e-4


def test_pairwise_batch_main_shape(cuda):
    sched = build_schedule(8)
    rng = np.random.default_rng(0)
    q = torch.as_tensor(_bodies(rng, 8, sched.k, 8192), device=cuda)
    wi = torch.as_tensor(pair_mask_table(sched), device=cuda)
    wj = torch.where(torch.as_tensor(sched.pair_diff == 0, device=cuda), 0, wi)
    lo, hi = sched.pair_slots[:, 0], sched.pair_slots[:, 1]
    got = ops.pairwise_batch_forces(q, lo, hi, wi, wj)
    want = ref.pairwise_batch_forces(q[:2], lo, hi, wi[:2], wj[:2])
    assert float((got[:2] - want).abs().max() / want.abs().max()) < 1e-4


@pytest.mark.parametrize("B,M,N,G", [(5, 70, 90, 33), (2, 64, 64, 16),
                                     (40, 1024, 1024, 512)])
def test_pairwise_corr(cuda, B, M, N, G):
    g = torch.Generator(device=cuda).manual_seed(B + M)
    xi = torch.randn(B, M, G, device=cuda, generator=g)
    xj = torch.randn(B, N, G, device=cuda, generator=g)
    torch.testing.assert_close(ops.pairwise_corr(xi, xj),
                               ref.pairwise_corr(xi, xj), rtol=1e-4,
                               atol=1e-5)
    bf = ops.pairwise_corr(xi.bfloat16(), xj.bfloat16())
    torch.testing.assert_close(bf, ref.pairwise_corr(xi.bfloat16(),
                                                     xj.bfloat16()),
                               rtol=1e-4, atol=1e-5)


def _corr_rows(rng, Z, G, rank=6):
    X = rng.normal(size=(Z, rank)) @ rng.normal(size=(rank, G))
    X = X + 0.5 * rng.normal(size=(Z, G))
    X -= X.mean(1, keepdims=True)
    X /= np.linalg.norm(X, axis=1, keepdims=True)
    return X @ X.T


@pytest.mark.parametrize("B,M,N,Z", [(3, 20, 40, 77), (2, 16, 48, 96),
                                     (1, 64, 64, 300)])
def test_pcit_filter_small(cuda, B, M, N, Z):
    R = torch.as_tensor(_corr_rows(np.random.default_rng(Z), Z, 24),
                        dtype=torch.float32, device=cuda)
    gx = torch.arange(0, M, device=cuda).expand(B, M)
    gy = torch.arange(Z - N, Z, device=cuda).expand(B, N)
    args = (R[:M, Z - N:].expand(B, M, N), R[:M].expand(B, M, Z),
            R[Z - N:].expand(B, N, Z), gx, gy)
    visits = torch.empty(B, M, N, dtype=torch.int32, device=cuda)
    got = pcit_filter_cuda(*args, visits=visits)
    assert torch.equal(got, ref.pcit_filter(*args))
    # a kept off-diagonal edge searched every z; the diagonal none
    assert bool((visits[got & (gx[..., None] != gy[:, None])] == Z).all())
    assert bool((visits[(gx[..., None] == gy[:, None]).expand_as(got)]
                 == 0).all())


def test_pcit_filter_main_shape_tile(cuda):
    """One 1024 x 1024 tile over Z = 8192 genes, compared in row chunks."""
    R = torch.as_tensor(_corr_rows(np.random.default_rng(1), 8192, 512, 16),
                        dtype=torch.float32, device=cuda)
    ids = torch.arange(1024, device=cuda)
    args = (R[None, :1024, 2048:3072].contiguous(), R[None, :1024],
            R[None, 2048:3072], ids[None], (ids + 2048)[None])
    got = ops.pcit_filter(*args)
    for r0 in range(0, 1024, 16):
        sl = slice(r0, r0 + 16)
        want = ref.pcit_filter(args[0][:, sl], args[1][:, sl], args[2],
                               args[3][:, sl], args[4])
        assert torch.equal(got[:, sl], want)


def test_wrappers_count_launches(cuda):
    ops.reset_launch_counts()
    x = torch.zeros(1, 4, 3, device=cuda)
    ops.pairwise_corr(x, x)
    assert ops.launch_counts()["pairwise_corr"] == 1
