"""The port's plain kernel versions and dispatch, held against the JAX
package's kernels (Pallas in interpret mode on the CPU, as
tests/test_kernels.py runs them, or their plain reference) on the same
cells that file sweeps.

The CUDA kernels themselves run only on the card (tests/
test_torch_kernels_gpu.py and chip_smoke.py); here the wrappers must refuse
CPU tensors instead of computing anything.
"""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels import ops as r_ops
from repro.kernels import ref as r_ref
from repro.kernels.pairwise_threshold import pairwise_threshold_pallas
from repro.kernels.query_score import query_topk_pallas
from repro.apps import attention as r_attn
from repro_torch.kernels import _build, ops, ref
from repro_torch.kernels.pairwise_batch import pairwise_batch_forces_cuda
from repro_torch.kernels.pairwise_batch_q import (pairwise_threshold_q_cuda,
                                                  pairwise_topk_q_cuda)
from repro_torch.kernels.pairwise_corr import pairwise_corr_cuda
from repro_torch.kernels.pairwise_threshold import pairwise_threshold_cuda
from repro_torch.kernels.pairwise_topk import pairwise_topk_cuda
from repro_torch.kernels.pcit_filter import pcit_filter_cuda
from repro_torch.kernels.query_score import query_topk_cuda
from repro_torch.kernels.flash_attention import flash_attention_cuda
from repro_torch.kernels.ssd_chunk import ssd_chunk_bwd_cuda, ssd_chunk_cuda
from repro_torch.apps import attention as attn


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
    stack, m = torch.zeros(1, 2, 8, 4), torch.ones(1, 2, 8)
    g = torch.zeros(1, 2, 8, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        query_topk_cuda(stack, torch.zeros(3, 4), m, g, topk=4)
    with pytest.raises(ValueError, match="topk"):
        query_topk_cuda(stack, torch.zeros(3, 4), m, g, topk=1025)
    with pytest.raises(ValueError, match="mask and gidx"):
        query_topk_cuda(stack, torch.zeros(3, 4), m[:, :1], g, topk=4)
    meta = torch.ones(1, 1, 6, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        pairwise_threshold_cuda(stack, [0], [1], meta, threshold=0.0,
                                capacity=8, block_rows=8)
    with pytest.raises(ValueError, match="slot ids"):
        pairwise_threshold_cuda(stack, [0], [2], meta, threshold=0.0,
                                capacity=8, block_rows=8)
    with pytest.raises(ValueError, match="meta"):
        pairwise_threshold_cuda(stack, [0, 1], [1, 0], meta, threshold=0.0,
                                capacity=8, block_rows=8)
    # B6-B8: no topk ceiling, but CPU tensors and bad operands are refused
    with pytest.raises(ValueError, match="CUDA"):
        pairwise_topk_cuda(stack, [0], [1], meta, topk=2048, block_rows=8)
    with pytest.raises(ValueError, match="topk"):
        pairwise_topk_cuda(stack, [0], [1], meta, topk=0, block_rows=8)
    with pytest.raises(ValueError, match="float32"):
        pairwise_topk_cuda(stack.double(), [0], [1], meta, topk=2,
                           block_rows=8)
    codes = torch.zeros(1, 2, 8, 4, dtype=torch.int8)
    sd, rows = torch.ones(1, 2, 2), torch.ones(1, 2, 8)
    with pytest.raises(ValueError, match="CUDA"):
        pairwise_topk_q_cuda(codes, sd, rows, [0], [1], meta, topk=2048,
                             block_rows=8)
    with pytest.raises(ValueError, match="CUDA"):
        pairwise_threshold_q_cuda(codes, sd, rows, rows, [0], [1], meta,
                                  threshold=0.0, capacity=8, block_rows=8)
    with pytest.raises(ValueError, match="int8 or bfloat16"):
        pairwise_topk_q_cuda(stack, sd, rows, [0], [1], meta, topk=2,
                             block_rows=8)
    with pytest.raises(ValueError, match="sd must be"):
        pairwise_threshold_q_cuda(codes, sd[..., :1], rows, rows, [0], [1],
                                  meta, threshold=0.0, capacity=8,
                                  block_rows=8)
    with pytest.raises(ValueError, match="l1 / sq"):
        pairwise_topk_q_cuda(codes, sd, rows[..., :3], [0], [1], meta,
                             topk=2, block_rows=8)
    # B9, B10
    qa, ka = torch.zeros(1, 4, 4, 8), torch.zeros(1, 4, 2, 8)
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_cuda(qa, ka, ka, causal=True)
    with pytest.raises(ValueError, match="multiple of KV"):
        flash_attention_cuda(qa, torch.zeros(1, 4, 3, 8),
                             torch.zeros(1, 4, 3, 8), causal=True)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        flash_attention_cuda(qa.double(), ka, ka, causal=True)
    x, dt = torch.zeros(1, 8, 2, 4), torch.zeros(1, 8, 2)
    A, Bm = torch.zeros(2), torch.zeros(1, 8, 3)
    with pytest.raises(ValueError, match="CUDA"):
        ssd_chunk_cuda(x, dt, A, Bm, Bm, chunk=4)
    with pytest.raises(ValueError, match="chunks of 3"):
        ssd_chunk_cuda(x, dt, A, Bm, Bm, chunk=3)
    with pytest.raises(ValueError, match="disagree"):
        ssd_chunk_cuda(x, dt[:, :, :1], A, Bm, Bm, chunk=4)
    with pytest.raises(ValueError, match="CUDA"):
        ssd_chunk_bwd_cuda(x, dt, A, Bm, Bm, x, None, None, chunk=4)
    with pytest.raises(ValueError, match="dS has shape"):
        ssd_chunk_bwd_cuda(x, dt, A, Bm, Bm, x, torch.zeros(1, 2, 2, 3, 3),
                           None, chunk=4)
    with pytest.raises(ValueError, match="chunks of 3"):
        ssd_chunk_bwd_cuda(x, dt, A, Bm, Bm, None, None, None, chunk=3)


def test_build_is_keyed_and_needs_nvcc(monkeypatch, tmp_path):
    """The build key covers every source and flag; without nvcc the build
    raises (there is no path that drops to the plain version)."""
    for src in _build.SOURCES:
        assert (_build.CSRC / src).is_file()
    for hdr in _build.HEADERS:
        assert (_build.CSRC / hdr).is_file()
    assert set(_build.SIGNATURES) == {"repro_pairwise_batch_forces",
                                      "repro_pairwise_corr",
                                      "repro_pcit_filter",
                                      "repro_pcit_probe",
                                      "repro_query_topk",
                                      "repro_query_topk_chunk_rows",
                                      "repro_pairwise_threshold",
                                      "repro_pairwise_topk",
                                      "repro_pairwise_topk_q",
                                      "repro_pairwise_threshold_q",
                                      "repro_flash_attention",
                                      "repro_flash_attention_tc",
                                      "repro_flash_attention_bwd",
                                      "repro_flash_attention_bwd_tc",
                                      "repro_ssd_chunk",
                                      "repro_ssd_chunk_bwd"}
    key = _build.build_key()
    assert key == _build.build_key() and len(key) == 16
    monkeypatch.setitem(_build.FILE_FLAGS, "pcit_filter.cu", ())
    assert _build.build_key() != key
    # the quantized kernels round their epilogue as the plain versions do
    for src in ("pairwise_threshold_q.cu", "pairwise_topk_q.cu"):
        assert "-fmad=false" in _build.FILE_FLAGS[src]
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.nvcc_path()


def test_launch_counts_reset():
    ops.reset_launch_counts()
    assert ops.launch_counts() == {"pairwise_batch": 0, "pairwise_corr": 0,
                                   "pcit_filter": 0, "query_topk": 0,
                                   "pairwise_threshold": 0,
                                   "pairwise_topk": 0,
                                   "pairwise_threshold_q": 0,
                                   "pairwise_topk_q": 0,
                                   "flash_attention": 0,
                                   "flash_attention_bwd": 0, "ssd_chunk": 0,
                                   "ssd_chunk_bwd": 0}
    # the plain path on the CPU launches nothing
    ops.pairwise_corr(torch.zeros(1, 2, 3), torch.zeros(1, 2, 3))
    assert sum(ops.launch_counts().values()) == 0


def _b4_inputs(k, block, d, Q, seed, ties):
    """A B4 cell: masked rows, a fully masked slot, scattered global ids;
    with ``ties``, small-integer data (every score exact) and duplicated
    rows, so equal scores must break by the smaller index."""
    rng = np.random.default_rng(seed)
    if ties:
        stack = rng.integers(-2, 3, size=(k, block, d)).astype(np.float32)
        stack[:, 1::2] = stack[:, 0:block - block % 2:2]
        stack[-1] = stack[0]
        queries = rng.integers(-2, 3, size=(Q, d)).astype(np.float32)
    else:
        stack = rng.normal(size=(k, block, d)).astype(np.float32)
        queries = rng.normal(size=(Q, d)).astype(np.float32)
    mask = (rng.uniform(size=(k, block)) > 0.3).astype(np.float32)
    mask[0] = 0.0
    gidx = rng.permutation(4 * k * block)[:k * block].reshape(k, block)
    return stack, queries, mask, gidx.astype(np.int32)


B4_CELLS = [(3, 16, 8, 4, 4, False), (4, 12, 24, 5, 8, False),
            (2, 32, 16, 12, 3, False), (5, 8, 4, 3, 40, False),
            (4, 16, 8, 6, 10, True), (3, 20, 6, 7, 64, True)]


@pytest.mark.parametrize("k,block,d,Q,topk,ties", B4_CELLS)
@pytest.mark.parametrize("metric", ["dot", "l2"])
def test_query_topk_plain(k, block, d, Q, topk, ties, metric):
    """B4's plain version against the reference's plain version and its
    Pallas kernel (interpret mode): ragged Q, masked rows, a fully masked
    slot, ties between duplicated rows, topk above the candidate count.
    Exact on indices, rtol 1e-5 on values."""
    stack, queries, mask, gidx = _b4_inputs(k, block, d, Q,
                                            k * 100 + block + Q, ties)
    want = r_ref.query_topk(jnp.asarray(stack), jnp.asarray(queries), mask,
                            gidx, topk=topk, metric=metric)
    pallas = query_topk_pallas(jnp.asarray(stack), jnp.asarray(queries),
                               jnp.asarray(mask), jnp.asarray(gidx),
                               topk=topk, metric=metric, interpret=True)
    # the port takes a leading device axis: device 1 sees the mask reversed
    st2 = torch.as_tensor(np.stack([stack, stack]))
    m2 = torch.as_tensor(np.stack([mask, mask[::-1].copy()]))
    g2 = torch.as_tensor(np.stack([gidx, gidx]))
    got_v, got_i = ops.query_topk(st2, torch.as_tensor(queries), m2, g2,
                                  topk=topk, metric=metric)
    assert got_v.shape == (2, Q, topk) and got_i.dtype == torch.int32
    for w in (want, pallas):
        np.testing.assert_array_equal(got_i[0].numpy(), np.asarray(w[1]))
        np.testing.assert_allclose(got_v[0].numpy(), np.asarray(w[0]),
                                   rtol=1e-5, atol=1e-5)
    w1 = r_ref.query_topk(jnp.asarray(stack), jnp.asarray(queries),
                          mask[::-1], gidx, topk=topk, metric=metric)
    np.testing.assert_array_equal(got_i[1].numpy(), np.asarray(w1[1]))
    if k * block < topk:
        assert (got_i[0, :, k * block:] == ref.IDX_SENTINEL).all()


def _b5_inputs(k, block, d, n_pairs, seed, ties):
    """A B5 cell as the reference's sweep draws it: a self pair, repeated
    pairs and lo > hi, an inactive (prefiltered) tile, ragged nv_lo /
    nv_hi, arbitrary global block ids."""
    rng = np.random.default_rng(seed)
    if ties:
        quorum = rng.integers(-2, 3, size=(k, block, d)).astype(np.float32)
    else:
        quorum = rng.normal(size=(k, block, d)).astype(np.float32)
    lo = rng.integers(0, k, size=n_pairs).astype(np.int32)
    hi = rng.integers(0, k, size=n_pairs).astype(np.int32)
    lo[0] = hi[0] = 0
    meta = np.stack([
        np.ones(n_pairs), (lo == hi),
        rng.permutation(2 * n_pairs)[:n_pairs],
        rng.permutation(2 * n_pairs)[:n_pairs],
        np.minimum(block, rng.integers(1, block + 1, n_pairs)),
        np.minimum(block, rng.integers(1, block + 1, n_pairs)),
    ], axis=1).astype(np.int32)
    if n_pairs > 1:
        meta[1, 0] = 0
    return quorum, lo, hi, meta


B5_CELLS = [(3, 16, 8, 4, 256, False), (4, 12, 24, 6, 64, False),
            (2, 8, 4, 2, 128, False), (5, 8, 16, 8, 16, False),
            (3, 10, 6, 5, 12, True)]


@pytest.mark.parametrize("k,block,d,n_pairs,capacity,ties", B5_CELLS)
@pytest.mark.parametrize("metric", ["dot", "l2"])
def test_pairwise_threshold_plain(k, block, d, n_pairs, capacity, ties,
                                  metric):
    """B5's plain version against the reference's plain version and its
    Pallas kernel (interpret mode): inactive tiles, self tiles, ragged
    nv_lo / nv_hi, overflowing capacities (the same first-capacity
    prefix), exact-integer scores on the threshold.  Exact on ids and
    counts, rtol 1e-5 on values."""
    quorum, lo, hi, meta = _b5_inputs(k, block, d, n_pairs,
                                      k * 1000 + block, ties)
    s = quorum[0] @ quorum[-1].T
    if metric == "l2":
        s = (2.0 * s - (quorum[-1] ** 2).sum(-1)[None]
             - (quorum[0] ** 2).sum(-1)[:, None])
    # integer scores: a threshold equal to a score keeps it (>=)
    thr = float(np.quantile(s, 0.7)) if not ties else float(np.median(s))
    kw = dict(threshold=thr, capacity=capacity, block_rows=block,
              metric=metric)
    want = r_ref.pairwise_threshold(jnp.asarray(quorum), lo, hi, meta, **kw)
    pallas = pairwise_threshold_pallas(jnp.asarray(quorum), lo, hi,
                                       jnp.asarray(meta), interpret=True,
                                       **kw)
    meta2 = np.stack([meta, meta])
    meta2[1, :, 0] = 1 - meta2[1, :, 0]          # device 1: flags flipped
    got = ops.pairwise_threshold(torch.as_tensor(np.stack([quorum, quorum])),
                                 lo, hi, torch.as_tensor(meta2), **kw)
    assert got[0].shape == (2, capacity) and got[3].shape == (2,)
    for w in (want, pallas):
        np.testing.assert_array_equal(got[1][0].numpy(), np.asarray(w[1]))
        np.testing.assert_array_equal(got[2][0].numpy(), np.asarray(w[2]))
        np.testing.assert_allclose(got[0][0].numpy(), np.asarray(w[0]),
                                   rtol=1e-5, atol=1e-5)
        assert int(got[3][0]) == int(np.asarray(w[3]).reshape(()))
    w1 = r_ref.pairwise_threshold(jnp.asarray(quorum), lo, hi, meta2[1], **kw)
    np.testing.assert_array_equal(got[1][1].numpy(), np.asarray(w1[1]))
    assert int(got[3][1]) == int(w1[3])
    if (k, block, d, n_pairs, capacity) == (5, 8, 16, 8, 16):
        assert int(got[3][0]) > capacity            # the overflow cell


def test_pairwise_threshold_plain_strips_match_one_step(monkeypatch):
    """The plain join compaction forms tiles in row strips; the strip size
    changes nothing (order, overflow prefix, count)."""
    quorum, lo, hi, meta = _b5_inputs(3, 16, 8, 4, 7, False)
    kw = dict(threshold=0.5, capacity=24, block_rows=16, metric="dot")
    q = torch.as_tensor(quorum)
    whole = ref.pairwise_threshold(q, lo, hi, torch.as_tensor(meta), **kw)
    monkeypatch.setattr(ref, "_THRESHOLD_STEP_ELEMS", 3 * 16)
    strips = ref.pairwise_threshold(q, lo, hi, torch.as_tensor(meta), **kw)
    torch.testing.assert_close(whole[0], strips[0], rtol=1e-6, atol=1e-6)
    for a, b in zip(whole[1:], strips[1:]):
        assert torch.equal(a, b)
    assert int(whole[3]) > 24


B6_CELLS = [(3, 16, 8, 4, 5, False), (4, 12, 24, 6, 1, False),
            (2, 8, 4, 2, 20, False), (5, 8, 16, 8, 3, True),
            (3, 10, 6, 5, 7, True)]


@pytest.mark.parametrize("k,block,d,n_pairs,topk,ties", B6_CELLS)
@pytest.mark.parametrize("metric", ["dot", "l2"])
def test_pairwise_topk_plain(k, block, d, n_pairs, topk, ties, metric):
    """B6's plain version against the reference's (``ref.pairwise_topk``):
    self tiles, repeated pairs and lo > hi, an inactive tile, ragged nv_lo
    / nv_hi, tie-heavy integer data, topk above the candidate count.
    Indices exact, values within rtol 1e-6."""
    quorum, lo, hi, meta = _b5_inputs(k, block, d, n_pairs,
                                      k * 3000 + block + topk, ties)
    kw = dict(topk=topk, block_rows=block, metric=metric)
    want = r_ref.pairwise_topk(jnp.asarray(quorum), lo, hi, meta, **kw)
    meta2 = np.stack([meta, meta])
    meta2[1, :, 0] = 1 - meta2[1, :, 0]          # device 1: flags flipped
    got = ops.pairwise_topk(torch.as_tensor(np.stack([quorum, quorum])), lo,
                            hi, torch.as_tensor(meta2), **kw)
    assert got[0].shape == (2, k, block, topk) and got[1].dtype == torch.int32
    np.testing.assert_array_equal(got[1][0].numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(got[0][0].numpy(), np.asarray(want[0]),
                               rtol=1e-6, atol=1e-6)
    w1 = r_ref.pairwise_topk(jnp.asarray(quorum), lo, hi, meta2[1], **kw)
    np.testing.assert_array_equal(got[1][1].numpy(), np.asarray(w1[1]))


def _q_inputs(k, block, d, n_pairs, seed, qmode):
    """A B7 / B8 cell: B5's pair layout over int8 codes or bf16 values
    (exactly representable, so both packages hold the same codes), with
    per-slot scales and deltas and per-row norms."""
    quorum, lo, hi, meta = _b5_inputs(k, block, d, n_pairs, seed, False)
    rng = np.random.default_rng(seed + 1)
    if qmode == "int8":
        codes = rng.integers(-127, 128, size=(k, block, d)).astype(np.int8)
        scale = rng.uniform(0.001, 0.02, k).astype(np.float32)
    else:
        codes = torch.as_tensor(quorum).to(torch.bfloat16).float().numpy()
        scale = np.ones(k, np.float32)
    delta = (scale / 2).astype(np.float32)
    deq = codes.astype(np.float32) * scale[:, None, None]
    l1 = np.abs(deq).sum(-1).astype(np.float32)
    sq = (deq * deq).sum(-1).astype(np.float32)
    return codes, scale, delta, l1, sq, lo, hi, meta


def _codes(codes, qmode):
    t = torch.as_tensor(codes)
    return t if qmode == "int8" else t.to(torch.bfloat16)


def _jcodes(codes, qmode):
    return jnp.asarray(codes) if qmode == "int8" else \
        jnp.asarray(codes).astype(jnp.bfloat16)


@pytest.mark.parametrize("k,block,d,n_pairs,capacity",
                         [(3, 16, 8, 4, 256), (4, 12, 24, 6, 64),
                          (5, 8, 16, 8, 16), (2, 8, 128, 3, 40)])
@pytest.mark.parametrize("metric", ["dot", "l2"])
@pytest.mark.parametrize("qmode", ["int8", "bf16"])
def test_pairwise_threshold_q_plain(k, block, d, n_pairs, capacity, metric,
                                    qmode):
    """B7's plain version against the reference's
    (``ref.pairwise_threshold_q``): band membership, order, overflow
    prefix and counts exact; int8 values exact, bf16 within rtol 1e-6."""
    codes, scale, delta, l1, sq, lo, hi, meta = _q_inputs(
        k, block, d, n_pairs, k * 5000 + block, qmode)
    deq = codes.astype(np.float32) * scale[:, None, None]
    s = deq[0] @ deq[-1].T
    if metric == "l2":
        s = 2.0 * s - sq[-1][None] - sq[0][:, None]
    kw = dict(threshold=float(np.quantile(s, 0.8)), capacity=capacity,
              block_rows=block, metric=metric)
    want = r_ref.pairwise_threshold_q(_jcodes(codes, qmode), scale, delta,
                                      l1, sq, lo, hi, meta, **kw)
    two = lambda a: torch.as_tensor(np.stack([a, a]))  # noqa: E731
    meta2 = np.stack([meta, meta])
    meta2[1, :, 0] = 1 - meta2[1, :, 0]
    sd = two(np.stack([scale, delta], -1))
    got = ops.pairwise_threshold_q(
        _codes(np.stack([codes, codes]), qmode), sd, two(l1), two(sq), lo,
        hi, torch.as_tensor(meta2), **kw)
    np.testing.assert_array_equal(got[1][0].numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(got[2][0].numpy(), np.asarray(want[2]))
    assert int(got[3][0]) == int(np.asarray(want[3]))
    if qmode == "int8":
        np.testing.assert_array_equal(got[0][0].numpy(), np.asarray(want[0]))
    else:
        np.testing.assert_allclose(got[0][0].numpy(), np.asarray(want[0]),
                                   rtol=1e-6, atol=1e-6)
    w1 = r_ref.pairwise_threshold_q(_jcodes(codes, qmode), scale, delta, l1,
                                    sq, lo, hi, meta2[1], **kw)
    np.testing.assert_array_equal(got[1][1].numpy(), np.asarray(w1[1]))
    assert int(got[3][1]) == int(np.asarray(w1[3]))
    if (k, capacity, metric) == (5, 16, "dot"):
        assert int(got[3][0]) > capacity            # the overflow cell


@pytest.mark.parametrize("k,block,d,n_pairs,topk",
                         [(3, 16, 8, 4, 5), (4, 12, 24, 6, 1),
                          (2, 8, 128, 3, 20)])
@pytest.mark.parametrize("metric", ["dot", "l2"])
@pytest.mark.parametrize("qmode", ["int8", "bf16"])
def test_pairwise_topk_q_plain(k, block, d, n_pairs, topk, metric, qmode):
    """B8's plain version against the reference's (``ref.pairwise_topk_q``):
    indices exact, int8 values exact, bf16 within rtol 1e-6."""
    codes, scale, _delta, _l1, sq, lo, hi, meta = _q_inputs(
        k, block, d, n_pairs, k * 7000 + block, qmode)
    kw = dict(topk=topk, block_rows=block, metric=metric)
    want = r_ref.pairwise_topk_q(_jcodes(codes, qmode), scale, sq, lo, hi,
                                 meta, **kw)
    sd = torch.as_tensor(np.stack([scale, scale / 2], -1))[None]
    got = ops.pairwise_topk_q(_codes(codes[None], qmode), sd,
                              torch.as_tensor(sq)[None], lo, hi,
                              torch.as_tensor(meta)[None], **kw)
    assert got[0].shape == (1, k, block, topk)
    np.testing.assert_array_equal(got[1][0].numpy(), np.asarray(want[1]))
    if qmode == "int8":
        np.testing.assert_array_equal(got[0][0].numpy(), np.asarray(want[0]))
    else:
        np.testing.assert_allclose(got[0][0].numpy(), np.asarray(want[0]),
                                   rtol=1e-6, atol=1e-6)


def test_topk_plain_strips_match_one_step(monkeypatch):
    """B6 / B8's plain versions fold row strips; the strip size changes
    nothing."""
    quorum, lo, hi, meta = _b5_inputs(3, 16, 8, 4, 11, False)
    q, m = torch.as_tensor(quorum), torch.as_tensor(meta)
    kw = dict(topk=6, block_rows=16, metric="l2")
    whole = ref.pairwise_topk(q, lo, hi, m, **kw)
    monkeypatch.setattr(ref, "_THRESHOLD_STEP_ELEMS", 3 * 16)
    strips = ref.pairwise_topk(q, lo, hi, m, **kw)
    assert torch.equal(whole[1], strips[1])
    torch.testing.assert_close(whole[0], strips[0], rtol=1e-6, atol=1e-6)


def test_topk_by_score_index_is_the_sort_order():
    """The packed-key selection equals the two-key sort: ties by index,
    -0.0 as 0.0, negative scores, sentinels last."""
    rng = np.random.default_rng(3)
    v = torch.as_tensor(rng.integers(-3, 4, size=(5, 40)).astype(np.float32))
    v[0, :3] = -0.0
    v[1, 5:] = ref.NEG_INF
    i = torch.as_tensor(rng.permutation(200).reshape(5, 40), dtype=torch.int32)
    i[2, 7] = ref.IDX_SENTINEL
    sv, si = ref.sort_by_score_index(-v, i)
    for k in (1, 7, 40):
        gv, gi = ref.topk_by_score_index(v, i, k)
        assert torch.equal(gi, si[:, :k])
        assert torch.equal(gv, -sv[:, :k])


# ---------------------------------------------------------------------------
# B9 flash attention, B10 SSD chunk: the cells of tests/test_kernels.py
# ---------------------------------------------------------------------------

FLASH_CELLS = [(2, 128, 128, 4, 2, 64, True), (1, 64, 256, 4, 4, 32, True),
               (2, 128, 128, 2, 1, 64, False), (1, 256, 256, 8, 2, 128, True)]


def _jax_qkv(B, Tq, Tk, H, KV, hd, dtype, seed):
    rng = np.random.default_rng(seed)
    return (jnp.asarray(rng.normal(size=(B, Tq, H, hd)), dtype),
            jnp.asarray(rng.normal(size=(B, Tk, KV, hd)), dtype),
            jnp.asarray(rng.normal(size=(B, Tk, KV, hd)), dtype))


def _to_torch(a, dtype=None):
    t = torch.tensor(np.asarray(jnp.asarray(a).astype(jnp.float32)))
    return t if dtype is None else t.to(dtype)


@pytest.mark.parametrize("B,Tq,Tk,H,KV,hd,causal", FLASH_CELLS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_plain(B, Tq, Tk, H, KV, hd, causal, dtype):
    """The port's plain B9 (what ops.flash_attention runs on the CPU)
    against the Pallas kernel in interpret mode and the JAX oracle, at the
    reference's kernel tolerances (2e-3 f32, 3e-2 bf16)."""
    q, k, v = _jax_qkv(B, Tq, Tk, H, KV, hd, dtype, B * Tq + H + hd)
    tdt = getattr(torch, dtype)
    got = ops.flash_attention(*(_to_torch(a, tdt) for a in (q, k, v)),
                              causal=causal)
    assert got.dtype == tdt and got.shape == (B, Tq, H, hd)
    tol = 2e-3 if dtype == "float32" else 3e-2
    for want in (r_ops.flash_attention(q, k, v, causal=causal, bq=64, bk=64),
                 r_ref.flash_attention(q, k, v, causal=causal)):
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32),
                                   rtol=tol, atol=tol)


@pytest.mark.parametrize("B,T,H,KV,hd", [(2, 16, 4, 2, 16), (1, 24, 6, 3, 8),
                                         (2, 8, 4, 4, 32)])
@pytest.mark.parametrize("causal_diag", [True, False])
def test_flash_block_and_merge_match_jax(B, T, H, KV, hd, causal_diag):
    """flash_block (the partial epilogue's plain version) and the (o, m, l)
    monoid against repro.apps.attention's, within 1e-5 (f32)."""
    q, k, v = _jax_qkv(B, T, T, H, KV, hd, "float32", T + H)
    want = r_attn.flash_block(q, k, v, causal_diag=causal_diag)
    got = attn.flash_block(*(_to_torch(a) for a in (q, k, v)),
                           causal_diag=causal_diag)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5)
    q2, k2, v2 = _jax_qkv(B, T, T, H, KV, hd, "float32", T + H + 1)
    other = r_attn.flash_block(q2, k2, v2, causal_diag=False)
    merged = r_attn.merge_partials(want, other)
    tmerged = attn.merge_partials(got, tuple(_to_torch(a) for a in other))
    for g, w in zip(tmerged, merged):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5)
    # two identities merge to the identity: exp(NEG_INF - NEG_INF) = 1
    e_j = r_attn.empty_partial((B, T, hd), H)
    e_t = attn.empty_partial((B, T, hd), H)
    for g, w in zip(attn.merge_partials(e_t, e_t),
                    r_attn.merge_partials(e_j, e_j)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_flash_block_row_valid_is_the_reference_masking():
    """Invalid rows become (0, NEG_INF, 0), the reference's masking of an
    invalid (device, pair) slot (apps/attention.py:115-119)."""
    q, k, v = _jax_qkv(4, 16, 16, 4, 2, 16, "float32", 5)
    w = np.array([1, 0, 1, 0], np.float32)
    o, m, l = r_attn.flash_block(q, k, v, causal_diag=True)
    wj = jnp.asarray(w)[:, None, None]
    want = (o * wj[..., None], jnp.where(wj > 0, m, r_attn.NEG_INF), l * wj)
    got = attn.flash_block(*(_to_torch(a) for a in (q, k, v)),
                           causal_diag=True, valid=torch.tensor(w))
    for g, wa in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(wa), rtol=1e-5,
                                   atol=1e-5)


def _online_pv(q, k, v, split: bool, bk: int = 64):
    """The bf16 wgmma B9's arithmetic on one non-causal block: scores and
    p in f32, tile by tile of ``bk`` keys with the online rescale, and
    P·V from bf16 copies of p (P_hi, plus P_lo = bf16(p - P_hi) with
    ``split``) against the bf16 V, summed in f32.  Returns o / l."""
    B, Tq, H, hd = q.shape
    KV = k.shape[2]
    qg = q.float().reshape(B, Tq, KV, H // KV, hd) / math.sqrt(hd)
    m = torch.full((B, KV, H // KV, Tq), ref.NEG_INF)
    l = torch.zeros_like(m)
    o = torch.zeros(B, KV, H // KV, Tq, hd)
    for k0 in range(0, k.shape[1], bk):
        kt, vt = k[:, k0:k0 + bk].float(), v[:, k0:k0 + bk].float()
        s = torch.einsum("bqkgh,bskh->bkgqs", qg, kt)
        m_new = torch.maximum(m, s.amax(-1))
        corr = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * corr + p.sum(-1)
        hi = p.bfloat16().float()
        pv = torch.einsum("bkgqs,bskh->bkgqh", hi, vt)
        if split:
            lo = (p - hi).bfloat16().float()
            pv = pv + torch.einsum("bkgqs,bskh->bkgqh", lo, vt)
        o = o * corr[..., None] + pv
        m = m_new
    o = o / l[..., None]
    return o.reshape(B, H, Tq, hd).permute(0, 2, 1, 3)


def test_flash_split_p_keeps_partials_within_1e5():
    """Why the bf16 wgmma B9 computes P·V as P_hi·V + P_lo·V: at a full
    quorum pair's statistics (N(0, 1) bf16 inputs, 4,096 visible keys,
    hd 128) the split keeps o / l within 1e-5 of the f32 plain flash block,
    the limit chip_smoke.py holds B9's partials to; a single bf16 rounding
    of p does not."""
    rng = np.random.default_rng(15)
    q, k, v = (torch.as_tensor(rng.normal(size=shape), dtype=torch.float32)
               .bfloat16() for shape in ((1, 64, 4, 128), (1, 4096, 1, 128),
                                         (1, 4096, 1, 128)))
    wo, _wm, wl = ref.flash_block(q, k, v, causal=False)
    want = wo / wl[..., None]
    split = float((_online_pv(q, k, v, split=True) - want).abs().max())
    single = float((_online_pv(q, k, v, split=False) - want).abs().max())
    assert split < 1e-5 < single, (split, single)


SSD_CELLS = [(2, 32, 3, 8, 16, 8), (1, 64, 2, 16, 8, 16), (2, 16, 4, 8, 32, 16)]


def _ssd_np(B, T, H, P, N, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, T, H, P)).astype(np.float32),
            rng.uniform(0.01, 0.2, size=(B, T, H)).astype(np.float32),
            (-rng.uniform(0.5, 2, size=(H,))).astype(np.float32),
            rng.normal(size=(B, T, N)).astype(np.float32),
            rng.normal(size=(B, T, N)).astype(np.float32))


@pytest.mark.parametrize("B,T,H,P,N,chunk", SSD_CELLS)
def test_ssd_chunk_plain(B, T, H, P, N, chunk):
    """The port's full SSD (plain intra-chunk step + inter-chunk scan) and
    its sequential oracle against the Pallas kernel in interpret mode and
    the JAX oracle, within the reference's 1e-4."""
    args = _ssd_np(B, T, H, P, N, B + T + H + P + N)
    jargs = [jnp.asarray(a) for a in args]
    targs = [torch.tensor(a) for a in args]
    want = np.asarray(r_ops.ssd_chunk(*jargs, chunk=chunk))
    np.testing.assert_allclose(np.asarray(r_ref.ssd_chunk(*jargs)), want,
                               rtol=1e-4, atol=1e-4)
    got = ops.ssd_chunk(*targs, chunk=chunk)
    assert got.dtype == torch.float32 and got.shape == (B, T, H, P)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(ref.ssd_chunk(*targs).numpy(), want,
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("B,T,H,P,N,chunk", SSD_CELLS)
def test_ssd_intra_chunk_plain_is_the_pallas_body(B, T, H, P, N, chunk):
    """y_intra, S and cd of the plain B10 against the Pallas kernel's three
    outputs (interpret mode) in its [BH, nc, ...] layout."""
    from repro.kernels.ssd_chunk import ssd_chunk_pallas
    x, dt, A, Bm, Cm = _ssd_np(B, T, H, P, N, T * H + N)
    nc = T // chunk
    N_ = Bm.shape[-1]
    xf = x.transpose(0, 2, 1, 3).reshape(B * H, nc, chunk, P)
    dtf = dt.transpose(0, 2, 1).reshape(B * H, nc, chunk)
    Bf = np.repeat(Bm.reshape(B, 1, nc, chunk, N_), H, 1).reshape(
        B * H, nc, chunk, N_)
    Cf = np.repeat(Cm.reshape(B, 1, nc, chunk, N_), H, 1).reshape(
        B * H, nc, chunk, N_)
    y_w, S_w, cd_w = (np.asarray(a) for a in ssd_chunk_pallas(
        jnp.asarray(xf), jnp.asarray(dtf), jnp.asarray(np.tile(A, B)),
        jnp.asarray(Bf), jnp.asarray(Cf), interpret=True))
    y, S, cd = ops.ssd_intra_chunk(*(torch.tensor(a) for a in
                                     (x, dt, A, Bm, Cm)), chunk=chunk)
    np.testing.assert_allclose(
        y.numpy().reshape(B, nc, chunk, H, P).transpose(0, 3, 1, 2, 4)
        .reshape(B * H, nc, chunk, P), y_w, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(
        S.numpy().transpose(0, 2, 1, 3, 4).reshape(B * H, nc, N_, P), S_w,
        rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(
        cd.numpy().reshape(B, nc, chunk, H).transpose(0, 3, 1, 2)
        .reshape(B * H, nc, chunk), cd_w, rtol=1e-5, atol=1e-6)
