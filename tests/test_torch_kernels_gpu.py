"""The port's CUDA kernels held against their plain PyTorch versions on the
card, at a small ragged shape and at the main path's shape.

Run on a machine with a CUDA device:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_kernels_gpu.py

Whether a card is present is decided inside the ``cuda`` fixture (never at
import or collection), so every worker collects the same tests; without a
card they skip with the reason.
"""

import math

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


def _b1_check(cuda, rng, B, k, block, lo, hi, wi, wj):
    q = torch.as_tensor(_bodies(rng, B, k, block), device=cuda)
    wi, wj = (torch.as_tensor(np.asarray(w, np.float32), device=cuda)
              for w in (wi, wj))
    got = ops.pairwise_batch_forces(q, lo, hi, wi, wj)
    want = ref.pairwise_batch_forces(q, lo, hi, wi, wj)
    assert float((got - want).abs().max() / want.abs().max()) < 1e-4
    return q, wi, wj, got


def test_pairwise_batch_every_pair_on_one_slot(cuda):
    """Every weighted side lands on slot 0 (the hi sides weigh 0 except
    on self pairs): the side pass's items all feed one slot, and slots 1
    and 2 stay exactly 0."""
    rng = np.random.default_rng(11)
    lo = np.array([0, 0, 0, 0, 0], np.int32)
    hi = np.array([0, 1, 2, 1, 0], np.int32)
    wi = rng.uniform(0.5, 2, (2, 5))
    wj = np.where(hi == lo, wi, 0.0)
    *_, got = _b1_check(cuda, rng, 2, 3, 700, lo, hi, wi, wj)
    assert torch.count_nonzero(got[:, 1:]) == 0


@pytest.mark.parametrize("same", [False, True])
def test_pairwise_batch_one_pair(cuda, same):
    rng = np.random.default_rng(12 + same)
    lo = np.array([1], np.int32)
    hi = np.array([1 if same else 0], np.int32)
    _b1_check(cuda, rng, 3, 2, 1000, lo, hi, rng.uniform(0.5, 2, (3, 1)),
              rng.uniform(0.5, 2, (3, 1)))


def test_pairwise_batch_zero_softening(cuda):
    """softening = 0 is not a normal float, so the side pass keeps
    rsqrtf's denormal handling (no self pair: every r2 > 0)."""
    rng = np.random.default_rng(14)
    q = torch.as_tensor(_bodies(rng, 2, 2, 300), device=cuda)
    lo, hi = np.array([0], np.int32), np.array([1], np.int32)
    w = torch.ones(2, 1, device=cuda)
    got = ops.pairwise_batch_forces(q, lo, hi, w, w, softening=0.0)
    want = ref.pairwise_batch_forces(q, lo, hi, w, w, softening=0.0)
    assert bool(torch.isfinite(got).all())
    assert float((got - want).abs().max() / want.abs().max()) < 1e-4


def test_pairwise_batch_bit_equal(cuda):
    """Two launches on the same inputs give the same bits (no float
    atomics; the reduction adds in pair order)."""
    sched = build_schedule(8)
    rng = np.random.default_rng(13)
    lo, hi = sched.pair_slots[:, 0], sched.pair_slots[:, 1]
    wi = pair_mask_table(sched)
    wj = np.where(sched.pair_diff == 0, 0, wi)
    q, wi, wj, got = _b1_check(cuda, rng, 8, sched.k, 2000, lo, hi, wi, wj)
    assert torch.equal(got, ops.pairwise_batch_forces(q, lo, hi, wi, wj))


@pytest.mark.parametrize("B,M,N,G", [(5, 70, 90, 33), (2, 64, 64, 16),
                                     (40, 1024, 1024, 512),
                                     # 128-row / -column tile edges, K past a
                                     # 32-deep slice, K % 4 != 0 (plain loads)
                                     (3, 127, 129, 513), (2, 129, 127, 127),
                                     (1, 513, 257, 129), (2, 128, 128, 16)])
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


def _b3_expected_visits(args):
    """visits as the plain version defines them: the first z whose
    one-column plain filter explains the pair, + 1; Z where none does; 0
    on the diagonal."""
    r_xy, rows_x, rows_y, gx, gy = args
    Z = rows_x.shape[-1]
    first = torch.full(r_xy.shape, Z, dtype=torch.int32, device=r_xy.device)
    for z in range(Z - 1, -1, -1):
        keep_z = ref.pcit_filter(r_xy, rows_x[..., z:z + 1],
                                 rows_y[..., z:z + 1], gx - z, gy - z)
        first = torch.where(keep_z, first, torch.full_like(first, z + 1))
    diag = gx[..., :, None] == gy[..., None, :]
    return torch.where(diag, torch.zeros_like(first), first)


def _b3_cell(cuda, Z, starts, kept=(), gx=None, gy=None, M=8,
             fill=0.9, a_lo=0.05, a_kept=0.95):
    """One block of 8 x 32 pairs (M = 8), rows of x all ``fill``; row y is 0
    (explains nothing) below starts[y] and ``fill`` from there, so an
    explained pair first explains at starts[y]; r_xy is ``a_lo`` but at
    the ``kept`` pairs (a_kept: explained by no z)."""
    N = len(starts)
    rows_x = torch.full((1, M, Z), fill, device=cuda)
    z = torch.arange(Z, device=cuda)
    st = torch.as_tensor(starts, device=cuda)
    rows_y = torch.where(z[None] >= st[:, None], fill, 0.0)[None].float()
    r_xy = torch.full((1, M, N), a_lo, device=cuda)
    for x, y in kept:
        r_xy[0, x, y] = a_kept
    gx = torch.as_tensor(gx if gx is not None else [Z + 10 + i for i in
                                                    range(M)],
                         device=cuda)[None]
    gy = torch.as_tensor(gy if gy is not None else [Z + 100 + i for i in
                                                    range(N)],
                         device=cuda)[None]
    return r_xy, rows_x, rows_y.contiguous(), gx, gy


def _b3_check(args, prefilter=True):
    """The kernel equals the plain version, and visits its definition."""
    visits = torch.empty(args[0].shape, dtype=torch.int32,
                         device=args[0].device)
    got = pcit_filter_cuda(*args, visits=visits, prefilter=prefilter)
    assert torch.equal(got, ref.pcit_filter(*args))
    assert torch.equal(visits, _b3_expected_visits(args))
    return got, visits


# starts at the head's edge (7, 8) and the lanes' (31, 32, 39, 40, 71, 72)
B3_EDGE_STARTS = [0, 1, 7, 8, 9, 31, 32, 33, 39, 40, 41, 63, 64, 71, 72, 95,
                  96, 2, 3, 5, 10, 20, 30, 45, 50, 60, 70, 80, 90, 99, 4, 6]


@pytest.mark.parametrize("Z", [5, 8, 9, 40, 41, 77, 100, 300])
@pytest.mark.parametrize("prefilter", [True, False])
def test_b3_ragged_z(cuda, Z, prefilter):
    """Z below the head, at it, past it and not a multiple of 32; pairs
    first explained at every head and lane edge that Z reaches, and two
    kept edges."""
    starts = [min(s, Z + 5) for s in B3_EDGE_STARTS]
    args = _b3_cell(cuda, Z, starts, kept=[(0, 3), (5, 17)])
    got, visits = _b3_check(args, prefilter)
    assert bool(got[0, 0, 3]) and bool(got[0, 5, 17])
    assert int(visits[0, 0, 3]) == Z


@pytest.mark.parametrize("excl", [(7, 8), (8, 9), (31, 32), (32, 33),
                                  (39, 40), (40, 41)])
def test_b3_exclusions_on_edges(cuda, excl):
    """gx / gy exclude exactly the z where a pair would first be explained,
    on the head's and the lanes' edges: the search goes on to the next z."""
    zx, zy = excl
    Z = 100
    starts = [zx if y % 2 else zy for y in range(32)]
    gx = [zx] * 4 + [Z + i for i in range(4)]
    gy = [zy if y % 3 == 0 else Z + 50 + y for y in range(32)]
    args = _b3_cell(cuda, Z, starts, gx=gx, gy=gy)
    _got, visits = _b3_check(args)
    # row 0 (gx = zx) on a column with start zx is first explained past zx
    assert int(visits[0, 0, 1]) > zx + 1


def test_b3_one_kept_edge_in_a_warp(cuda):
    """A warp (one x, 32 y) with exactly one kept edge among pairs all
    explained in the head: the kept edge alone goes on, to Z."""
    Z = 333
    args = _b3_cell(cuda, Z, [y % 5 for y in range(32)], kept=[(2, 19)])
    got, visits = _b3_check(args)
    assert int(got[0, 2].sum()) == 1 and bool(got[0, 2, 19])
    assert int((visits[0, 2] > 8).sum()) == 1


def test_b3_block_done_in_the_head(cuda):
    """Every pair of the block is explained within the head: no pair
    reaches the warp phase."""
    args = _b3_cell(cuda, 500, [y % 7 for y in range(32)])
    got, visits = _b3_check(args)
    assert not bool(got.any()) and int(visits.max()) <= 8


@pytest.mark.parametrize("fill,a_lo", [(0.99999994, 0.05), (1.0, 0.05),
                                       (-1.0, 0.3), (0.9, -1e-12),
                                       (-1e-12, 0.05), (0.999, 0.9999999),
                                       (2.0 ** -21, 0.05), (0.0, 0.0)])
def test_b3_prefilter_edges(cuda, fill, a_lo):
    """|r| at and near 1, r = -1e-12 (r + 1e-12 = 0), values below the
    prefilter's domain: such trios go to the exact chain, and the result is
    the plain version's."""
    Z = 70
    args = _b3_cell(cuda, Z, [y * 2 for y in range(32)], kept=[(1, 1)],
                    fill=fill, a_lo=a_lo)
    _b3_check(args)


def test_b3_prefilter_never_decides_against_exact(cuda):
    """The kernel's own prefilter (rsqrt.approx / rcp.approx, as compiled)
    on trios packed around their boundaries, random trios and edge values:
    every trio it decides, it decides as the exact chain; and the kernel's
    exact chain is the float32 chain op for op."""
    from test_torch_pcit import boundary_trios, edge_trios, exact_explains
    from repro_torch.kernels.pcit_filter import pcit_probe_cuda
    for seed in range(4):
        a, b, c = boundary_trios(np.random.default_rng(seed))
        n = a.size   # the last 20,000 are random trios
        if seed == 0:
            ea, eb, ec = edge_trios()
            a, b, c = (np.concatenate(t) for t in ((a, ea), (b, eb),
                                                    (c, ec)))
        ta, tb, tc = (torch.as_tensor(t, device=cuda) for t in (a, b, c))
        exact = pcit_probe_cuda(ta, tb, tc, exact=True).cpu().numpy()
        pre = pcit_probe_cuda(ta, tb, tc, exact=False).cpu().numpy()
        np.testing.assert_array_equal(exact, exact_explains(a, b, c))
        decided = pre >= 0
        assert bool((pre[decided] == exact[decided]).all())
        assert float(decided[n - 20000:n].mean()) > 0.99


def test_b3_stats(cuda):
    """The counters: every visited trio was evaluated and issued; with the
    prefilter off nothing is decided by it, and keep and visits are the
    same."""
    from repro_torch.kernels.pcit_filter import STATS
    R = torch.as_tensor(_corr_rows(np.random.default_rng(3), 2048, 64, 8),
                        dtype=torch.float32, device=cuda)
    ids = torch.arange(256, device=cuda)
    args = (R[None, :256, 512:768].contiguous(), R[None, :256],
            R[None, 512:768], ids[None], (ids + 512)[None])
    out = {}
    for pre in (True, False):
        stats = torch.empty(len(STATS), dtype=torch.int64, device=cuda)
        visits = torch.empty(1, 256, 256, dtype=torch.int32, device=cuda)
        keep = pcit_filter_cuda(*args, visits=visits, stats=stats,
                                prefilter=pre)
        out[pre] = keep, visits, dict(zip(STATS, stats.tolist()))
    assert torch.equal(out[True][0], out[False][0])
    assert torch.equal(out[True][1], out[False][1])
    assert torch.equal(out[True][0], ref.pcit_filter(*args))
    # visits count the excluded z (gx, gy) too, which are not evaluated
    trios = int(out[True][1].long().sum()) - 2 * out[True][1].numel()
    for pre in (True, False):
        st = out[pre][2]
        evaluated = st["prefilter_decided"] + st["exact_decided"]
        assert trios <= evaluated <= st["issued_lane_trios"]
    assert out[False][2]["prefilter_decided"] == 0
    assert out[True][2]["prefilter_decided"] > out[True][2]["exact_decided"]


def test_wrappers_count_launches(cuda):
    ops.reset_launch_counts()
    x = torch.zeros(1, 4, 3, device=cuda)
    ops.pairwise_corr(x, x)
    assert ops.launch_counts()["pairwise_corr"] == 1


def _query_inputs(rng, P, k, block, d, Q, integer, cuda):
    if integer:   # exact scores and many equal ones: ties break by index
        stack = rng.integers(-1, 2, size=(P, k, block, d))
        queries = rng.integers(-1, 2, size=(Q, d))
    else:
        stack = rng.normal(size=(P, k, block, d))
        queries = rng.normal(size=(Q, d))
    mask = (rng.uniform(size=(P, k, block)) > 0.2).astype(np.float32)
    mask[:, 0] = 0.0                       # a slot no device scores
    gidx = np.stack([rng.permutation(3 * k * block)[:k * block]
                     .reshape(k, block) for _ in range(P)])
    return (torch.as_tensor(stack, dtype=torch.float32, device=cuda),
            torch.as_tensor(queries, dtype=torch.float32, device=cuda),
            torch.as_tensor(mask, device=cuda),
            torch.as_tensor(gidx, dtype=torch.int32, device=cuda))


@pytest.mark.parametrize("P,k,block,d,Q,topk,integer", [
    (2, 3, 16, 8, 5, 4, False), (1, 4, 12, 24, 70, 8, False),
    (3, 5, 8, 4, 3, 40, False), (2, 3, 10000, 8, 33, 16, True),
    (1, 2, 9000, 16, 64, 128, True), (2, 4, 20000, 128, 256, 16, False),
    (1, 2, 5000, 32, 20, 1024, False),
    # the tile edges: Q past one 128-query tile, blocks ragged against
    # the 256-row tiles and the 4,096-row chunks, d not a multiple of 4
    # (plain loads), lists at the shared-memory limit (32) and past it
    (1, 2, 8449, 20, 200, 32, True), (2, 2, 4097, 37, 129, 33, True),
    (1, 3, 4351, 128, 300, 16, False),
    # topk 1024 over fewer rows: every candidate passes, the queues
    # fill and flush over many rounds
    (2, 2, 1000, 16, 130, 1024, True)])
@pytest.mark.parametrize("metric", ["dot", "l2"])
def test_query_topk(cuda, P, k, block, d, Q, topk, integer, metric):
    """B4 against its plain version: ragged Q and blocks, masked rows, a
    masked slot, topk above the candidates, exact ties across chunk lists,
    topk up to 1024."""
    rng = np.random.default_rng(P * 1000 + block + topk)
    args = _query_inputs(rng, P, k, block, d, Q, integer, cuda)
    got_v, got_i = ops.query_topk(*args, topk=topk, metric=metric)
    want_v, want_i = ref.query_topk(*args, topk=topk, metric=metric)
    torch.testing.assert_close(got_v, want_v, rtol=1e-5, atol=1e-5)
    if integer:   # every score exact: the order must be too
        assert torch.equal(got_i, want_i)
    else:
        _assert_near_ties(args, got_i, want_v, want_i, metric)


def _assert_near_ties(args, got_i, want_v, want_i, metric):
    """Where the kernel's fp32 accumulation orders two candidates other
    than cuBLAS's did, the plain score of the kernel's pick must lie within
    1e-5 * max(1, |s|) of the wanted score at that rank (or both of the
    k-th score)."""
    stack, queries, _mask, gidx = args
    P, k, block, d = stack.shape
    diff = got_i != want_i
    if not bool(diff.any()):
        return
    assert bool((got_i[diff] != ref.IDX_SENTINEL).all())
    inv = torch.zeros(P, int(gidx.max()) + 1, dtype=torch.long,
                      device=stack.device)
    inv.scatter_(1, gidx.reshape(P, -1).long(),
                 torch.arange(k * block, device=stack.device).expand(P, -1))
    ids = torch.where(diff, got_i, gidx.reshape(P, -1)[:, :1, None]).long()
    pos = inv.gather(1, ids.reshape(P, -1)).reshape(ids.shape)
    rows = torch.stack([stack[p].reshape(-1, d)[pos[p]] for p in range(P)])
    s = torch.einsum("qd,pqtd->pqt", queries, rows)
    if metric == "l2":
        s = (2.0 * s - (rows * rows).sum(-1)
             - (queries * queries).sum(-1)[None, :, None])
    tol = 1e-5 * torch.clamp(want_v.abs(), min=1.0)
    kth = want_v[..., -1:].expand_as(want_v)
    ok = ((s - want_v).abs() <= tol) | (((s - kth).abs() <= tol)
                                        & ((want_v - kth).abs() <= tol))
    assert bool(ok[diff].all()), int((diff & ~ok).sum())


def test_query_topk_refuses_large_topk(cuda):
    args = _query_inputs(np.random.default_rng(0), 1, 2, 8, 4, 3, False,
                         cuda)
    with pytest.raises(ValueError, match="topk"):
        ops.query_topk(*args, topk=1025)


def _threshold_inputs(rng, P, k, block, d, n_pairs, integer, cuda):
    if integer:
        quorum = rng.integers(-2, 3, size=(P, k, block, d))
    else:
        quorum = rng.normal(size=(P, k, block, d))
    lo = rng.integers(0, k, size=n_pairs).astype(np.int32)
    hi = rng.integers(0, k, size=n_pairs).astype(np.int32)
    lo[0] = hi[0] = 0
    meta = np.stack([
        rng.uniform(size=(P, n_pairs)) > 0.2,
        np.broadcast_to(lo == hi, (P, n_pairs)),
        rng.integers(0, 2 * n_pairs, size=(P, n_pairs)),
        rng.integers(0, 2 * n_pairs, size=(P, n_pairs)),
        np.minimum(block, rng.integers(1, block + 40, size=(P, n_pairs))),
        np.minimum(block, rng.integers(1, block + 40, size=(P, n_pairs))),
    ], axis=-1).astype(np.int32)
    meta[:, 0, 0] = 1
    return (torch.as_tensor(quorum, dtype=torch.float32, device=cuda), lo, hi,
            torch.as_tensor(meta, device=cuda))


@pytest.mark.parametrize("P,k,block,d,n_pairs,capacity,integer", [
    (2, 3, 16, 8, 4, 256, False), (1, 4, 12, 24, 6, 64, False),
    (3, 5, 8, 16, 8, 16, False), (2, 3, 300, 8, 5, 4000, True),
    (2, 3, 300, 8, 5, 700, True), (1, 3, 3000, 64, 4, 1 << 16, True)])
@pytest.mark.parametrize("metric", ["dot", "l2"])
def test_pairwise_threshold(cuda, P, k, block, d, n_pairs, capacity, integer,
                            metric):
    """B5 against its plain version: inactive and self tiles, ragged
    nv_lo / nv_hi, repeated pairs, and overflowing capacities, where the
    kept entries must be the same first-capacity prefix."""
    rng = np.random.default_rng(P * 1000 + block + capacity)
    quorum, lo, hi, meta = _threshold_inputs(rng, P, k, block, d, n_pairs,
                                             integer, cuda)
    s = ref.tile_scores(quorum[0, 0], quorum[0, -1], metric)
    thr = float(torch.quantile(s.flatten()[:100000], 0.9))
    kw = dict(threshold=thr, capacity=capacity, block_rows=block,
              metric=metric)
    got = ops.pairwise_threshold(quorum, lo, hi, meta, **kw)
    want = ref.pairwise_threshold(quorum, lo, hi, meta, **kw)
    assert torch.equal(got[3], want[3])
    assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])
    torch.testing.assert_close(got[0], want[0], rtol=1e-5, atol=1e-5)


def test_new_wrappers_count_launches(cuda):
    ops.reset_launch_counts()
    args = _query_inputs(np.random.default_rng(0), 1, 2, 8, 4, 3, False,
                         cuda)
    ops.query_topk(*args, topk=2)
    quorum, lo, hi, meta = _threshold_inputs(np.random.default_rng(0), 1, 2,
                                             8, 4, 2, False, cuda)
    ops.pairwise_threshold(quorum, lo, hi, meta, threshold=0.0, capacity=8,
                           block_rows=8)
    counts = ops.launch_counts()
    assert counts["query_topk"] == 1 and counts["pairwise_threshold"] == 1


def _pair_inputs(rng, P, k, block, d, n_pairs, integer, self_only, cuda):
    """B6-B8 cells: B5's pair layout, or self tiles only."""
    quorum, lo, hi, meta = _threshold_inputs(rng, P, k, block, d, n_pairs,
                                             integer, cuda)
    if self_only:
        lo = hi = np.arange(n_pairs, dtype=np.int32) % k
        meta[..., 1] = 1
        meta[..., 3] = meta[..., 2]
        meta[..., 5] = meta[..., 4]
    return quorum, lo, hi, meta


def _quantized(quorum, qmode):
    """Codes, [P, k, 2] (scale, delta), l1 and sq of a float quorum."""
    if qmode == "int8":
        scale = quorum.abs().amax(dim=(2, 3)).clamp(min=1e-30) / 127.0
        codes = torch.clamp(torch.round(quorum / scale[..., None, None]),
                            -127, 127).to(torch.int8)
    else:
        scale = torch.ones(quorum.shape[:2], device=quorum.device)
        codes = quorum.to(torch.bfloat16)
    sd = torch.stack([scale, scale / 2], dim=-1)
    return codes, sd, quorum.abs().sum(-1), (quorum * quorum).sum(-1)


def _assert_lists_near(got_v, got_i, want_v, want_i):
    """B6 / bf16 lists against the plain version's: values within 1e-5 *
    max(1, |s|) rank by rank, and where the ids differ the wanted score at
    that rank has a near-tie partner (another listed score, or the k-th,
    within the same tolerance) that fp32 summation order may flip."""
    tol = 1e-5 * torch.clamp(want_v.abs(), min=1.0)
    assert bool(((got_v - want_v).abs() <= tol).all())
    diff = got_i != want_i
    if not bool(diff.any()):
        return
    gap = (want_v[..., :, None] - want_v[..., None, :]).abs()
    eye = torch.eye(want_v.shape[-1], dtype=torch.bool,
                    device=want_v.device)
    partner = ((gap <= tol[..., None]) & ~eye).any(-1)
    kth = (want_v - want_v[..., -1:]).abs() <= tol
    assert bool((partner | kth)[diff].all()), int(diff.sum())


PAIR_CELLS = [(2, 3, 16, 8, 4, False, False), (1, 4, 100, 24, 6, True, False),
              (2, 3, 300, 128, 5, False, False),
              (1, 3, 300, 16, 5, True, True), (2, 2, 77, 32, 3, False, True)]
# B8's tensor-core tile edges: 128-row tiles, 128-byte d slices (d 40: 40
# / 80 bytes; d 256: int8 resident in two slices, bf16 streamed in four,
# chunks of 32 joined in float32, compensated), plain loads (d 24),
# self-only schedules
B8_CELLS = PAIR_CELLS + [(1, 3, 300, 40, 5, True, False),
                         (1, 2, 200, 256, 3, False, False),
                         (2, 2, 260, 40, 3, True, True),
                         (1, 2, 129, 24, 4, False, True)]
# the int8 float32-exactness limit: d 1,040 and 1,041, both on the tensor
# cores (own rows streamed); at these values every dot stays below 2^24,
# so the lists equal the plain version's on either side.  int8 only: bf16
# sums of 1,040 products in another order than the plain version's move
# scores near zero by up to 9.2e-5 even on the float32 fmaf chain
# (PERF.md); test_pair_q_wide_rows holds bf16 there
B8_INT8_CELLS = [(1, 2, 200, 1040, 3, False, False),
                 (1, 2, 150, 1041, 3, True, False)]


@pytest.mark.parametrize("P,k,block,d,n_pairs,integer,self_only", PAIR_CELLS)
@pytest.mark.parametrize("topk", [1, 10, 2048])
@pytest.mark.parametrize("metric", ["dot", "l2"])
def test_pairwise_topk(cuda, P, k, block, d, n_pairs, integer, self_only,
                       topk, metric):
    """B6 against its plain version: inactive, self and ragged tiles,
    tie-heavy integer data (exact order), and topk up to 2048 (no
    ceiling: the lists live in global memory)."""
    rng = np.random.default_rng(P * 100 + block + topk)
    quorum, lo, hi, meta = _pair_inputs(rng, P, k, block, d, n_pairs,
                                        integer, self_only, cuda)
    kw = dict(topk=topk, block_rows=block, metric=metric)
    got = ops.pairwise_topk(quorum, lo, hi, meta, **kw)
    want = ref.pairwise_topk(quorum, lo, hi, meta, **kw)
    if integer:
        assert torch.equal(got[1], want[1]) and torch.equal(got[0], want[0])
    else:
        _assert_lists_near(*got, *want)


# B6's tile edges: blocks of 127 / 128 / 129 / 257 own rows (128-row
# blocks) and candidates (256-candidate tiles), d past a 32-deep slice and
# d % 4 != 0 (plain loads), self-only schedules; small-integer data, so
# every score is exact and ties are many
B6_CELLS = [(1, 2, 127, 33, 3, True, False), (2, 2, 128, 32, 3, True, True),
            (1, 3, 129, 8, 4, True, False), (1, 2, 257, 130, 3, True, False),
            (1, 2, 257, 24, 3, True, True), (2, 3, 129, 5, 5, True, True)]


@pytest.mark.parametrize("P,k,block,d,n_pairs,integer,self_only", B6_CELLS)
@pytest.mark.parametrize("topk", [1, 10, 32, 33, 512, 2048])
@pytest.mark.parametrize("metric", ["dot", "l2"])
def test_pairwise_topk_tile_edges(cuda, P, k, block, d, n_pairs, integer,
                                  self_only, topk, metric):
    """B6 at its 128-row and 256-candidate edges, lists in shared memory
    (topk <= 32) and in global memory (33 and above): identical lists,
    ties included."""
    rng = np.random.default_rng(P * 700 + block + topk + d)
    quorum, lo, hi, meta = _pair_inputs(rng, P, k, block, d, n_pairs,
                                        integer, self_only, cuda)
    kw = dict(topk=topk, block_rows=block, metric=metric)
    got = ops.pairwise_topk(quorum, lo, hi, meta, **kw)
    want = ref.pairwise_topk(quorum, lo, hi, meta, **kw)
    assert torch.equal(got[1], want[1]) and torch.equal(got[0], want[0])


@pytest.mark.parametrize("metric", ["dot", "l2"])
def test_pairwise_topk_score_only(cuda, metric):
    """The scoring pass alone (a measurement) finds each row's best score,
    the head of its list, and does not count as a launch of B6."""
    from repro_torch.kernels.pairwise_topk import (
        pairwise_topk_score_only_cuda)
    quorum, lo, hi, meta = _pair_inputs(np.random.default_rng(4), 2, 3, 300,
                                        40, 5, True, False, cuda)
    kw = dict(topk=4, block_rows=300, metric=metric)
    ops.reset_launch_counts()
    best = pairwise_topk_score_only_cuda(quorum, lo, hi, meta, **kw)
    assert ops.launch_counts()["pairwise_topk"] == 0
    want = ref.pairwise_topk(quorum, lo, hi, meta, **kw)[0][..., 0]
    has = want > ref.NEG_INF
    assert torch.equal(best[has], want[has])
    assert bool((best[~has] == -float("inf")).all())


@pytest.mark.parametrize("P,k,block,d,n_pairs,integer,self_only", B8_CELLS)
@pytest.mark.parametrize("topk", [1, 10, 16, 512, 2048])
@pytest.mark.parametrize("qmode", ["int8", "bf16"])
@pytest.mark.parametrize("metric", ["dot", "l2"])
def test_pairwise_topk_q(cuda, P, k, block, d, n_pairs, integer, self_only,
                         topk, qmode, metric):
    """B8 against its plain version: int8 lists identical (ties included),
    on both routes; bf16 within the near-tie rule; lists in shared memory
    (topk <= 32) and in global memory."""
    rng = np.random.default_rng(P * 300 + block + topk)
    quorum, lo, hi, meta = _pair_inputs(rng, P, k, block, d, n_pairs,
                                        integer, self_only, cuda)
    codes, sd, _l1, sq = _quantized(quorum, qmode)
    kw = dict(topk=topk, block_rows=block, metric=metric)
    got = ops.pairwise_topk_q(codes, sd, sq, lo, hi, meta, **kw)
    want = ref.pairwise_topk_q(codes, sd[..., 0], sq, lo, hi, meta, **kw)
    if qmode == "int8":
        assert torch.equal(got[1], want[1]) and torch.equal(got[0], want[0])
    else:
        _assert_lists_near(*got, *want)


@pytest.mark.parametrize("P,k,block,d,n_pairs,integer,self_only", PAIR_CELLS)
@pytest.mark.parametrize("capacity", [37, 1 << 16])
@pytest.mark.parametrize("qmode", ["int8", "bf16"])
@pytest.mark.parametrize("metric", ["dot", "l2"])
def test_pairwise_threshold_q(cuda, P, k, block, d, n_pairs, integer,
                              self_only, capacity, qmode, metric):
    """B7 against its plain version: the int8 band, its order and its
    overflow prefix identical; bf16 may differ only at the band's edge,
    where fp32 summation order decides."""
    rng = np.random.default_rng(P * 500 + block + capacity)
    quorum, lo, hi, meta = _pair_inputs(rng, P, k, block, d, n_pairs,
                                        integer, self_only, cuda)
    codes, sd, l1, sq = _quantized(quorum, qmode)
    s = ref.tile_scores(quorum[0, 0], quorum[0, -1], metric)
    kw = dict(threshold=float(torch.quantile(s.flatten()[:100000], 0.9)),
              capacity=capacity, block_rows=block, metric=metric)
    got = ops.pairwise_threshold_q(codes, sd, l1, sq, lo, hi, meta, **kw)
    want = ref.pairwise_threshold_q(codes, sd[..., 0], sd[..., 1], l1, sq,
                                    lo, hi, meta, **kw)
    if qmode == "int8" or torch.equal(got[3], want[3]):
        assert torch.equal(got[3], want[3])
        assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])
        if qmode == "int8":
            assert torch.equal(got[0], want[0])
        torch.testing.assert_close(got[0], want[0], rtol=1e-5, atol=1e-5)
    else:
        n = want[3].to(torch.float32)
        assert bool(((got[3] - want[3]).abs() <= 1e-4 * n + 2).all())
    if capacity == 37:
        assert bool((want[3] > capacity).any())     # an overflowing cell


@pytest.mark.parametrize("P,k,block,d,n_pairs,integer,self_only",
                         B8_INT8_CELLS)
@pytest.mark.parametrize("topk", [1, 16, 512, 2048])
@pytest.mark.parametrize("metric", ["dot", "l2"])
def test_pairwise_topk_q_int8_limit(cuda, P, k, block, d, n_pairs, integer,
                                    self_only, topk, metric):
    """int8 at the exactness limit: lists identical on both routes."""
    rng = np.random.default_rng(P * 300 + block + topk)
    quorum, lo, hi, meta = _pair_inputs(rng, P, k, block, d, n_pairs,
                                        integer, self_only, cuda)
    codes, sd, _l1, sq = _quantized(quorum, "int8")
    kw = dict(topk=topk, block_rows=block, metric=metric)
    got = ops.pairwise_topk_q(codes, sd, sq, lo, hi, meta, **kw)
    want = ref.pairwise_topk_q(codes, sd[..., 0], sq, lo, hi, meta, **kw)
    assert torch.equal(got[1], want[1]) and torch.equal(got[0], want[0])


@pytest.mark.parametrize("d", [1040, 1041])
def test_pairwise_topk_q_routes(cuda, d):
    """The int8 call on each side of the old 1,040 limit runs the
    tensor-core kernel (the route reaches 66,572), counts one launch and
    equals the plain version; the SIMT route, asked for by name, gives the
    same lists at the same shape (every dot here is below 2^24)."""
    from repro_torch.kernels.pairwise_batch_q import (INT8_TC_MAX_D,
                                                      pairwise_topk_q_cuda,
                                                      route_of)
    quorum, lo, hi, meta = _pair_inputs(np.random.default_rng(d), 1, 2, 64, d,
                                        2, False, False, cuda)
    codes, sd, _l1, sq = _quantized(quorum, "int8")
    ops.reset_launch_counts()
    got = ops.pairwise_topk_q(codes, sd, sq, lo, hi, meta, topk=5,
                              block_rows=64)
    want = ref.pairwise_topk_q(codes, sd[..., 0], sq, lo, hi, meta, topk=5,
                               block_rows=64)
    assert ops.launch_counts()["pairwise_topk_q"] == 1
    assert route_of(torch.int8, d) == "tensor_cores" and d <= INT8_TC_MAX_D
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    other = pairwise_topk_q_cuda(codes, sd, sq, lo, hi, meta, topk=5,
                                 block_rows=64, route="simt")
    assert torch.equal(other[0], want[0]) and torch.equal(other[1], want[1])


def _exact_q_dots(qf, scale, l, h, r0, r1):
    """``ref._q_dots`` with the code dot evaluated in float64 and rounded
    once to float32."""
    dots = (qf[:, l, r0:r1].double()
            @ qf[:, h].double().transpose(-1, -2)).float()
    return dots * (scale[:, l] * scale[:, h])[:, None, None]


# past the old route limits (bf16 128, int8 1,040), on the tensor cores:
# bf16 d 200 (not a multiple of 16: plain loads), 960 (gist-960) and
# 4,096; int8 d 1,536 (1,536-wide embeddings), dots past 2^24
WIDE_CELLS = [("bf16", 200), ("bf16", 960), ("bf16", 4096), ("int8", 1536)]


def _wide_inputs(qmode, d, cuda):
    rng = np.random.default_rng(d)
    quorum, lo, hi, meta = _pair_inputs(rng, 1, 3, 150, d, 5, False, False,
                                        cuda)
    if qmode == "int8":   # near-equal positive codes: dots near d * 124^2
        quorum = 127.0 - torch.as_tensor(
            rng.integers(0, 8, size=tuple(quorum.shape)), dtype=torch.float32,
            device=cuda)
    return (quorum, lo, hi, meta) + _quantized(quorum, qmode)


@pytest.mark.parametrize("qmode,d", WIDE_CELLS)
@pytest.mark.parametrize("metric", ["dot", "l2"])
def test_pair_q_wide_rows(cuda, qmode, d, metric):
    """B8 and B7 at wide rows on route_of's route (the tensor cores).
    int8: the lists and the band equal the plain version with its dot
    evaluated in float64 and rounded once (its own float32 sum depends on
    its order there).  bf16: the lists are no further from that float64
    evaluation, rank by rank, than the plain float32 version's (and within
    its tie rule at d <= 256), and the band differs from the plain
    version's only at its edge."""
    from unittest import mock

    from repro_torch.kernels.pairwise_batch_q import route_of
    quorum, lo, hi, meta, codes, sd, l1, sq = _wide_inputs(qmode, d, cuda)
    assert route_of(codes.dtype, d) == "tensor_cores"
    kw = dict(topk=16, block_rows=150, metric=metric)
    got = ops.pairwise_topk_q(codes, sd, sq, lo, hi, meta, **kw)
    plain = ref.pairwise_topk_q(codes, sd[..., 0], sq, lo, hi, meta, **kw)
    with mock.patch.object(ref, "_q_dots", _exact_q_dots):
        exact = ref.pairwise_topk_q(codes, sd[..., 0], sq, lo, hi, meta, **kw)
        s = ref.tile_scores(quorum[0, 0], quorum[0, -1], metric)
        kw7 = dict(threshold=float(torch.quantile(s.flatten(), 0.9)),
                   capacity=1 << 16, block_rows=150, metric=metric)
        exact7 = ref.pairwise_threshold_q(codes, sd[..., 0], sd[..., 1], l1,
                                          sq, lo, hi, meta, **kw7)
    got7 = ops.pairwise_threshold_q(codes, sd, l1, sq, lo, hi, meta, **kw7)
    if qmode == "int8":
        assert torch.equal(got[0], exact[0]) and torch.equal(got[1], exact[1])
        assert all(torch.equal(a, b) for a, b in zip(got7, exact7))
        return
    real = exact[0] > -1e29
    err = float((got[0] - exact[0]).abs()[real].max())
    err_plain = float((plain[0] - exact[0]).abs()[real].max())
    assert err <= err_plain, (err, err_plain)
    if d <= 256:
        _assert_lists_near(*got, *plain)
    plain7 = ref.pairwise_threshold_q(codes, sd[..., 0], sd[..., 1], l1, sq,
                                      lo, hi, meta, **kw7)
    n = plain7[3].to(torch.float32)
    assert bool(((got7[3] - plain7[3]).abs() <= 1e-4 * n + 2).all())


def test_pair_kernels_count_launches(cuda):
    """Each of B6-B8 counts one launch per call, and only there."""
    quorum, lo, hi, meta = _pair_inputs(np.random.default_rng(0), 1, 2, 8, 4,
                                        2, False, False, cuda)
    codes, sd, l1, sq = _quantized(quorum, "int8")
    ops.reset_launch_counts()
    ref.pairwise_topk(quorum, lo, hi, meta, topk=2, block_rows=8)
    assert sum(ops.launch_counts().values()) == 0
    ops.pairwise_topk(quorum, lo, hi, meta, topk=2, block_rows=8)
    ops.pairwise_topk_q(codes, sd, sq, lo, hi, meta, topk=2, block_rows=8)
    ops.pairwise_topk_q(codes, sd, sq, lo, hi, meta, topk=3, block_rows=8)
    ops.pairwise_threshold_q(codes, sd, l1, sq, lo, hi, meta, threshold=0.0,
                             capacity=8, block_rows=8)
    counts = ops.launch_counts()
    assert (counts["pairwise_topk"], counts["pairwise_topk_q"],
            counts["pairwise_threshold_q"]) == (1, 2, 1)


# B5 / B7 around their 128-row strips and 128-column tiles (B7's SIMT route:
# 64): blocks of 1, 127, 129 and 300 rows, d of 1, 33 and 130 (bf16 at
# d 130 streamed, in chunks of 32 joined in float32); small-integer data,
# so every score is exact
RAGGED_CELLS = [(1, 2, 1, 1, 3, False), (2, 3, 127, 33, 5, False),
                (1, 3, 129, 130, 5, False), (2, 3, 300, 1, 5, True),
                (1, 3, 300, 33, 4, True), (1, 2, 129, 130, 3, False)]


def _ragged_inputs(seed, P, k, block, d, n_pairs, self_only, cuda):
    return _pair_inputs(np.random.default_rng(seed), P, k, block, d, n_pairs,
                        True, self_only, cuda)


def _overflow_capacity(counts) -> int:
    """A capacity that half the busiest device's entries overflow."""
    return max(1, int(counts.max()) // 2)


def _deep_tile_inputs(cuda):
    """One slot pair (and a self pair) whose only survivors off the
    diagonal sit in one deep column tile: slot 0's rows 0..127 (strip 0)
    and 300..310 (strip 2) are ones, slot 1's rows 520..540 (column tile
    4 of 5) are twos, everything else zero; at threshold 1 (dot) the
    cross pair keeps exactly those rows against column tile 4."""
    q = torch.zeros(1, 2, 600, 8, device=cuda)
    q[0, 0, :128] = 1.0
    q[0, 0, 300:311] = 1.0
    q[0, 1, 520:541] = 2.0
    meta = torch.tensor([[[1, 0, 0, 1, 600, 600], [1, 1, 0, 0, 600, 600]]],
                        dtype=torch.int32, device=cuda)
    return q, [0, 0], [1, 0], meta


@pytest.mark.parametrize("P,k,block,d,n_pairs,self_only", RAGGED_CELLS)
@pytest.mark.parametrize("metric", ["dot", "l2"])
def test_pairwise_threshold_ragged(cuda, P, k, block, d, n_pairs, self_only,
                                   metric):
    """B5 at ragged strips and tiles: identical buffers and counts, with a
    large capacity and with one that overflows (the exact prefix)."""
    quorum, lo, hi, meta = _ragged_inputs(block + d, P, k, block, d,
                                          n_pairs, self_only, cuda)
    kw = dict(threshold=1.0, block_rows=block, metric=metric)
    want = ref.pairwise_threshold(quorum, lo, hi, meta, capacity=1 << 16,
                                  **kw)
    for cap in (1 << 16, _overflow_capacity(want[3])):
        got = ops.pairwise_threshold(quorum, lo, hi, meta, capacity=cap,
                                     **kw)
        want = ref.pairwise_threshold(quorum, lo, hi, meta, capacity=cap,
                                      **kw)
        assert all(torch.equal(a, b) for a, b in zip(got, want)), cap


@pytest.mark.parametrize("P,k,block,d,n_pairs,self_only", RAGGED_CELLS)
@pytest.mark.parametrize("qmode", ["int8", "bf16"])
@pytest.mark.parametrize("metric", ["dot", "l2"])
def test_pairwise_threshold_q_ragged(cuda, P, k, block, d, n_pairs,
                                     self_only, qmode, metric):
    """B7 at ragged strips and tiles on the route route_of picks: int8 dots
    are exact s32 sums, and small integers are exact in bf16 with exact
    sums, so both bands equal the plain version's bit for bit, overflow
    prefix included."""
    quorum, lo, hi, meta = _ragged_inputs(block + d + 7, P, k, block, d,
                                          n_pairs, self_only, cuda)
    codes, sd, l1, sq = _quantized(quorum, qmode)
    kw = dict(threshold=1.0, block_rows=block, metric=metric)
    want = ref.pairwise_threshold_q(codes, sd[..., 0], sd[..., 1], l1, sq,
                                    lo, hi, meta, capacity=1 << 16, **kw)
    for cap in (1 << 16, _overflow_capacity(want[3])):
        got = ops.pairwise_threshold_q(codes, sd, l1, sq, lo, hi, meta,
                                       capacity=cap, **kw)
        want = ref.pairwise_threshold_q(codes, sd[..., 0], sd[..., 1], l1,
                                        sq, lo, hi, meta, capacity=cap, **kw)
        assert all(torch.equal(a, b) for a, b in zip(got, want)), cap


@pytest.mark.parametrize("capacity", [1 << 12, 50])
@pytest.mark.parametrize("kernel", ["f32", "int8", "bf16"])
def test_threshold_deep_hot_tile(cuda, capacity, kernel):
    """Strips whose only survivors sit in one deep column tile: the write
    pass skips the cold tiles before it and every rank stays the plain
    version's, also when capacity 50 cuts the buffer inside that tile."""
    quorum, lo, hi, meta = _deep_tile_inputs(cuda)
    kw = dict(threshold=1.0, capacity=capacity, block_rows=600,
              metric="dot")
    if kernel == "f32":
        got = ops.pairwise_threshold(quorum, lo, hi, meta, **kw)
        want = ref.pairwise_threshold(quorum, lo, hi, meta, **kw)
    else:
        codes, sd, l1, sq = _quantized(quorum, kernel)
        if kernel == "bf16":   # core/quant.py's bf16 step: maxabs * 2^-8
            sd[..., 1] = quorum.abs().amax(dim=(2, 3)) * 2.0 ** -8
        got = ops.pairwise_threshold_q(codes, sd, l1, sq, lo, hi, meta, **kw)
        want = ref.pairwise_threshold_q(codes, sd[..., 0], sd[..., 1], l1,
                                        sq, lo, hi, meta, **kw)
    # the cross pair: 139 rows x 21 columns; the self pair: C(139, 2)
    assert int(want[3][0]) == 139 * 21 + 139 * 138 // 2
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("qmode,d", [("int8", 1040), ("int8", 1041),
                                     ("bf16", 128), ("bf16", 129)])
def test_pairwise_threshold_q_routes(cuda, qmode, d):
    """B7 on each side of each route limit counts one launch a call; int8
    equals the plain version on both routes, bf16 up to the band's edge;
    and the two routes agree with each other at the same shape."""
    from repro_torch.kernels.pairwise_batch_q import (
        pairwise_threshold_q_cuda, route_of)
    quorum, lo, hi, meta = _pair_inputs(np.random.default_rng(d), 1, 2, 150,
                                        d, 3, False, False, cuda)
    codes, sd, l1, sq = _quantized(quorum, qmode)
    s = ref.tile_scores(quorum[0, 0], quorum[0, -1], "dot")
    kw = dict(threshold=float(torch.quantile(s.flatten(), 0.9)),
              capacity=1 << 16, block_rows=150, metric="dot")
    ops.reset_launch_counts()
    got = ops.pairwise_threshold_q(codes, sd, l1, sq, lo, hi, meta, **kw)
    assert ops.launch_counts()["pairwise_threshold_q"] == 1
    want = ref.pairwise_threshold_q(codes, sd[..., 0], sd[..., 1], l1, sq,
                                    lo, hi, meta, **kw)
    # every published width is on the tensor cores (the old limits were
    # 1,040 and 128); the SIMT route runs only by name
    assert route_of(codes.dtype, d) == "tensor_cores"
    other = pairwise_threshold_q_cuda(
        codes, sd, l1, sq, lo, hi, meta, route="simt"
        if route_of(codes.dtype, d) == "tensor_cores" else "tensor_cores",
        **kw)
    if qmode == "int8":
        assert all(torch.equal(a, b) for a, b in zip(got, want))
        assert all(torch.equal(a, b) for a, b in zip(other, want))
    else:
        for g in (got, other):
            n = want[3].to(torch.float32)
            assert bool(((g[3] - want[3]).abs() <= 1e-4 * n + 2).all())


# ---------------------------------------------------------------------------
# B9 flash_attention, B10 ssd_chunk
# ---------------------------------------------------------------------------

FLASH_CELLS = [(2, 100, 100, 2, 1, 64),    # ragged (not multiples of 64)
               (1, 70, 200, 1, 5, 80),     # Tq < Tk, end-aligned; hd 80
               (2, 130, 130, 2, 5, 128),   # GQA G = 5
               (1, 96, 40, 1, 5, 64),      # Tq > Tk: causal rows see no key
               # the wgmma kernel's edges: 128-row blocks of two 64-row
               # warpgroups, 64- (hd <= 128) or 32-key (hd 256) tiles, hd
               # padded to 64 / 128 / 256, plain loads where hd % 8 != 0
               (1, 127, 127, 1, 2, 16), (1, 128, 128, 2, 1, 96),
               (2, 129, 129, 1, 3, 128), (1, 257, 257, 1, 2, 64),
               (1, 129, 257, 1, 2, 256), (1, 257, 127, 1, 1, 128),
               (1, 127, 129, 2, 5, 256), (1, 129, 129, 1, 2, 36)]


def _qkv(cuda, B, Tq, Tk, KV, G, hd, dtype, seed):
    g = torch.Generator(device=cuda).manual_seed(seed)
    q = torch.randn(B, Tq, KV * G, hd, device=cuda, generator=g).to(dtype)
    k = torch.randn(B, Tk, KV, hd, device=cuda, generator=g).to(dtype)
    v = torch.randn(B, Tk, KV, hd, device=cuda, generator=g).to(dtype)
    return q, k, v


@pytest.mark.parametrize("B,Tq,Tk,KV,G,hd", FLASH_CELLS)
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention(cuda, B, Tq, Tk, KV, G, hd, causal, dtype):
    """Normalized epilogue against the plain softmax: within 1e-5 in f32,
    and within one bf16 ulp of the value (2^-7 relative, plus 1e-5) in
    bf16, where both round an f32 result to the output's dtype."""
    q, k, v = _qkv(cuda, B, Tq, Tk, KV, G, hd, dtype, Tq + hd)
    got = ops.flash_attention(q, k, v, causal=causal)
    want = ref.flash_attention(q, k, v, causal=causal)
    assert got.dtype == dtype and got.shape == want.shape
    rtol = 1e-5 if dtype == torch.float32 else 2.0 ** -7
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol,
                               atol=1e-5)


# hd 256 over a whole 4,096-key quorum block: 128 tiles of 32 keys, each
# tile's P V joining O by one f32 fmaf (ROADMAP C.1)
FLASH_PART_CELLS = FLASH_CELLS + [(1, 4096, 4096, 1, 2, 256)]


@pytest.mark.parametrize("B,Tq,Tk,KV,G,hd", FLASH_PART_CELLS)
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_partial(cuda, B, Tq, Tk, KV, G, hd, causal, dtype):
    """Partial epilogue (o unnormalized, m, l in float32) against the plain
    flash block: both widen the same inputs to float32, so only the
    summation order differs (1e-5 relative to each output's scale)."""
    q, k, v = _qkv(cuda, B, Tq, Tk, KV, G, hd, dtype, Tk + hd)
    o, m, l = ops.flash_block(q, k, v, causal=causal)
    wo, wm, wl = ref.flash_block(q, k, v, causal=causal)
    torch.testing.assert_close(m, wm, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(l, wl, rtol=1e-5, atol=1e-5)
    scale = float(wo.abs().max())
    torch.testing.assert_close(o, wo, rtol=1e-5, atol=1e-5 * max(1.0, scale))
    if causal and Tq > Tk:   # rows that see no key: p = 1 on every key
        blind = Tq - Tk
        assert bool((m[:, :blind] == -1e30).all())
        assert bool((l[:, :blind] == Tk).all())


def test_flash_row_valid_writes_identity(cuda):
    q, k, v = _qkv(cuda, 6, 130, 130, 2, 5, 128, torch.bfloat16, 3)
    valid = torch.tensor([1, 0, 1, 1, 0, 0], device=cuda)
    o, m, l = ops.flash_block(q, k, v, causal=True, row_valid=valid)
    fo, fm, fl = ops.flash_block(q, k, v, causal=True)
    on = valid.bool()
    assert torch.equal(o[on], fo[on]) and torch.equal(m[on], fm[on]) \
        and torch.equal(l[on], fl[on])
    assert bool((o[~on] == 0).all()) and bool((l[~on] == 0).all())
    assert bool((m[~on] == -1e30).all())
    # the plain path applies the same identity
    po, pm, pl = ops.flash_block(q.cpu(), k.cpu(), v.cpu(), causal=True,
                                 row_valid=valid.cpu())
    assert bool((po[~on.cpu()] == 0).all()) and bool((pm[~on.cpu()]
                                                      == -1e30).all())


@pytest.mark.parametrize("Tq,hd", [(257, 96), (129, 256), (127, 128)])
def test_flash_row_valid_mix(cuda, Tq, hd):
    """G = 5 and a mix of valid and invalid rows in bf16: valid rows equal
    the plain flash block (1e-5), invalid rows are the merge identity."""
    q, k, v = _qkv(cuda, 5, Tq, Tq, 1, 5, hd, torch.bfloat16, Tq + hd)
    valid = torch.tensor([0, 1, 1, 0, 1], device=cuda)
    o, m, l = ops.flash_block(q, k, v, causal=True, row_valid=valid)
    on = valid.bool()
    wo, wm, wl = ref.flash_block(q[on], k[on], v[on], causal=True)
    torch.testing.assert_close(m[on], wm, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(l[on], wl, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(o[on], wo, rtol=1e-5,
                               atol=1e-5 * max(1.0, float(wo.abs().max())))
    assert bool((o[~on] == 0).all()) and bool((l[~on] == 0).all())
    assert bool((m[~on] == -1e30).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_strided_views(cuda, dtype):
    """q / k / v as head-major tensors seen through transposes (strides
    other than the packed ones, last axis contiguous) equal the packed
    call exactly."""
    g = torch.Generator(device=cuda).manual_seed(9)
    qh = torch.randn(2, 10, 200, 64, device=cuda, generator=g).to(dtype)
    kh = torch.randn(2, 2, 200, 64, device=cuda, generator=g).to(dtype)
    vh = torch.randn(2, 2, 200, 64, device=cuda, generator=g).to(dtype)
    q, k, v = (t.transpose(1, 2) for t in (qh, kh, vh))
    got = ops.flash_block(q, k, v, causal=True)
    want = ops.flash_block(q.contiguous(), k.contiguous(), v.contiguous(),
                           causal=True)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


# B9 backward (csrc/flash_attention_bwd{,_tc}.cu): chip_smoke.py phase
# 31's cells (starcoder2's training shape in bf16 and f32, whisper's
# encoder shape, hd 256), ragged Tq / Tk off the 64- / 128-row tiles, G = 8,
# hd 64, 80, 128, 256, 36, 136, 200 and 250 (bf16 on the tf32x3 route),
# both routes; and
# the wgmma route's dQ chains and head slices at their edges: Tq > Tk with
# G = 12 cut into slices (rows that see no key), a ragged T = 1,000 at
# hd 64, and qwen3-14b's G = 5 (slices of 1, 2 and 2 heads)
FLASH_BWD_CELLS = [(2, 4096, 4096, 2, 12, 128, True, torch.bfloat16),
                   (2, 4096, 4096, 2, 12, 128, True, torch.float32),
                   (8, 1500, 1500, 20, 1, 64, False, torch.bfloat16),
                   (1, 1024, 1024, 2, 4, 256, True, torch.bfloat16),
                   (2, 100, 100, 2, 8, 64, True, torch.float32),
                   (1, 70, 200, 1, 8, 80, True, torch.bfloat16),
                   (1, 96, 40, 1, 5, 64, True, torch.float32),
                   (1, 130, 97, 2, 3, 80, False, torch.float32),
                   (2, 129, 129, 1, 8, 128, True, torch.bfloat16),
                   (1, 33, 65, 2, 2, 256, True, torch.float32),
                   (1, 257, 129, 1, 8, 256, False, torch.bfloat16),
                   (1, 129, 100, 2, 2, 36, True, torch.bfloat16),
                   (2, 63, 65, 1, 8, 128, True, torch.bfloat16),
                   (1, 40, 96, 2, 1, 64, False, torch.bfloat16),
                   (1, 300, 130, 2, 12, 128, True, torch.bfloat16),
                   (2, 1000, 1000, 2, 12, 64, True, torch.bfloat16),
                   (1, 2048, 2048, 8, 5, 128, True, torch.bfloat16),
                   # bf16 on the tf32x3 route above 128 or off a multiple
                   # of 8
                   (1, 200, 170, 2, 3, 136, True, torch.bfloat16),
                   (1, 129, 129, 1, 4, 200, False, torch.bfloat16),
                   (2, 97, 160, 1, 2, 250, True, torch.bfloat16)]


def flash_bwd_rule(got, want):
    """Largest share of the rule over the elements: f32 1e-4 * max(1,
    max |want|); bf16 2^-6 |want| + 2^-8 max |want|."""
    want = want.float()
    err = (got.float() - want).abs()
    if got.dtype == torch.float32:
        return float(err.max()) / (1e-4 * max(1.0, float(want.abs().max())))
    lim = 2.0 ** -6 * want.abs() + 2.0 ** -8 * float(want.abs().max())
    return float((err / lim).max())


@pytest.mark.parametrize("B,Tq,Tk,KV,G,hd,causal,dtype", FLASH_BWD_CELLS)
def test_flash_attention_bwd(cuda, B, Tq, Tk, KV, G, hd, causal, dtype):
    """dq / dk / dv of the kernel pair against ``ref.flash_attention_bwd``
    in f32 on the same q, k, v, o, lse, dO, each within its rule; the
    forward's o with lse is bit-equal to the forward without it."""
    from repro_torch.kernels.flash_attention import (
        flash_attention_bwd_cuda, flash_attention_cuda)
    torch.backends.cuda.matmul.allow_tf32 = False
    q, k, v = _qkv(cuda, B, Tq, Tk, KV, G, hd, dtype, Tq + Tk + hd)
    do = torch.randn(q.shape, device=cuda,
                     generator=torch.Generator(device=cuda).manual_seed(5)
                     ).to(dtype)
    o, lse = flash_attention_cuda(q, k, v, causal=causal, with_lse=True)
    assert torch.equal(o, flash_attention_cuda(q, k, v, causal=causal))
    _wo, wm, wl = ref.flash_block(q, k, v, causal=causal)
    seen = wm > -1e29           # rows that see a key
    torch.testing.assert_close(lse[seen], (wm + torch.log(wl))[seen],
                               rtol=1e-5, atol=1e-5)
    got = flash_attention_bwd_cuda(q, k, v, o, lse, do, causal=causal)
    want = ref.flash_attention_bwd(q, k, v, o, lse, do, causal=causal)
    for name, g, w in zip("qkv", got, want):
        assert g.dtype == dtype and g.shape == w.shape
        assert bool(torch.isfinite(g).all())
        assert flash_bwd_rule(g, w) <= 1.0, name
    again = flash_attention_bwd_cuda(q, k, v, o, lse, do, causal=causal)
    for g, a in zip(got, again):       # no atomics: the same bits
        assert torch.equal(g, a)


def test_flash_attention_bwd_routes_and_alignment(cuda):
    """bf16 with hd % 8 == 0 up to 128 takes the wgmma route, the rest the
    tf32x3 one; tensors off a 16-byte boundary (views at an odd offset) give
    the aligned call's bits."""
    from repro_torch.kernels.flash_attention import (
        bwd_route_of, flash_attention_bwd_cuda, flash_attention_cuda)
    assert [bwd_route_of(torch.bfloat16, hd) for hd in (64, 80, 128, 36,
                                                        256)] == \
        ["wgmma", "wgmma", "wgmma", "tf32x3", "tf32x3"]
    assert bwd_route_of(torch.float32, 64) == "tf32x3"
    q, k, v = _qkv(cuda, 1, 70, 70, 2, 3, 64, torch.bfloat16, 4)
    do = torch.randn_like(q)
    o, lse = flash_attention_cuda(q, k, v, causal=True, with_lse=True)
    want = flash_attention_bwd_cuda(q, k, v, o, lse, do, causal=True)

    def shifted(t):
        buf = torch.empty(t.numel() + 3, dtype=t.dtype, device=t.device)
        out = buf[3:].view(t.shape)
        out.copy_(t)
        assert out.data_ptr() % 16 != 0
        return out

    got = flash_attention_bwd_cuda(*(shifted(t) for t in (q, k, v, o)), lse,
                                   shifted(do), causal=True)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("dtype,hd,G", [(torch.float32, 128, 6),
                                        (torch.float32, 3, 2),
                                        (torch.bfloat16, 256, 4),
                                        (torch.float32, 256, 3)])
def test_flash_attention_bwd_deterministic(cuda, dtype, hd, G):
    """The tf32x3 backward without atomics: two calls on the same inputs
    give bit-equal dq / dk / dv (the G heads of a kv head summed in one
    order; at hd 256 the two warps of a key group add the same two halves
    of S and dP)."""
    from repro_torch.kernels.flash_attention import (
        bwd_route_of, flash_attention_bwd_cuda, flash_attention_cuda)
    assert bwd_route_of(dtype, hd) == "tf32x3"
    q, k, v = _qkv(cuda, 2, 300, 300, 2, G, hd, dtype, 17 + hd)
    do = torch.randn_like(q)
    o, lse = flash_attention_cuda(q, k, v, causal=True, with_lse=True)
    first = flash_attention_bwd_cuda(q, k, v, o, lse, do, causal=True)
    second = flash_attention_bwd_cuda(q, k, v, o, lse, do, causal=True)
    for a, b in zip(first, second):
        assert bool(torch.isfinite(a).all()) and torch.equal(a, b)
    want = ref.flash_attention_bwd(q, k, v, o, lse, do, causal=True)
    for g, w in zip(first, want):
        assert flash_bwd_rule(g, w) <= 1.0


@pytest.mark.parametrize("hd", [3, 256])
@pytest.mark.parametrize("Tq,Tk", [(130, 130), (70, 200), (96, 40)])
def test_flash_f32_partial_row_valid(cuda, hd, Tq, Tk):
    """The f32 (tf32x3) partial epilogue at hd 3 (k-steps padded to 8, 4-byte
    copies) and hd 256 (32-key tiles) with a mix of valid and invalid rows:
    valid rows within the plain flash block's 1e-5 rule, invalid rows the
    merge identity, rows that see no key (Tq > Tk) at l = Tk."""
    q, k, v = _qkv(cuda, 4, Tq, Tk, 2, 3, hd, torch.float32, Tq + hd)
    valid = torch.tensor([1, 0, 1, 1], device=cuda)
    o, m, l = ops.flash_block(q, k, v, causal=True, row_valid=valid)
    on = valid.bool()
    wo, wm, wl = ref.flash_block(q[on], k[on], v[on], causal=True)
    torch.testing.assert_close(m[on], wm, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(l[on], wl, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(o[on], wo, rtol=1e-5,
                               atol=1e-5 * max(1.0, float(wo.abs().max())))
    assert bool((o[~on] == 0).all()) and bool((l[~on] == 0).all())
    assert bool((m[~on] == -1e30).all())
    if Tq > Tk:
        assert bool((l[on][:, :Tq - Tk] == Tk).all())


@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_autograd_route(cuda, causal):
    """``ops.flash_attention`` on CUDA tensors that need a gradient: the
    kernel pair's gradients against autograd of the plain attention at a
    tiny f32 shape (1e-5), one forward with lse and one backward counted."""
    from repro_torch.kernels import flash_attention as flash_mod
    q, k, v = (t.requires_grad_(True) for t in
               _qkv(cuda, 2, 37, 53, 2, 3, 16, torch.float32, 11))
    do = torch.randn(2, 37, 6, 16, device=cuda)
    ops.reset_launch_counts()
    got = torch.autograd.grad(ops.flash_attention(q, k, v, causal=causal),
                              (q, k, v), do)
    assert flash_mod.launches == 1 and flash_mod.bwd_launches == 1
    want = torch.autograd.grad(ref.flash_attention(q, k, v, causal=causal),
                               (q, k, v), do)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-5,
                                   atol=1e-5 * max(1.0, float(w.abs().max())))


def _ssd_inputs(cuda, B, T, H, P, N, seed):
    rng = np.random.default_rng(seed)
    # x, B and C as strided views into one projection, as in the model
    xBC = torch.as_tensor(rng.normal(size=(B, T, H * P + 2 * N)),
                          dtype=torch.float32, device=cuda)
    x = xBC[..., :H * P].unflatten(-1, (H, P))
    Bm, Cm = xBC[..., H * P:H * P + N], xBC[..., H * P + N:]
    dt = torch.as_tensor(rng.uniform(0.01, 0.2, size=(B, T, H)),
                         dtype=torch.float32, device=cuda)
    A = torch.as_tensor(-rng.uniform(0.5, 2, size=(H,)), dtype=torch.float32,
                        device=cuda)
    return x, dt, A, Bm, Cm


@pytest.mark.parametrize("L", [1, 16, 256])
@pytest.mark.parametrize("N", [16, 128])
@pytest.mark.parametrize("P", [16, 64])
def test_ssd_chunk(cuda, L, N, P):
    """y_intra, S and cd against the plain intra-chunk step (the
    reference's 1e-4 kernel tolerance)."""
    T = 5 if L == 1 else 2 * L
    args = _ssd_inputs(cuda, 2, T, 3, P, N, L + N + P)
    got = ops.ssd_intra_chunk(*args, chunk=L)
    want = ref.ssd_intra_chunk(*args, chunk=L)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-4)


def _ssd_close(args, L):
    got = ops.ssd_intra_chunk(*args, chunk=L)
    want = ref.ssd_intra_chunk(*args, chunk=L)
    for g, w in zip(got, want):
        assert g.shape == w.shape and bool(torch.isfinite(g).all())
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-4)
    return got


@pytest.mark.parametrize("L", [1, 16, 96, 256])
@pytest.mark.parametrize("H", [3, 24, 25])
def test_ssd_chunk_head_groups(cuda, L, H):
    """mamba2-130m's widths (P 64, N 128) with H not a multiple of the 8
    heads a block owns; L = 96 leaves a ragged 64-row tile."""
    T = 3 if L == 1 else 2 * L
    _ssd_close(_ssd_inputs(cuda, 1, T, H, 64, 128, 100 * L + H), L)


@pytest.mark.parametrize("L", [16, 64])
@pytest.mark.parametrize("H", [3, 25])
def test_ssd_chunk_many_cells(cuda, L, H):
    """600 (batch row, chunk) cells: enough to fill the card, so one block
    walks every 8-head group of its cell under one C B^T strip (H = 25
    leaves a group of one head)."""
    _ssd_close(_ssd_inputs(cuda, 2, 300 * L, H, 64, 128, 5 * L + H), L)


@pytest.mark.parametrize("P,N", [(30, 50), (100, 37), (128, 256),
                                 (128, 128)])
def test_ssd_chunk_widths(cuda, P, N):
    """Head widths past 64 (a block of 4 heads x 128 columns) and widths
    that are not multiples of 4 (4-byte loads instead of 16-byte copies),
    with ragged 64-row tiles."""
    _ssd_close(_ssd_inputs(cuda, 2, 192, 5, P, N, P + N), 96)


@pytest.mark.parametrize("L", [64, 96, 256])
def test_ssd_chunk_wide_span(cuda, L):
    """cums spans far more than 88 within a chunk (dt up to 2, A down to
    -16; exp(-cums_j) alone would overflow).  dt is a multiple of 1/8 and
    A an integer, so every cumsum is exact and both versions see the same
    decays."""
    x, _dt, _A, Bm, Cm = _ssd_inputs(cuda, 2, 2 * L, 5, 64, 128, 7 * L)
    rng = np.random.default_rng(L)
    dt = torch.as_tensor(rng.integers(1, 17, size=(2, 2 * L, 5)) / 8,
                         dtype=torch.float32, device=cuda)
    A = torch.tensor([-16.0, -9.0, -3.0, -1.0, -16.0], device=cuda)
    cums = torch.cumsum((dt * A).view(2, 2, L, 5), dim=2)
    assert float((cums[:, :, 0, 0] - cums[:, :, -1, 0]).min()) > 88
    _ssd_close((x, dt, A, Bm, Cm), L)


@pytest.mark.parametrize("L", [16, 96])
def test_ssd_chunk_positive_a(cuda, L):
    """Heads with dt * A > 0 (growth, a short chunk) take the explicit
    route on every tile; the others stay factored.  dt is a multiple of
    1/32 and A of 1/16, so every cumsum is exact: growth multiplies any
    rounding of the cumsum into the result, and the two versions would
    then disagree by their cumsums' rounding, not by the kernel."""
    x, _dt, _A, Bm, Cm = _ssd_inputs(cuda, 2, 2 * L, 10, 64, 128, 3 * L)
    rng = np.random.default_rng(L + 1)
    dt = torch.as_tensor(rng.integers(1, 9, size=(2, 2 * L, 10)) / 32,
                         dtype=torch.float32, device=cuda)
    A = torch.tensor([0.125, -1.0, 0.0625, -2.0, -0.5, 0.125, -1.5, -0.75,
                      0.0625, -1.0], device=cuda)
    _ssd_close((x, dt, A, Bm, Cm), L)


def test_ssd_chunk_bit_equal(cuda):
    """Two launches on the same inputs give the same bits."""
    args = _ssd_inputs(cuda, 2, 192, 25, 64, 128, 5)
    first = _ssd_close(args, 96)
    again = ops.ssd_intra_chunk(*args, chunk=96)
    assert all(torch.equal(a, b) for a, b in zip(first, again))


def test_ssd_full_scan_matches_sequential(cuda):
    args = _ssd_inputs(cuda, 2, 64, 3, 16, 32, 7)
    torch.testing.assert_close(ops.ssd_chunk(*args, chunk=16),
                               ref.ssd_chunk(*args), rtol=1e-4, atol=1e-4)


def test_b9_b10_count_launches(cuda):
    ops.reset_launch_counts()
    q, k, v = _qkv(cuda, 1, 8, 8, 1, 1, 16, torch.float32, 0)
    ops.flash_attention(q, k, v)
    ops.flash_block(q, k, v, causal=False)
    args = _ssd_inputs(cuda, 1, 4, 2, 16, 16, 0)
    ops.ssd_intra_chunk(*args, chunk=1)
    ops.ssd_intra_chunk(*args, chunk=4)
    counts = ops.launch_counts()
    assert counts["flash_attention"] == 2 and counts["ssd_chunk"] == 2


# the MoE / hybrid / encoder-decoder models' shapes: B10 at jamba's
# widths (H = 128 heads of P = 64, state N = 16), B9 at whisper's
# (hd 64, KV = H = 20, T = 1,500, not a multiple of 64) and jamba's
# grouping (H = 32 over KV = 8)
@pytest.mark.parametrize("L", [1, 256])
def test_ssd_chunk_jamba_widths(cuda, L):
    T = 3 if L == 1 else 2 * L
    _ssd_close(_ssd_inputs(cuda, 1, T, 128, 64, 16, 11 + L), L)


def test_ssd_chunk_real_span(cuda):
    """jamba's widths with a Mamba layer's real range of decays: dt up to
    5.3, not dyadic, and A = -e, so a chunk's cumsum spans hundreds and
    every cums_i - cums_j carries roundings of |cums|.  A scan that adds
    a lane stretch's sum to a shuffle-scanned base rounds each difference
    independently of the plain version's sequential cumsum, and y then
    leaves the 1e-4 tolerance (ROADMAP.md C.5)."""
    _ssd_close(_real_span_args(cuda), 256)


def _real_span_args(cuda, L=256):
    """jamba's widths (H 128, P 64, N 16) over two chunks of L with dt up
    to 5.3 (not dyadic) and A = -e: a chunk's cumsum spans hundreds."""
    x, _dt, _A, Bm, Cm = _ssd_inputs(cuda, 1, 2 * L, 128, 64, 16, 22)
    rng = np.random.default_rng(23)
    dt = torch.as_tensor(np.minimum(rng.exponential(0.8, size=(1, 2 * L,
                                                                128)), 5.3)
                         + 0.005, dtype=torch.float32, device=cuda)
    A = torch.full((128,), -math.e, dtype=torch.float32, device=cuda)
    cums = torch.cumsum((dt * A).view(1, 2, L, 128), dim=2)
    assert float((cums[:, :, 0] - cums[:, :, -1]).min()) > 300
    return x, dt, A, Bm, Cm


@pytest.mark.parametrize("B,Tq,Tk,KV,G,hd", [(1, 1500, 1500, 20, 1, 64),
                                              (1, 700, 700, 8, 4, 128)])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_model_shapes(cuda, B, Tq, Tk, KV, G, hd, causal):
    """bf16 against the plain softmax, one bf16 ulp of the value (2^-7
    relative) plus 1e-5, as test_flash_attention holds it."""
    q, k, v = _qkv(cuda, B, Tq, Tk, KV, G, hd, torch.bfloat16, Tq + G)
    got = ops.flash_attention(q, k, v, causal=causal)
    want = ref.flash_attention(q, k, v, causal=causal)
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    torch.testing.assert_close(got.float(), want.float(), rtol=2.0 ** -7,
                               atol=1e-5)


# ---------------------------------------------------------------------------
# B10's backward (csrc/ssd_chunk_bwd.cu) against ref.ssd_intra_chunk_bwd:
# each gradient within 1e-4 max(1, max |want|) (ddt and dA are sums of
# terms that cancel, so the rule is per tensor, never per element)
# ---------------------------------------------------------------------------

def _ssd_cotangents(args, L, seed):
    x, _dt, _A, Bm, _Cm = args
    Bsz, T, H, P = x.shape
    rng = np.random.default_rng(seed)
    f32 = dict(dtype=torch.float32, device=x.device)
    return (torch.as_tensor(rng.normal(size=(Bsz, T, H, P)), **f32),
            torch.as_tensor(rng.normal(size=(Bsz, T // L, H, Bm.shape[-1],
                                              P)), **f32),
            torch.as_tensor(rng.normal(size=(Bsz, T, H)), **f32))


def _ssd_bwd_close(args, L, seed=0, drop=()):
    """The kernel's gradients against the plain version's on the same
    inputs; cotangents named in ``drop`` are None (zero)."""
    from repro_torch.kernels.ssd_chunk import ssd_chunk_bwd_cuda
    cot = [None if n in drop else c for n, c in
           zip(("dy", "dS", "dcd"), _ssd_cotangents(args, L, seed))]
    got = ssd_chunk_bwd_cuda(*args, *cot, chunk=L)
    want = ref.ssd_intra_chunk_bwd(*args, *cot, chunk=L)
    for name, g, w in zip(("dx", "ddt", "dA", "dB", "dC"), got, want):
        assert g.shape == w.shape and bool(torch.isfinite(g).all()), name
        lim = 1e-4 * max(1.0, float(w.abs().max()))
        err = float((g - w).abs().max())
        assert err <= lim, f"{name}: max abs err {err:.3e} > {lim:.3e}"
    return got, cot


@pytest.mark.parametrize("L", [1, 16, 256])
@pytest.mark.parametrize("N", [16, 128])
@pytest.mark.parametrize("P", [16, 64])
def test_ssd_chunk_bwd(cuda, L, N, P):
    T = 5 if L == 1 else 2 * L
    _ssd_bwd_close(_ssd_inputs(cuda, 2, T, 3, P, N, L + N + P), L)


@pytest.mark.parametrize("L", [1, 16, 96, 256])
@pytest.mark.parametrize("H", [3, 24, 25])
def test_ssd_chunk_bwd_head_groups(cuda, L, H):
    """mamba2-130m's widths with H not a multiple of the 8 heads a block
    owns (dB / dC partials of several groups); L = 96 leaves a ragged
    64-row tile."""
    T = 3 if L == 1 else 2 * L
    _ssd_bwd_close(_ssd_inputs(cuda, 1, T, H, 64, 128, 100 * L + H), L)


@pytest.mark.parametrize("L", [16, 64])
@pytest.mark.parametrize("H", [3, 25])
def test_ssd_chunk_bwd_many_cells(cuda, L, H):
    _ssd_bwd_close(_ssd_inputs(cuda, 2, 300 * L, H, 64, 128, 5 * L + H), L)


@pytest.mark.parametrize("P,N", [(30, 50), (100, 37), (128, 256),
                                 (128, 128)])
def test_ssd_chunk_bwd_widths(cuda, P, N):
    """P past 64 (two 64-column pieces) and widths not multiples of 4."""
    _ssd_bwd_close(_ssd_inputs(cuda, 2, 192, 5, P, N, P + N), 96)


@pytest.mark.parametrize("L", [16, 96])
def test_ssd_chunk_bwd_positive_a(cuda, L):
    """dt * A > 0 on some heads, dyadic so every cumsum is exact (as
    test_ssd_chunk_positive_a draws it)."""
    x, _dt, _A, Bm, Cm = _ssd_inputs(cuda, 2, 2 * L, 10, 64, 128, 3 * L)
    rng = np.random.default_rng(L + 1)
    dt = torch.as_tensor(rng.integers(1, 9, size=(2, 2 * L, 10)) / 32,
                         dtype=torch.float32, device=cuda)
    A = torch.tensor([0.125, -1.0, 0.0625, -2.0, -0.5, 0.125, -1.5, -0.75,
                      0.0625, -1.0], device=cuda)
    _ssd_bwd_close((x, dt, A, Bm, Cm), L)


@pytest.mark.parametrize("split", [True, False])
@pytest.mark.parametrize("L", [96, 256])
@pytest.mark.parametrize("H", [24, 25])
def test_ssd_chunk_bwd_s_split(cuda, split, L, H):
    """Both sides of the dB / dC launch's switch, as the input's size sets
    it: few (batch row, chunk) cells, where blocks split dB's S term by
    heads and a last launch sums their partials in order, and cells that
    fill half the SMs, where one block takes it whole; L = 96 leaves a
    ragged 64-row tile."""
    from repro_torch.kernels.ssd_chunk import bwd_s_splits
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    nc = 1 if split else -(-sms // 4)
    assert (bwd_s_splits(2 * nc, 128, H, sms) > 1) == split
    _ssd_bwd_close(_ssd_inputs(cuda, 2, nc * L, H, 64, 128, 7 * L + H), L)


@pytest.mark.parametrize("N", [16, 18, 70])
@pytest.mark.parametrize("P", [64, 128])
def test_ssd_chunk_bwd_state_widths(cuda, N, P):
    """The S terms at N's own width: N 16 (16-column tiles of the second
    launch), 18 and 70 (not multiples of 4: 4-byte loads; 32- and
    64-column tiles), with P up to 64 and P = 128 (a head over two warps
    of the dx pass), at a ragged L = 96."""
    _ssd_bwd_close(_ssd_inputs(cuda, 2, 192, 9, P, N, 11 * N + P), 96)


@pytest.mark.parametrize("drop", [("dcd",), ("dS", "dcd"), ("dy",)])
def test_ssd_chunk_bwd_absent_gradients(cuda, drop):
    """An output whose gradient is absent counts as zero."""
    _ssd_bwd_close(_ssd_inputs(cuda, 1, 128, 9, 64, 32, 4), 64, drop=drop)


def test_ssd_chunk_bwd_real_span(cuda):
    """jamba's real spans (ROADMAP.md C.5): against a float64 gradient the
    kernel's error is at most twice the plain float32 version's, per
    gradient."""
    args = _real_span_args(cuda)
    got, cot = _ssd_bwd_close(args, 256)
    plain = ref.ssd_intra_chunk_bwd(*args, *cot, chunk=256)
    exact = ref.ssd_intra_chunk_bwd(*args, *cot, chunk=256,
                                    dtype=torch.float64)
    for name, g, p, e in zip(("dx", "ddt", "dA", "dB", "dC"), got, plain,
                             exact):
        err_k = float((g.double() - e).abs().max())
        err_p = float((p.double() - e).abs().max())
        assert err_k <= 2 * err_p, (name, err_k, err_p)


def test_ssd_chunk_bwd_bit_equal(cuda):
    from repro_torch.kernels.ssd_chunk import ssd_chunk_bwd_cuda
    args = _ssd_inputs(cuda, 2, 192, 25, 64, 128, 5)
    first, cot = _ssd_bwd_close(args, 96)
    again = ssd_chunk_bwd_cuda(*args, *cot, chunk=96)
    assert all(torch.equal(a, b) for a, b in zip(first, again))


def test_ssd_intra_chunk_autograd_route(cuda):
    """``ops.ssd_intra_chunk`` on CUDA tensors that need a gradient: one
    forward and one backward launch, the plain version's gradients."""
    from repro_torch.kernels import ssd_chunk as ssd_mod
    args = [t.clone().requires_grad_(True)
            for t in _ssd_inputs(cuda, 2, 128, 5, 16, 32, 9)]
    cot = _ssd_cotangents(args, 64, 1)
    ops.reset_launch_counts()
    out = ops.ssd_intra_chunk(*args, chunk=64)
    got = torch.autograd.grad(out, args, cot)
    assert ssd_mod.launches == 1 and ssd_mod.bwd_launches == 1
    want = torch.autograd.grad(ref.ssd_intra_chunk(*args, chunk=64), args,
                               cot)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert float((g - w).abs().max()) <= 1e-4 * max(
            1.0, float(w.abs().max()))


def test_mamba2_train_step_matches_plain_route(cuda):
    """mamba2-130m at full width and 2 layers (bf16, remat on), one batch
    of 2 x 512 tokens: the loss and every parameter gradient through B10
    and its backward against the same model with the plain intra-chunk
    step and its autograd, within 2e-2 max(1, |.|) (the training limits
    of PERF.md section 2)."""
    import dataclasses
    from unittest import mock
    from repro_torch.configs import get_config
    from repro_torch.models import lm
    from repro_torch.models.common import tree_leaves
    cfg = dataclasses.replace(get_config("mamba2_130m"), n_layers=2)
    params = lm.init_params(cfg, seed=0, device=cuda)
    rng = np.random.default_rng(3)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (2, 512)),
                           device=cuda)
    batch = {"tokens": toks, "labels": toks.roll(-1, 1)}
    paths, leaves = zip(*tree_leaves(params))

    def loss_grads():
        for p in leaves:
            p.requires_grad_(True)
        loss, _ = lm.loss_fn(cfg, params, batch)
        grads = torch.autograd.grad(loss, leaves)
        for p in leaves:
            p.requires_grad_(False)
        return float(loss.detach()), grads

    ops.reset_launch_counts()
    loss_k, g_k = loss_grads()
    counts = ops.launch_counts()
    assert counts["ssd_chunk"] == 4 and counts["ssd_chunk_bwd"] == 2
    with mock.patch.object(ops, "ssd_intra_chunk", ref.ssd_intra_chunk):
        loss_p, g_p = loss_grads()
    assert abs(loss_k - loss_p) <= 2e-2 * max(1.0, abs(loss_p))
    for path, gk, gp in zip(paths, g_k, g_p):
        assert bool(torch.isfinite(gk).all()), path
        err = float((gk.float() - gp.float()).abs().max())
        assert err <= 2e-2 * max(1.0, float(gp.abs().max())), (path, err)
