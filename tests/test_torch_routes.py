"""Which kernel a B7 / B8 call launches, why its int8 route is exact, why
B7's per-warp reject bound never drops a band entry, and what the B4 / B7
/ B8 wrappers refuse — all decided on the host, so all checked on the CPU
(the kernels themselves run in tests/test_torch_kernels_gpu.py).
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import ref
from repro_torch.kernels.pairwise_batch_q import (BF16_CHUNK,
                                                  BF16_TC_MAX_D,
                                                  INT8_EXACT_D,
                                                  INT8_TC_MAX_D, band_tile,
                                                  pairwise_threshold_q_cuda,
                                                  pairwise_topk_q_cuda,
                                                  route_of)
from repro_torch.kernels.pairwise_threshold import hot_words
from repro_torch.kernels.query_score import MAX_TOPK, query_topk_cuda

TC = "tensor_cores"
ROUTE_CELLS = [
    (torch.int8, 1, TC), (torch.int8, 128, TC), (torch.int8, 1040, TC),
    (torch.int8, 1041, TC), (torch.int8, 4096, TC), (torch.bfloat16, 24, TC),
    (torch.bfloat16, 128, TC), (torch.bfloat16, 129, TC),
    (torch.bfloat16, 1041, TC),
    # published widths: gist-960, 1,536-wide embeddings
    (torch.bfloat16, 960, TC), (torch.int8, 960, TC),
    (torch.bfloat16, 1536, TC), (torch.int8, 1536, TC),
    # each limit and one past it
    (torch.int8, 66571, TC), (torch.int8, 66572, TC),
    (torch.int8, 66573, "simt"), (torch.bfloat16, 1048575, TC),
    (torch.bfloat16, 1048576, TC), (torch.bfloat16, 1048577, "simt")]


@pytest.mark.parametrize("dtype,d,route", ROUTE_CELLS)
def test_b8_route_of(dtype, d, route):
    """Both dtypes take the tensor cores at every width up to the limits
    the kernel headers prove: int8 while every dot stays within 2^30
    (d <= 66,572: exact s32 sums, B7's integer prefilter never wraps), bf16
    while B7's band covers the compensated chunk sums (d <= 2^20); the
    float32 SIMT tile only above, past every published width."""
    assert route_of(dtype, d) == route


@pytest.mark.parametrize("dtype,d,route", ROUTE_CELLS)
def test_b7_route_of(dtype, d, route):
    """B7 takes the same routes as B8 (one route_of for both): 128-row
    strips on the tensor cores, pair_tile.cuh's 64-row strips on the SIMT
    tile, and one hot-tile bit per column tile of a strip."""
    assert route_of(dtype, d) == route
    tile = band_tile(route)
    assert tile == (128 if route == "tensor_cores" else 64)
    for block in (1, tile - 1, tile, tile + 1, 32 * tile, 32 * tile + 1):
        assert hot_words(block, tile) * 32 >= -(-block // tile)
        assert (hot_words(block, tile) - 1) * 32 < -(-block // tile)


def test_route_limits():
    """INT8_EXACT_D keeps its meaning (the widest int8 rows whose every dot
    is a float32 integer); the route limits are INT8_TC_MAX_D (|dot| <=
    2^30) and BF16_TC_MAX_D (B7's certificate at chunks of BF16_CHUNK,
    checked in tests/test_torch_pair_tc_chunks.py)."""
    assert (BF16_TC_MAX_D, BF16_CHUNK) == (1 << 20, 32)
    assert (INT8_EXACT_D, INT8_TC_MAX_D) == (1040, 66572)
    worst = 127 * 127
    assert INT8_EXACT_D * worst < 2 ** 24 <= (INT8_EXACT_D + 1) * worst
    assert INT8_TC_MAX_D * worst <= 2 ** 30 < (INT8_TC_MAX_D + 1) * worst


def _f32_sums(products: np.ndarray, rng) -> list:
    """float32 sums of int products in several orders: ascending,
    descending, a random permutation (each one add at a time, rounding
    after every add) and numpy's pairwise sum."""
    p32 = products.astype(np.float32)
    out = []
    for order in (np.arange(p32.size), np.arange(p32.size)[::-1],
                  rng.permutation(p32.size)):
        out.append(float(np.cumsum(p32[order], dtype=np.float32)[-1]))
    out.append(float(np.sum(p32, dtype=np.float32)))
    return out


@pytest.mark.parametrize("case", ["worst", "mixed", "alternating"])
def test_int8_dots_exact_in_float32_at_1040(case):
    """At d = 1,040 every partial sum of int8 products is an integer below
    2^24, so a float32 sum in any order equals the int32 sum: the tensor
    cores' s32 dot converts to exactly the plain version's float32 dot."""
    rng = np.random.default_rng(1040)
    d = INT8_EXACT_D
    if case == "worst":
        a = np.full(d, 127, np.int64)
        b = np.full(d, -127, np.int64)
    elif case == "mixed":
        a = rng.choice([-127, 127], d)
        b = rng.choice([-127, 127], d)
    else:
        a = np.full(d, 127, np.int64)
        b = np.where(np.arange(d) % 2 == 0, 127, -127)
    exact = int(np.dot(a, b))
    assert all(s == exact for s in _f32_sums(a * b, rng))


def test_int8_dots_inexact_in_float32_at_1041():
    """One more column and the worst case (every product 127^2) passes
    2^24 on an odd sum: float32 cannot hold it, and a float32 sum in any
    order rounds it.  So past 1,040 the tensor-core route's contract is
    the exact s32 dot rounded once to float32, not the plain version's
    order-dependent float32 matmul."""
    d = INT8_EXACT_D + 1
    prods = np.full(d, 127 * 127, np.int64)
    exact = int(prods.sum())
    assert exact > 2 ** 24 and exact % 2 == 1
    assert all(s != exact for s in _f32_sums(prods,
                                             np.random.default_rng(0)))


def _b4_args(dtype=torch.float32, d=4, Q=3):
    stack = torch.zeros(1, 2, 8, 4, dtype=dtype)
    return (stack, torch.zeros(Q, d), torch.ones(1, 2, 8),
            torch.zeros(1, 2, 8, dtype=torch.int32))


@pytest.mark.parametrize("bad,match", [
    (dict(topk=0), "topk"), (dict(topk=MAX_TOPK + 1), "topk"),
    (dict(metric="cosine"), "metric"), (dict(dtype=torch.float64), "float32"),
    (dict(d=5), "queries"), (dict(dtype=torch.bfloat16), "float32")])
def test_b4_wrapper_refuses(bad, match):
    """B4 takes float32 [P, k, block, d] stacks with [Q, d] queries and
    topk in 1..MAX_TOPK (1,024), and raises before building anything."""
    kw = dict(topk=bad.get("topk", 4), metric=bad.get("metric", "dot"))
    args = _b4_args(bad.get("dtype", torch.float32), bad.get("d", 4))
    with pytest.raises(ValueError, match=match):
        query_topk_cuda(*args, **kw)


@pytest.mark.parametrize("bad,match", [
    (dict(topk=0), "topk"), (dict(metric="cosine"), "metric"),
    (dict(dtype=torch.float32), "int8 or bfloat16"),
    (dict(dtype=torch.float16), "int8 or bfloat16"),
    (dict(sd=(1, 2, 1)), "sd must be"), (dict(sq=(1, 2, 7)), "l1 / sq"),
    (dict(codes=(2, 8, 4)), "int8 or bfloat16"),
    (dict(route="wgmma"), "route")])
def test_b8_wrapper_refuses(bad, match):
    """B8 takes int8 / bf16 codes with [P, k, 2] scales and [P, k, block]
    norms and any topk >= 1 (its lists live in global memory above 32
    entries), and raises before building anything."""
    codes = torch.zeros(bad.get("codes", (1, 2, 8, 4)),
                        dtype=bad.get("dtype", torch.int8))
    sd = torch.ones(bad.get("sd", (1, 2, 2)))
    sq = torch.ones(bad.get("sq", (1, 2, 8)))
    meta = torch.ones(1, 1, 6, dtype=torch.int32)
    with pytest.raises(ValueError, match=match):
        pairwise_topk_q_cuda(codes, sd, sq, [0], [1], meta,
                             topk=bad.get("topk", 2), block_rows=8,
                             metric=bad.get("metric", "dot"),
                             route=bad.get("route"))


@pytest.mark.parametrize("bad,match", [
    (dict(capacity=0), "capacity"), (dict(metric="cosine"), "metric"),
    (dict(dtype=torch.float32), "int8 or bfloat16"),
    (dict(dtype=torch.float16), "int8 or bfloat16"),
    (dict(sd=(1, 2, 1)), "sd must be"), (dict(l1=(1, 2, 7)), "l1 / sq"),
    (dict(sq=(1, 3, 8)), "l1 / sq"), (dict(codes=(2, 8, 4)),
                                      "int8 or bfloat16"),
    (dict(route="wgmma"), "route")])
def test_b7_wrapper_refuses(bad, match):
    """B7 takes int8 / bf16 codes [P, k, block, d] with [P, k, 2] scales
    and [P, k, block] l1 / sq rows, capacity >= 1 and a known route, and
    raises before building anything."""
    codes = torch.zeros(bad.get("codes", (1, 2, 8, 4)),
                        dtype=bad.get("dtype", torch.int8))
    sd = torch.ones(bad.get("sd", (1, 2, 2)))
    l1 = torch.ones(bad.get("l1", (1, 2, 8)))
    sq = torch.ones(bad.get("sq", (1, 2, 8)))
    meta = torch.ones(1, 1, 6, dtype=torch.int32)
    with pytest.raises(ValueError, match=match):
        pairwise_threshold_q_cuda(codes, sd, l1, sq, [0], [1], meta,
                                  threshold=0.5,
                                  capacity=bad.get("capacity", 16),
                                  block_rows=8,
                                  metric=bad.get("metric", "dot"),
                                  route=bad.get("route"))


@pytest.mark.parametrize("seed", range(8))
@pytest.mark.parametrize("metric", ["dot", "l2"])
def test_b7_reject_bound_is_conservative(seed, metric):
    """B7 first holds an entry against thr - eps_max, eps_max being
    ref.quant_eps_tile (the kernel's expression order, float32 rounding)
    of the warp sub-tile's largest row and column L1 norms.  With deltas
    and L1 norms >= 0 that bound is >= every entry's eps, so
    thr - eps_max <= thr - eps and the reject drops no band entry."""
    rng = np.random.default_rng(seed)
    m, n = 32, 64                       # one warp's sub-tile
    d = int(rng.choice([1, 33, 128, 1040]))
    d_lo, d_hi = (np.float32(10.0 ** rng.uniform(-7, 0)) for _ in range(2))
    l1_lo = (10.0 ** rng.uniform(-3, 4, m)).astype(np.float32)
    l1_hi = (10.0 ** rng.uniform(-3, 4, n)).astype(np.float32)
    l1_lo[rng.uniform(size=m) < 0.2] = 0.0    # padding rows
    l1_hi[:3] = l1_hi.max()                    # ties at the maximum
    eps = ref.quant_eps_tile(d_lo, d_hi, torch.from_numpy(l1_lo),
                             torch.from_numpy(l1_hi), dim=d, metric=metric)
    eps_max = ref.quant_eps_tile(d_lo, d_hi,
                                 torch.tensor([l1_lo.max()]),
                                 torch.tensor([l1_hi.max()]), dim=d,
                                 metric=metric)
    assert eps.dtype == eps_max.dtype == torch.float32
    assert bool((eps <= eps_max).all())
    for thr in (-5.0, 0.0, 0.37, 1e3):
        t = torch.tensor(thr, dtype=torch.float32)
        assert bool(((t - eps_max) <= (t - eps)).all())


F32 = np.float32


def _prefilter(x, cn, rn, reject, sprod, cnmax, rnmax, metric, qmode):
    """B7's prefilter (csrc/pairwise_threshold_q.cu, tensor-core route) in
    float32, op for op: does entry x (the code dot: an int for int8, a
    float32 for bf16) with column / row squared norms cn / rn pass on to
    the exact test?"""
    l2 = metric == "l2"
    f = F32(F32(0.5 if l2 else 1.0) / sprod)
    margin = F32(F32(F32(F32(2.0 ** -18) * F32(abs(reject) + F32(
        F32(2.0) * F32(cnmax + rnmax)))) + F32(2.0 ** -100)) / sprod)
    b = F32(cn * f)
    a = F32(F32(F32(reject + rn) * f) - margin)
    if qmode == "int8":
        b_i = np.floor(np.minimum(np.maximum(b, F32(0)), F32(2.0 ** 30)))
        a_i = np.where(a >= F32(-2.0 ** 30),
                       np.floor(np.minimum(a, F32(2.0 ** 30))), -2.0 ** 31)
        return x.astype(np.int64) - b_i.astype(np.int64) >= a_i
    return F32(x - b) >= a


def _exact_score(x, cn, rn, sprod, metric):
    s = F32(F32(x) * sprod)
    if metric == "l2":
        s = F32(F32(F32(F32(2.0) * s) - cn) - rn)
    return s


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("qmode", ["int8", "bf16"])
@pytest.mark.parametrize("metric", ["dot", "l2"])
def test_b7_prefilter_keeps_every_band_entry(seed, qmode, metric):
    """Every entry the exact band test keeps (s >= thr - eps in the plain
    version's float32 operations) passes B7's one-operation prefilter
    x - B_c >= A_r, its bounds rounded as the kernel rounds them; dots
    are drawn densely around each entry's boundary, where rounding
    decides (even seeds: all l1 equal, so every entry's eps is eps_max
    and the margin alone covers the roundings)."""
    rng = np.random.default_rng(100 + seed)
    m, n = 32, 64                        # one warp's sub-tile
    d = int(rng.choice([16, 128, 1040]))
    scale = (10.0 ** rng.uniform(-3, -1, 2)).astype(F32)
    sprod = F32(scale[0] * scale[1])
    d_lo, d_hi = F32(scale[0] / 2), F32(scale[1] / 2)
    l1_r = rng.uniform(0, 150, m).astype(F32)
    l1_c = rng.uniform(0, 150, n).astype(F32)
    if seed % 2 == 0:   # every eps at eps_max: every boundary at reject
        l1_r[:], l1_c[:] = l1_r[0], l1_c[0]
    if metric == "l2":
        rn = rng.uniform(0, 200, m).astype(F32)
        cn = rng.uniform(0, 200, n).astype(F32)
    else:
        rn, cn = np.zeros(m, F32), np.zeros(n, F32)
    thr = F32(rng.choice([-20.0, -3.5, 0.0, 2.75]))
    eps = ref.quant_eps_tile(d_lo, d_hi, torch.from_numpy(l1_r),
                             torch.from_numpy(l1_c), dim=d,
                             metric=metric).numpy()
    eps_max = ref.quant_eps_tile(d_lo, d_hi, torch.tensor([l1_r.max()]),
                                 torch.tensor([l1_c.max()]), dim=d,
                                 metric=metric).numpy()[0, 0]
    reject = F32(thr - eps_max)
    bound = F32(thr - eps)               # the exact test: s >= thr - eps
    # each entry's real boundary in x, and dots packed around it
    div = 2.0 * float(sprod) if metric == "l2" else float(sprod)
    xstar = (bound.astype(np.float64) + cn[None, :] + rn[:, None]) / div
    off = np.concatenate([np.arange(-40, 41), rng.uniform(-1e4, 1e4, 40)])
    if qmode == "int8":
        x = np.round(xstar[..., None] + off).astype(np.int64)
    else:
        x = (xstar[..., None] * (1 + off * 2.0 ** -23)).astype(F32)
    s = _exact_score(x, cn[None, :, None], rn[:, None, None], sprod, metric)
    keep = s >= bound[..., None]
    passed = _prefilter(x, cn[None, :, None], rn[:, None, None], reject,
                        sprod, cn.max(), rn.max(), metric, qmode)
    assert keep.any() and (~keep).any()
    assert not (keep & ~passed).any()
    # and it is tight: what passes lies within 2^-16 of the score's
    # magnitude (and, for int8, the two floors' x units) below reject
    slack = (2.0 ** -16 * (abs(float(reject)) + 2 * (cn.max() + rn.max()))
             + 4.0 * float(sprod))
    assert not (passed & (s < reject - slack)).any()


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("metric", ["dot", "l2"])
def test_b7_prefilter_wide_int8(seed, metric):
    """Past d = 1,040 an int8 dot (up to d * 127^2 <= 2^30 on the route)
    rounds once to float32 before the exact test.  Every entry that test
    keeps still passes the integer prefilter, and x - B_c stays an int32
    (no wrap), for dots drawn around each boundary by integers and by
    float32 steps of x."""
    rng = np.random.default_rng(200 + seed)
    m, n = 32, 64
    d = int(rng.choice([1041, 4096, INT8_TC_MAX_D]))
    xmax = d * 127 * 127
    scale = (10.0 ** rng.uniform(-3, -1, 2)).astype(F32)
    sprod = F32(scale[0] * scale[1])
    d_lo, d_hi = F32(scale[0] / 2), F32(scale[1] / 2)
    l1_r = rng.uniform(0, 127 * d * scale[0], m).astype(F32)
    l1_c = rng.uniform(0, 127 * d * scale[1], n).astype(F32)
    if metric == "l2":
        rn = rng.uniform(0, xmax * scale[0] ** 2, m).astype(F32)
        cn = rng.uniform(0, xmax * scale[1] ** 2, n).astype(F32)
    else:
        rn, cn = np.zeros(m, F32), np.zeros(n, F32)
    thr = F32(rng.uniform(-0.5, 0.5) * xmax * sprod)
    eps = ref.quant_eps_tile(d_lo, d_hi, torch.from_numpy(l1_r),
                             torch.from_numpy(l1_c), dim=d,
                             metric=metric).numpy()
    eps_max = ref.quant_eps_tile(d_lo, d_hi, torch.tensor([l1_r.max()]),
                                 torch.tensor([l1_c.max()]), dim=d,
                                 metric=metric).numpy()[0, 0]
    reject = F32(thr - eps_max)
    bound = F32(thr - eps)
    div = 2.0 * float(sprod) if metric == "l2" else float(sprod)
    xstar = (bound.astype(np.float64) + cn[None, :] + rn[:, None]) / div
    off = np.concatenate([np.arange(-40, 41), 128 * np.arange(-40, 41),
                          rng.uniform(-1e6, 1e6, 40)])
    x = np.clip(np.round(xstar[..., None] + off), -xmax, xmax)
    x = x.astype(np.int64)
    s = _exact_score(x, cn[None, :, None], rn[:, None, None], sprod, metric)
    keep = s >= bound[..., None]
    passed = _prefilter(x, cn[None, :, None], rn[:, None, None], reject,
                        sprod, cn.max(), rn.max(), metric, "int8")
    assert keep.any() and (~keep).any()
    assert not (keep & ~passed).any()
    b = np.floor(np.minimum(np.maximum(F32(cn * F32(F32(0.5 if metric == "l2"
                                                          else 1.0) / sprod)),
                                       F32(0)), F32(2.0 ** 30)))
    diff = x - b.astype(np.int64)[None, :, None]
    assert diff.min() >= -2 ** 31 and diff.max() < 2 ** 31


def _admit(offers, n):
    """The running list of topk_select.cuh as a host model: while the list
    has room every real candidate enters; then a candidate enters only if
    it comes before the list's worst entry, which it replaces."""
    lst = []
    for v, i in offers:
        if len(lst) < n:
            lst.append((v, i))
            continue
        w = max(range(n), key=lambda t: (-lst[t][0], lst[t][1]))
        if (-v, i) < (-lst[w][0], lst[w][1]):
            lst[w] = (v, i)
    return sorted(lst, key=lambda e: (-e[0], e[1]))


@pytest.mark.parametrize("seed", range(6))
def test_running_list_is_order_free(seed):
    """Candidates reach a list through the shared queues in whatever order
    the atomics give; the list still ends as the top n of everything
    offered under the (-score, index) order, identical offers included."""
    rng = np.random.default_rng(seed)
    m, n = int(rng.integers(5, 200)), int(rng.integers(1, 40))
    vals = rng.integers(-3, 4, m).astype(float)   # many equal scores
    ids = rng.integers(0, m // 2 + 1, m)           # and repeated offers
    offers = list(zip(vals.tolist(), ids.tolist()))
    want = sorted(offers, key=lambda e: (-e[0], e[1]))[:n]
    for _ in range(5):
        order = rng.permutation(m)
        assert _admit([offers[t] for t in order], n) == want
