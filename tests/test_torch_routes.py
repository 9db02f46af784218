"""Which kernel a B8 call launches, why its int8 route is exact, and what
the B4 / B8 wrappers refuse — all decided on the host, so all checked on
the CPU (the kernels themselves run in tests/test_torch_kernels_gpu.py).
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels.pairwise_batch_q import (BF16_TC_MAX_D,
                                                  INT8_EXACT_D,
                                                  pairwise_topk_q_cuda,
                                                  route_of)
from repro_torch.kernels.query_score import MAX_TOPK, query_topk_cuda


@pytest.mark.parametrize("dtype,d,route", [
    (torch.int8, 1, "tensor_cores"), (torch.int8, 128, "tensor_cores"),
    (torch.int8, 1040, "tensor_cores"), (torch.int8, 1041, "simt"),
    (torch.int8, 4096, "simt"), (torch.bfloat16, 24, "tensor_cores"),
    (torch.bfloat16, 128, "tensor_cores"), (torch.bfloat16, 129, "simt"),
    (torch.bfloat16, 1041, "simt")])
def test_b8_route_of(dtype, d, route):
    """int8 takes the tensor cores while its int32 sums convert to float32
    exactly (d <= 1,040), bf16 while their f32 accumulation stays within
    the tie rule (d <= 128); both take the float32 SIMT tile above."""
    assert route_of(dtype, d) == route


def test_route_limits():
    assert BF16_TC_MAX_D == 128
    assert INT8_EXACT_D == 1040
    worst = 127 * 127
    assert INT8_EXACT_D * worst < 2 ** 24 <= (INT8_EXACT_D + 1) * worst


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
    2^24 on an odd sum: float32 cannot hold it, so route_of sends int8
    rows this wide to the float32 tile, whose result is then the one the
    plain version's float32 matmul also has to round."""
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
