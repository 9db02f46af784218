"""A plain-torch model of B9's ``"wgmma"`` backward
(``csrc/flash_attention_bwd_tc.cu``) in the kernel's own order, held on the
CPU against the plain backward ``repro_torch.kernels.ref.
flash_attention_bwd``, a float64 evaluation of the plain formula and
``jax.vjp`` of the JAX package's plain attention; and the launch plan
``bwd_plan`` that the kernel and the model share.

The model walks the fused launch's blocks in their linear order (key tile
major), each block its units (query tiles from the last down, the head
slice's heads within each): S^T and dP^T of the block's keys against the
unit's rows, P^T and dS^T by the rule of ``csrc/flash_bwd.cuh``
(``p_ds``), dV += P^T dO and dK += dS^T Q, and the unit's dQ = dS K added
into its query tile's chain: key tile 0 writes it, each later key tile
adds to it, the last of the chain scales it.  dK and dV are the slices'
partials summed in slice order.  The bf16 variant rounds P and dS to
bfloat16 where the kernel does (the operands of their products).

Tolerances: in float64 the model agrees with the plain formula in float64
to 1e-10 (the same sums in other orders); in float32 with the plain
backward and with ``jax.vjp`` to 2e-5 of max(1, max |g|); the bf16 variant
with the plain backward within the card's bf16 rule, 2^-6 |want| + 2^-8
max |want|.
"""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.kernels import ref as r_ref
from repro_torch.kernels import ref
from repro_torch.kernels.flash_attention import BwdPlan, bwd_plan

KV, B = 2, 1


@pytest.fixture(autouse=True)
def one_thread():
    """The model runs thousands of tiny products: one intra-op thread a
    test process keeps parallel test workers from thrashing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
# (Tq, Tk): equal, Tq < Tk, Tq > Tk (causal: the first rows see no key);
# none a multiple of 64
SHAPES = [(200, 200), (150, 300), (300, 130)]
# (G, slices)
HEADS = [(1, 1), (3, 1), (3, 3), (5, 3), (12, 3)]
HDS = (16, 64, 80, 128)
CELLS = [(causal, Tq, Tk, G, s, HDS[(i + j) % len(HDS)])
         for causal in (True, False)
         for i, (Tq, Tk) in enumerate(SHAPES)
         for j, (G, s) in enumerate(HEADS)]


def make_inputs(Tq, Tk, G, hd, seed, bf16=False):
    rng = np.random.default_rng(seed)
    q, do = (rng.normal(size=(B, Tq, KV * G, hd)) for _ in range(2))
    k, v = (rng.normal(size=(B, Tk, KV, hd)) for _ in range(2))
    out = [a.astype(np.float32) for a in (q, k, v, do)]
    if bf16:   # values a bf16 tensor holds
        out = [torch.tensor(a).bfloat16().float().numpy() for a in out]
    return out


def forward(q, k, v, causal):
    """Plain attention in the inputs' dtype: (o, lse) with the finite
    NEG_INF mask (a row that sees no key averages v)."""
    Bb, Tq, H, hd = q.shape
    Tk, kv = k.shape[1], k.shape[2]
    qg = q.reshape(Bb, Tq, kv, H // kv, hd)
    s = torch.einsum("bqkgh,bskh->bkgqs", qg, k) / math.sqrt(hd)
    if causal:
        s = torch.where(ref.causal_visible(Tq, Tk, s.device), s, -1e30)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True)
    o = torch.einsum("bkgqs,bskh->bkgqh", p / l, v)
    o = o.reshape(Bb, H, Tq, hd).permute(0, 2, 1, 3)
    lse = (m + torch.log(l))[..., 0].reshape(Bb, H, Tq).permute(0, 2, 1)
    return o.contiguous(), lse.contiguous()


def plain_bwd(q, k, v, o, lse, do, causal):
    """``ref.flash_attention_bwd``'s formula in the inputs' dtype (no cast
    to float32)."""
    Bb, Tq, H, hd = q.shape
    Tk, kv = k.shape[1], k.shape[2]
    G, c = H // kv, 1.0 / math.sqrt(hd)
    qg = q.reshape(Bb, Tq, kv, G, hd)
    dog = do.reshape(Bb, Tq, kv, G, hd)
    lse_g = lse.reshape(Bb, Tq, kv, G).permute(0, 2, 3, 1)
    D = (do * o).sum(-1).reshape(Bb, Tq, kv, G).permute(0, 2, 3, 1)
    s = torch.einsum("bqkgh,bskh->bkgqs", qg, k) * c
    p = torch.exp(s - lse_g[..., None])
    if causal:
        vis = ref.causal_visible(Tq, Tk, q.device)
        none = ~vis.any(dim=-1)
        p = torch.where(none[:, None], 1.0 / Tk, torch.where(vis, p, 0.0))
    dv = torch.einsum("bkgqs,bqkgh->bskh", p, dog)
    ds = p * (torch.einsum("bqkgh,bskh->bkgqs", dog, v) - D[..., None])
    if causal:
        ds = torch.where(vis, ds, 0.0)
    dq = torch.einsum("bkgqs,bskh->bqkgh", ds, k) * c
    dk = torch.einsum("bkgqs,bqkgh->bskh", ds, qg) * c
    return dq.reshape(Bb, Tq, H, hd), dk, dv


def tiles_model(q, k, v, o, lse, do, *, causal: bool, plan: BwdPlan,
                bf16: bool = False):
    """The ``"wgmma"`` backward's algorithm in plain torch, in its order,
    in the inputs' dtype -> (dq, dk, dv)."""
    Bb, Tq, H, hd = q.shape
    Tk, kv = k.shape[1], k.shape[2]
    G, c, off = H // kv, 1.0 / math.sqrt(hd), Tk - Tq
    bq, bk = plan.bq, plan.bk
    D = (do * o).sum(-1)                                      # prologue
    dq = torch.zeros_like(q)
    dkp = torch.zeros((plan.slices,) + k.shape, dtype=q.dtype)
    dvp = torch.zeros_like(dkp)
    chain = {}            # (b, h, qt) -> (last key tile added, dQ sum)
    chain_len = plan.chain_len

    def rnd(x):
        return x.to(torch.bfloat16).to(x.dtype) if bf16 else x

    for blk in range(plan.blocks):
        kt, b, kvh, sl = plan.block(blk)
        keys = torch.arange(kt * bk, min(kt * bk + bk, Tk))
        K, V = k[b, keys, kvh], v[b, keys, kvh]               # resident
        dk_acc = torch.zeros_like(K)
        dv_acc = torch.zeros_like(V)
        for qt, g in plan.units(kt, sl):
            h = kvh * G + g
            rows = torch.arange(qt * bq, min(qt * bq + bq, Tq))
            Q, dO = q[b, rows, h], do[b, rows, h]
            L, Dr = lse[b, rows, h], D[b, rows, h]
            St, dPt = K @ Q.T, V @ dO.T                       # [keys, rows]
            Pt = torch.exp(St * c - L[None, :])
            dSt = Pt * (dPt - Dr[None, :])
            if causal:
                i, j = rows[None, :], keys[:, None]
                none, vis = i + off < 0, j <= i + off
                Pt = torch.where(none, 1.0 / Tk, torch.where(vis, Pt, 0.0))
                dSt = torch.where(vis & ~none, dSt, 0.0)
            Pt, dSt = rnd(Pt), rnd(dSt)
            dv_acc = dv_acc + Pt @ dO
            dk_acc = dk_acc + dSt @ Q
            part = dSt.T @ K                                  # dS K
            key = (b, h, qt)
            if kt == 0:
                assert key not in chain
                acc = part
            else:
                prev_kt, prev = chain[key]
                assert prev_kt == kt - 1, "dQ chain out of order"
                acc = prev + part
            chain[key] = (kt, acc)
            if kt == chain_len[qt] - 1:
                dq[b, rows, h] = acc * c
        dkp[sl, b, keys, kvh] = dk_acc
        dvp[sl, b, keys, kvh] = dv_acc
    assert all(kt == chain_len[key[2]] - 1 for key, (kt, _) in chain.items())
    assert len(chain) == Bb * H * plan.nqt
    dk, dv = dkp[0], dvp[0]
    for s in range(1, plan.slices):                           # slice order
        dk, dv = dk + dkp[s], dv + dvp[s]
    return dq, dk * c, dv


def run(cell, dtype, bf16=False, seed=0):
    causal, Tq, Tk, G, s, hd = cell
    arrays = make_inputs(Tq, Tk, G, hd, seed + Tq + 3 * hd + G, bf16)
    q, k, v, do = (torch.tensor(a, dtype=dtype) for a in arrays)
    o, lse = forward(q, k, v, causal)
    plan = bwd_plan(B, Tq, Tk, KV * G, KV, hd, causal, slices=s)
    got = tiles_model(q, k, v, o, lse, do, causal=causal, plan=plan,
                      bf16=bf16)
    return arrays, (q, k, v, o, lse, do), got


def near(got, want, what):
    want = np.asarray(want, np.float64)
    t = 2e-5 * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(np.asarray(got, np.float64), want, rtol=0,
                               atol=t, err_msg=what)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("causal,Tq,Tk,G,s,hd", CELLS)
def test_tiles_match_plain(causal, Tq, Tk, G, s, hd, dtype):
    """The model's dq, dk, dv against ``ref.flash_attention_bwd`` (float32
    inputs, 2e-5 of max(1, max |g|)) and, in float64, against the plain
    formula in float64 (1e-10)."""
    _a, ins, got = run((causal, Tq, Tk, G, s, hd), dtype)
    want = ref.flash_attention_bwd(*(t.float() for t in ins), causal=causal)
    for name, g, w in zip("qkv", got, want):
        assert g.dtype == dtype and g.shape == w.shape
        assert bool(torch.isfinite(g).all())
        near(g.numpy(), w.numpy(), f"d{name} vs the plain backward")
    if dtype == torch.float64:
        exact = plain_bwd(*ins, causal)
        for g, w in zip(got, exact):
            torch.testing.assert_close(g, w, rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize("causal,Tq,Tk,G,s,hd", CELLS)
def test_tiles_match_jax_vjp(causal, Tq, Tk, G, s, hd):
    """The float32 model against ``jax.vjp`` of the JAX package's plain
    attention on the same numpy inputs (2e-5 of max(1, max |g|))."""
    arrays, _ins, got = run((causal, Tq, Tk, G, s, hd), torch.float32)
    q, k, v, do = arrays
    _, vjp = jax.vjp(lambda a, b, c: r_ref.flash_attention(
        a, b, c, causal=causal), *(jnp.asarray(a) for a in (q, k, v)))
    for name, g, w in zip("qkv", got, vjp(jnp.asarray(do))):
        near(g.numpy(), np.asarray(w), f"d{name} vs jax.vjp")


@pytest.mark.parametrize("causal,Tq,Tk,G,s,hd",
                         [c for c in CELLS if c[3] > 1])
def test_tiles_bf16_within_rule(causal, Tq, Tk, G, s, hd):
    """bf16 inputs, P and dS rounded to bf16 as the kernel rounds them:
    each gradient within the card's bf16 rule of the plain backward."""
    _a, ins, got = run((causal, Tq, Tk, G, s, hd), torch.float32, bf16=True)
    want = ref.flash_attention_bwd(*ins, causal=causal)
    for name, g, w in zip("qkv", got, want):
        lim = 2.0 ** -6 * w.abs() + 2.0 ** -8 * float(w.abs().max())
        assert float(((g - w).abs() / lim).max()) <= 0.5, name


PLANS = [(1, 200, 200, 6, 2, 64, True), (2, 150, 300, 12, 2, 128, True),
         (1, 300, 130, 24, 2, 80, True), (1, 300, 130, 15, 3, 16, False),
         (2, 257, 129, 10, 2, 128, True), (1, 64, 640, 5, 1, 64, True)]


@pytest.mark.parametrize("B_,Tq,Tk,H,KV_,hd,causal", PLANS)
@pytest.mark.parametrize("slices", [1, 3, None])
def test_plan_chain_order_and_coverage(B_, Tq, Tk, H, KV_, hd, causal,
                                       slices):
    """Every visible (query, key, head) triple of the grid is covered by
    exactly one block's unit; each (b, h, query tile)'s dQ chain is key
    tiles 0 .. chain_len - 1, each once, and every block's predecessor in
    a chain has a lower linear index (ncol below it)."""
    G = H // KV_
    s = min(slices, G) if slices else None
    plan = bwd_plan(B_, Tq, Tk, H, KV_, hd, causal, slices=s)
    off = Tk - Tq
    i = torch.arange(Tq)[:, None]
    j = torch.arange(Tk)[None, :]
    vis = (j <= i + off) | (i + off < 0) if causal \
        else torch.ones(Tq, Tk, dtype=torch.bool)
    cover = torch.zeros(B_, H, Tq, Tk, dtype=torch.int32)
    visits = {}
    for blk in range(plan.blocks):
        kt, b, kvh, sl = plan.block(blk)
        assert blk == kt * plan.ncol + (b * KV_ + kvh) * plan.slices + sl
        units = plan.units(kt, sl)
        qts = [qt for qt, _ in units]
        assert qts == sorted(qts, reverse=True)
        for qt, g in units:
            h = kvh * G + g
            rows = slice(qt * plan.bq, (qt + 1) * plan.bq)
            cover[b, h, rows, kt * plan.bk:(kt + 1) * plan.bk] += 1
            visits.setdefault((b, h, qt), []).append((kt, blk))
            for w in range(plan.bk // 64):   # a skipped warpgroup sees none
                keys = slice(kt * plan.bk + 64 * w, kt * plan.bk + 64 * w + 64)
                assert not (plan.skips(kt, w, qt) and bool(vis[rows, keys].any()))
    assert int(cover.max()) == 1
    assert bool((cover[:, :, vis] == 1).all())
    assert len(visits) == B_ * H * plan.nqt
    for (b, h, qt), chain in visits.items():
        assert [kt for kt, _ in chain] == list(range(plan.chain_len[qt]))
        for (_, prev), (_, blk) in zip(chain, chain[1:]):
            assert prev == blk - plan.ncol < blk


@pytest.mark.parametrize("G,s", [(1, 1), (3, 3), (5, 3), (12, 3), (12, 4),
                                 (12, 5), (8, 8), (7, 2)])
def test_plan_slices_partition_heads(G, s):
    """The s slices cut the G query heads of a kv head into contiguous runs
    that differ in size by at most one and cover each head once."""
    plan = bwd_plan(1, 64, 64, 2 * G, 2, 64, True, slices=s)
    runs = [list(plan.head_slice(sl)) for sl in range(s)]
    assert sum(runs, []) == list(range(G))
    sizes = {len(r) for r in runs}
    assert min(sizes) >= 1 and max(sizes) - min(sizes) <= 1
    with pytest.raises(ValueError):
        bwd_plan(1, 64, 64, 2 * G, 2, 64, True, slices=G + 1)


def test_plan_main_shapes():
    """The slice counts of the main path's shapes: starcoder2's training
    shape (128 key tiles) 4, about three blocks per SM of the H100;
    whisper's encoder (1,920 tiles) 1; the key tiles chained for causal
    Tq = Tk."""
    star = bwd_plan(2, 4096, 4096, 24, 2, 128, True)
    assert (star.slices, star.blocks, star.hdp) == (4, 512, 128)
    assert star.blocks >= 3 * 132
    # the tensor-core operations issued: 10 hd a visible pair, plus the
    # masked halves of the diagonal tiles
    counted = 10 * 128 * 2 * 24 * 4096 * 4097 // 2
    assert 1.0 < star.issued_ops() / counted < 1.03
    assert star.chain_len == tuple(qt // 2 + 1 for qt in range(64))
    whisper = bwd_plan(8, 1500, 1500, 20, 20, 64, False)
    assert (whisper.slices, whisper.blocks, whisper.hdp) == (1, 1920, 64)
    assert whisper.chain_len == (12,) * 24
    qwen = bwd_plan(1, 2048, 2048, 40, 8, 128, True)
    assert qwen.slices == 4
    assert [len(qwen.head_slice(s)) for s in range(4)] == [1, 1, 1, 2]
    assert bwd_plan(1, 300, 130, 24, 2, 128, True).chain_len == (2,) * 5
