"""A CPU model of B9's float32 routes on the TF32 tensor cores
(``csrc/flash_attention.cu``, ``csrc/flash_attention_bwd.cu``): every
product as the three-product split of ``csrc/tf32x3.cuh``, held against
the plain versions (``flash_block_plain``, ``flash_attention_bwd_plain``)
and the JAX package's plain attention under the kernels' own rules.

The emulation: an operand x is hi + lo with hi = x rounded to TF32 on its
bits (10 mantissa bits, nearest, ties away: half a TF32 ulp added, the 13
low bits cleared) and lo = x - hi; the tensor core reads lo's top 19 bits
(truncation).  a.b is a_lo.b_hi + a_hi.b_lo + a_hi.b_hi; the products of
TF32 values are exact in float32 and the float32 matmul accumulates them.
A bfloat16 input is exact in TF32, so its own lo term is dropped, as the
kernels drop it.  The forward walks the kernel's key tiles (64 keys, 32
at hd > 128) with its online softmax.

Rules (the card's tests hold the kernels to the same): forward partials
|got - want| <= 1e-5 |want| + 1e-5 max(1, max |want|) for o and
1e-5 |want| + 1e-5 for m and l; float32 gradients 1e-4 max(1, max |want|);
bfloat16 gradients (rounded to bfloat16, as the kernel writes them)
2^-6 |want| + 2^-8 max |want|.  One TF32 product a multiply-add (operands
rounded to nearest, the favourable case) must fail the forward rule, so
the model's pass is not vacuous.
"""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels import ref as r_ref
from repro_torch.kernels.flash_attention import (flash_attention_bwd_plain,
                                                 flash_attention_plain,
                                                 flash_block_plain)

NEG_INF = -1e30


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """x rounded to TF32, nearest with ties away from zero, on the bits."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def tf32_trunc(x: torch.Tensor) -> torch.Tensor:
    """What the tensor core reads of a .tf32 operand: its top 19 bits."""
    return (x.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def mm3(a, b, exact_a=False, exact_b=False):
    """a @ b as the split's products, the small ones first; an exact
    operand (a bfloat16 input) has no lo."""
    ah, bh = tf32_round(a), tf32_round(b)
    out = torch.zeros(torch.broadcast_shapes(a.shape[:-2], b.shape[:-2])
                      + (a.shape[-2], b.shape[-1]))
    if not exact_a:
        out = out + tf32_trunc(a - ah) @ bh
    if not exact_b:
        out = out + ah @ tf32_trunc(b - bh)
    return out + ah @ bh


def mm1(a, b, exact_a=False, exact_b=False):
    """a @ b as one TF32 product (operands rounded to nearest)."""
    return tf32_round(a) @ tf32_round(b)


def visible(Tq, Tk):
    i = torch.arange(Tq)[:, None]
    return torch.arange(Tk)[None, :] <= i + (Tk - Tq)


def flash_partial_model(q, k, v, causal, mm):
    """(o unnormalized, m, l) of the forward kernel: q [B, Tq, H, hd], k / v
    [B, Tk, KV, hd] float32, the kernel's key tiles and online softmax,
    every product by ``mm``."""
    B, Tq, H, hd = q.shape
    Tk, KV = k.shape[1], k.shape[2]
    G, bk = H // KV, 32 if hd > 128 else 64
    qg = q.reshape(B, Tq, KV, G, hd).permute(0, 2, 3, 1, 4)   # B KV G Tq hd
    kt = k.permute(0, 2, 1, 3)[:, :, None]                    # B KV 1 Tk hd
    vt = v.permute(0, 2, 1, 3)[:, :, None]
    qs = qg * np.float32(1.0 / math.sqrt(hd))   # the kernel's q * hd^-1/2
    m = torch.full(qg.shape[:-1], NEG_INF)
    l = torch.zeros(qg.shape[:-1])
    o = torch.zeros(qg.shape)
    vis = visible(Tq, Tk)
    for k0 in range(0, Tk, bk):
        k1 = min(Tk, k0 + bk)
        s = mm(qs, kt[..., k0:k1, :].transpose(-1, -2))
        if causal:
            s = torch.where(vis[:, k0:k1], s, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1))
        corr = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * corr + p.sum(-1)
        o = o * corr[..., None] + mm(p, vt[..., k0:k1, :])
        m = m_new
    o = o.permute(0, 3, 1, 2, 4).reshape(B, Tq, H, hd)
    m = m.permute(0, 3, 1, 2).reshape(B, Tq, H)
    l = l.permute(0, 3, 1, 2).reshape(B, Tq, H)
    return o, m, l


def bwd_model(q, k, v, o, lse, do, causal, mm, exact=False):
    """(dq, dk, dv) float32 of the backward kernels' five products by
    ``mm``; ``exact``: q / k / v / dO are bfloat16 values (no lo)."""
    B, Tq, H, hd = q.shape
    Tk, KV = k.shape[1], k.shape[2]
    G, c = H // KV, np.float32(1.0 / math.sqrt(hd))

    def heads(x):                                          # B KV G T hd
        return x.float().reshape(B, x.shape[1], KV, G, hd).permute(
            0, 2, 3, 1, 4)

    qg, og, dog = heads(q), heads(o), heads(do)
    kt = k.float().permute(0, 2, 1, 3)[:, :, None]         # B KV 1 Tk hd
    vt = v.float().permute(0, 2, 1, 3)[:, :, None]
    D = (dog * og).sum(-1)
    lse_g = lse.reshape(B, Tq, KV, G).permute(0, 2, 3, 1)
    s = mm(qg, kt.transpose(-1, -2), exact, exact)
    dp = mm(dog, vt.transpose(-1, -2), exact, exact)
    p = torch.exp(s * c - lse_g[..., None])
    ds = p * (dp - D[..., None])
    if causal:
        vis = visible(Tq, Tk)
        none = ~vis.any(-1)
        p = torch.where(none[:, None], 1.0 / Tk, torch.where(vis, p, 0.0))
        ds = torch.where(vis, ds, 0.0)
    # dK / dV: the G heads' rows are one k dimension of the product
    pf = p.reshape(B, KV, G * Tq, Tk)
    dsf = ds.reshape(B, KV, G * Tq, Tk)
    dv = mm(pf.transpose(-1, -2), dog.reshape(B, KV, G * Tq, hd), False,
            exact)
    dk = mm(dsf.transpose(-1, -2), qg.reshape(B, KV, G * Tq, hd), False,
            exact) * c
    dq = mm(ds, kt, False, exact) * c
    return (dq.permute(0, 3, 1, 2, 4).reshape(B, Tq, H, hd),
            dk.permute(0, 2, 1, 3), dv.permute(0, 2, 1, 3))


def fwd_share(got, want):
    """Worst share of the forward partials' rule over o, m and l."""
    out = []
    for g, w, scaled in zip(got, want, (True, False, False)):
        top = max(1.0, float(w.abs().max())) if scaled else 1.0
        lim = 1e-5 * w.abs() + 1e-5 * top
        out.append(float(((g - w).abs() / lim).max()))
    return max(out)


def bwd_share(got, want, bf16):
    want = want.float()
    top = float(want.abs().max())
    if not bf16:
        return float((got - want).abs().max()) / (1e-4 * max(1.0, top))
    err = (got.bfloat16().float() - want).abs()
    return float((err / (2.0 ** -6 * want.abs() + 2.0 ** -8 * top)).max())


def make(B, Tq, Tk, KV, G, hd, seed, bf16=False):
    rng = np.random.default_rng(seed)
    arrs = [rng.normal(size=(B, T, h, hd)).astype(np.float32)
            for T, h in ((Tq, KV * G), (Tk, KV), (Tk, KV), (Tq, KV * G))]
    ts = [torch.from_numpy(a) for a in arrs]
    return [t.bfloat16() for t in ts] if bf16 else ts


# FLASH_CELLS' widths (tests/test_torch_kernels_gpu.py) at small T, and
# hd 1 and 3: (B, Tq, Tk, KV, G, hd)
FWD_CELLS = [(2, 100, 100, 2, 1, 64), (1, 70, 140, 1, 5, 80),
             (1, 96, 40, 1, 5, 64), (1, 127, 127, 1, 2, 16),
             (1, 128, 128, 2, 1, 96), (1, 129, 129, 1, 3, 128),
             (1, 70, 100, 1, 2, 256), (1, 80, 80, 1, 2, 36),
             (2, 90, 90, 1, 2, 1), (1, 65, 130, 1, 3, 3)]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("B,Tq,Tk,KV,G,hd", FWD_CELLS)
def test_split_forward_partials_within_rule(B, Tq, Tk, KV, G, hd, causal):
    """The split's flash partial within the 1e-5 rule of the plain flash
    block; its normalized output within 1e-5 of the JAX package's plain
    attention."""
    q, k, v, _ = make(B, Tq, Tk, KV, G, hd, Tq * 7 + hd)
    got = flash_partial_model(q, k, v, causal, mm3)
    want = flash_block_plain(q, k, v, causal=causal)
    assert fwd_share(got, want) <= 1.0
    if causal and Tq > Tk:      # rows that see no key: p = 1 on every key
        assert bool((got[1][:, :Tq - Tk] == NEG_INF).all())
        assert bool((got[2][:, :Tq - Tk] == Tk).all())
    o = got[0] / got[2].clamp_min(1e-30)[..., None]
    jx = np.array(r_ref.flash_attention(*(jnp.asarray(t.numpy())
                                            for t in (q, k, v)),
                                          causal=causal))
    torch.testing.assert_close(o, torch.from_numpy(jx), rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(o, flash_attention_plain(q, k, v,
                                                        causal=causal),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("hd", [1, 64, 128, 256])
def test_one_tf32_product_breaks_the_forward_rule(hd):
    """One TF32 product a multiply-add puts the partials outside the rule
    the split keeps (so the rule can tell the two apart)."""
    q, k, v, _ = make(1, 256, 256, 1, 2, hd, 40 + hd)
    want = flash_block_plain(q, k, v, causal=True)
    one = fwd_share(flash_partial_model(q, k, v, True, mm1), want)
    split = fwd_share(flash_partial_model(q, k, v, True, mm3), want)
    assert one > 1.0 and split <= 1.0 and one > 8 * split


def mm64(a, b, exact_a=False, exact_b=False):
    return a @ b


@pytest.mark.parametrize("seed", [3, 4])
@pytest.mark.parametrize("large", [2.0, 4.0, 8.0])
def test_split_forward_large_scores(large, seed):
    """Scores of std large^1.5 (q and k scaled up; at 8 a near one-hot
    softmax with scores up to ~90), held to a float64 evaluation of the
    same partials: the plain float32 version itself reads up to 0.71 of
    the rule there.  The split stays within twice the plain version's
    share (and within the rule up to 4); one TF32 product is far outside
    it.  On the card the kernel reads below the plain version (PERF.md)."""
    q, k, v, _ = make(1, 128, 128, 1, 2, 128, seed)
    q, k = q * large, k * math.sqrt(large)
    truth = tuple(x.float() for x in flash_partial_model(
        q.double(), k.double(), v.double(), True, mm64))
    plain = fwd_share(flash_block_plain(q, k, v, causal=True), truth)
    split = fwd_share(flash_partial_model(q, k, v, True, mm3), truth)
    assert split <= 2.0 * max(plain, 0.5)
    if large <= 4.0:
        assert split <= 1.0
    assert fwd_share(flash_partial_model(q, k, v, True, mm1), truth) > 100.0


# FLASH_BWD_CELLS' widths at small T (B, Tq, Tk, KV, G, hd, causal, bf16):
# float32 at every width, bf16 at the widths the tf32x3 route takes (hd
# not a multiple of 8, or above 128)
BWD_CELLS = [(1, 100, 100, 2, 3, 128, True, False),
             (2, 100, 100, 2, 2, 64, True, False),
             (1, 96, 40, 1, 5, 64, True, False),
             (1, 130, 97, 2, 3, 80, False, False),
             (1, 33, 65, 2, 2, 256, True, False),
             (1, 60, 60, 1, 2, 1, True, False),
             (1, 129, 100, 2, 2, 36, True, True),
             (1, 90, 70, 1, 4, 256, True, True),
             (1, 70, 90, 1, 3, 136, False, True),
             (1, 64, 64, 1, 2, 250, True, True)]


@pytest.mark.parametrize("B,Tq,Tk,KV,G,hd,causal,bf16", BWD_CELLS)
def test_split_backward_within_rule(B, Tq, Tk, KV, G, hd, causal, bf16):
    """dq / dk / dv of the five split products (bf16: S and dP one product,
    the other three two) within the kernels' gradient rules of the plain
    backward on the same q, k, v, o, lse, dO."""
    q, k, v, do = make(B, Tq, Tk, KV, G, hd, Tq + Tk + hd, bf16)
    o = flash_attention_plain(q, k, v, causal=causal)
    _o, m, l = flash_block_plain(q, k, v, causal=causal)
    lse = m + torch.log(l)
    want = flash_attention_bwd_plain(q, k, v, o, lse, do, causal=causal)
    got = bwd_model(q, k, v, o, lse, do, causal, mm3, exact=bf16)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert bwd_share(g, w, bf16) <= 1.0
