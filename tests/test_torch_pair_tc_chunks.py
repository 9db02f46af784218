"""A CPU model of B7's and B8's bf16 tensor-core sums past d = 128
(``csrc/pairwise_threshold_q.cu``, ``csrc/pairwise_topk_q.cu``) and of their
int8 dots past d = 1,040, held against the file headers' arguments.

The model of a bf16 row: products of bf16 codes are exact; each 16-wide
k-step (one ``mma.sync`` m16n8k16) adds its products to the accumulator and
the result is truncated toward zero in float32 (the tensor cores do not
round to nearest); every ``BF16_CHUNK`` of d the chunk's sum joins a
float32 running sum, compensated (Kahan: t = run + chunk, the rounding
error (run - t) + chunk starts the next chunk's accumulator), in ascending
order.  Rows of up to 128 sum in one accumulator.  A second model, the
header's worst case, truncates each of a step's 17 terms (its products
and the accumulator) at the last place of the largest before it sums
them; rows built for it lose every small product and spend about 30 of
the 38 units its bound allows.  With either model:

  * B7's band (the plain version's eps, ``ref.quant_eps_tile``) keeps every
    pair of the plain f32 join, at d in {129, 256, 960, 4,096};
  * every modelled dot lies within the header's bound, (c + 2) 2^-23 S of
    the exact one (S the sum of |products|; (18 / 16 c + 2) 2^-23 S for
    the worst case), which eps's slack covers at any width up to
    ``BF16_TC_MAX_D``; and the compensated chunks bring the dots closer to
    float64 than one accumulator over the row or a float32 matmul (and,
    in the first model, than chunks joined by plain adds).

The kernels are built with this file's chunk length: ``_build`` passes
``BF16_CHUNK`` to them as -DREPRO_BF16_CHUNK (``csrc/chunk_join.cuh``).

int8: the exact s32 dot rounded once to float32 (the kernels'
``__int2float_rn``) equals a float64 evaluation rounded to float32 at d in
{1,041, 1,536, 4,096}, where float32 itself cannot hold every sum.
"""

import numpy as np
import pytest
import torch

from repro_torch.core import quant
from repro_torch.kernels import _build, ref
from repro_torch.kernels.pairwise_batch_q import (BF16_CHUNK, BF16_TC_MAX_D,
                                                  INT8_EXACT_D,
                                                  INT8_TC_MAX_D)

WIDTHS = (129, 256, 960, 4096)
ULP = 2.0 ** -23


@pytest.fixture(autouse=True)
def one_thread():
    """The model runs hundreds of small products a test: one intra-op
    thread a test process keeps parallel test workers from thrashing the
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def trunc_f32(x: torch.Tensor) -> torch.Tensor:
    """float64 values rounded toward zero to float32."""
    y = x.float()
    over = y.double().abs() > x.abs()
    return torch.where(over, torch.nextafter(y, torch.zeros_like(y)), y)


def aligned_step(acc: torch.Tensor, a: torch.Tensor, b: torch.Tensor):
    """One k-step as the header's worst case: the accumulator and each of
    the 16 products truncated toward zero at the last place of the largest
    of the 17 (float32's 24 bits at its exponent), summed, and the sum
    truncated to float32."""
    terms = torch.cat([acc.double()[..., None],
                       a[:, None, :] * b[None, :, :]], dim=-1)
    top = terms.abs().amax(-1, keepdim=True).clamp(min=2.0 ** -126)
    quantum = torch.exp2(torch.floor(torch.log2(top)) - 23)
    # each term is a multiple of quantum below 2^25 of them: exact in f64
    return trunc_f32((torch.trunc(terms / quantum) * quantum).sum(-1))


def tc_dots(a: torch.Tensor, b: torch.Tensor, chunk: int = BF16_CHUNK,
            kahan: bool = True, model: str = "step"):
    """The model's [m, n] float32 dots of bf16-valued float64 rows a [m, d]
    and b [n, d] (see the module docstring; ``kahan=False`` joins the
    chunks by plain adds; ``model="aligned"`` runs each k-step as
    :func:`aligned_step`, the header's worst case, instead of truncating
    only its exact sum)."""
    d = a.shape[1]
    pad = (-d) % 16
    a = torch.nn.functional.pad(a, (0, pad))
    b = torch.nn.functional.pad(b, (0, pad))
    chunk = chunk if d > 128 else a.shape[1]
    run = acc = torch.zeros(a.shape[0], b.shape[0], dtype=torch.float32)
    for k0 in range(0, a.shape[1], 16):
        if model == "aligned":
            acc = aligned_step(acc, a[:, k0:k0 + 16], b[:, k0:k0 + 16])
        else:
            acc = trunc_f32(acc.double()
                            + a[:, k0:k0 + 16] @ b[:, k0:k0 + 16].T)
        if (k0 + 16) % chunk == 0 or k0 + 16 == a.shape[1]:
            t = run + acc       # float32, rounding to nearest
            acc = (run - t) + acc if kahan else torch.zeros_like(acc)
            run = t
    return run


def rows(kind: str, n: int, d: int, seed: int) -> torch.Tensor:
    """float32 rows: non-negative clustered (the join's corpora: every
    product >= 0, where truncation errors add up) or standard normal."""
    g = torch.Generator().manual_seed(seed)
    if kind == "normal":
        return torch.randn(n, d, generator=g)
    centers = torch.rand(4, d, generator=g)
    x = centers[torch.randint(4, (n,), generator=g)] + 0.3 * torch.randn(
        n, d, generator=g)
    return x.clamp_(min=0.0)


def header_bound(d: int, chunk: int = BF16_CHUNK,
                 aligned: bool = False) -> float:
    """The header's bound on a dot's error, in units of 2^-23 S: c for the
    chunks' sums, 2 for the compensated joins, (d / c) 2^-24 for Kahan's
    second-order term (one accumulator at d <= 128: c = d, no join).
    ``aligned``: a step may miss by 18 ulps for its 16 products (every one
    of its 17 terms truncated at the largest's last place, then the sum),
    so the chunks' term is 18 / 16 c."""
    per = 18 / 16 if aligned else 1.0
    if d <= 128:
        return per * d
    return per * chunk + 2 + d / chunk * 2.0 ** -24


def test_certificate_arithmetic():
    """The route's bf16 limit satisfies the header's inequality, c + 2 +
    (d / c) 2^-24 <= 254, with room (also if a step missed by 18 ulps of
    its result instead of 16); without compensation (c + d / (2 c)) it
    would not hold there."""
    c = BF16_CHUNK
    assert c % 16 == 0 and c <= 128
    assert header_bound(BF16_TC_MAX_D) <= 254 and header_bound(128) <= 254
    assert header_bound(BF16_TC_MAX_D, aligned=True) <= 254
    assert header_bound(128, aligned=True) <= 254
    assert c + BF16_TC_MAX_D / (2 * c) > 254


@pytest.mark.parametrize("src", ["pairwise_threshold_q.cu",
                                 "pairwise_topk_q.cu"])
def test_kernels_build_with_the_modelled_chunk(src):
    """The chunk length this file models is the one the kernels are built
    with: ``_build`` passes BF16_CHUNK as -DREPRO_BF16_CHUNK to both, and
    neither source nor csrc/chunk_join.cuh fixes a length of its own."""
    flags = _build._flags(src)
    assert flags.count(f"-DREPRO_BF16_CHUNK={BF16_CHUNK}") == 1
    assert src in _build.CHUNKED and "chunk_join.cuh" in _build.HEADERS
    text = (_build.CSRC / src).read_text()
    assert '#include "chunk_join.cuh"' in text
    assert "int kChunk" not in text
    header = (_build.CSRC / "chunk_join.cuh").read_text()
    assert "constexpr int kChunk = REPRO_BF16_CHUNK;" in header
    assert not any(f.startswith("-DREPRO_BF16_CHUNK")
                   for f in _build._flags("pairwise_topk.cu"))


@pytest.mark.parametrize("model", ["step", "aligned"])
@pytest.mark.parametrize("kind", ["clustered", "normal"])
@pytest.mark.parametrize("d", WIDTHS)
def test_bf16_chunked_dots_within_header_bound(kind, d, model):
    """Every modelled dot is within the header's bound of the exact one
    ((c + 2) 2^-23 S, or (18 / 16 c + 2) 2^-23 S with each term truncated
    at the step's largest exponent), and the compensated chunks are no
    further from float64 than one accumulator over the whole row or the
    float32 matmul of the codes, and (step model) than chunks joined by
    plain adds."""
    x = rows(kind, 96, d, seed=d).bfloat16().double()
    a, b = x[:48], x[48:]
    exact = a @ b.T
    S = a.abs() @ b.abs().T
    got = tc_dots(a, b, model=model).double()
    err = (got - exact).abs()
    bound = header_bound(d, aligned=model == "aligned")
    assert bool((err <= bound * ULP * S).all())
    worst = float(err.max())
    others = [tc_dots(a, b, chunk=1 << 30, model=model), a.float() @ b.float().T]
    if model == "step":
        others.append(tc_dots(a, b, kahan=False))
    for other in others:
        assert worst <= float((other.double() - exact).abs().max())


@pytest.mark.parametrize("d", WIDTHS)
def test_bf16_aligned_worst_case_spends_the_margin(d):
    """Rows built so that truncation at the step's largest exponent bites
    every time: in each chunk one product near 1 and the rest just under
    its last place (2^-23 (1 - j / 256)), so each small product is lost
    in full.  The aligned model then misses by most of the chunks' term
    of the header's bound and still stays inside it; the gentler model,
    which truncates only each step's exact sum, misses by under 2 units."""
    c = BF16_CHUNK if d > 128 else 16 * -(-d // 16)
    g = torch.Generator().manual_seed(d)
    k = torch.arange(d)
    j = torch.randint(1, 9, (8, d), generator=g).double()
    a = torch.where(k % c == 0, 1.0 + j / 128, 2.0 ** -23 * (1 - j / 256))
    b = 2.0 ** torch.randint(-2, 3, (8, 1), generator=g).double() \
        * torch.ones(8, d, dtype=torch.float64)
    assert torch.equal(a.bfloat16().double(), a)
    exact = a @ b.T
    S = a.abs() @ b.abs().T
    units = ((tc_dots(a, b, model="aligned").double() - exact).abs()
             / (ULP * S))
    assert float(units.max()) <= header_bound(d, aligned=True)
    spent = (min(c, d) - 1) / min(c, d) * c * (d // c) / -(-d // c)
    assert float(units.min()) >= 0.75 * spent
    gentle = (tc_dots(a, b).double() - exact).abs() / (ULP * S)
    assert float(gentle.max()) < 2.0


@pytest.mark.parametrize("model", ["step", "aligned"])
@pytest.mark.parametrize("metric", ["l2", "dot"])
@pytest.mark.parametrize("d", WIDTHS)
def test_b7_bf16_band_keeps_every_f32_join_pair(d, metric, model):
    """B7's band over the modelled bf16 dots (either model), with the
    plain version's eps, holds every pair the plain f32 join keeps
    (threshold at the median pair, so half the pairs sit on either
    side)."""
    x = rows("clustered", 96, d, seed=10 + d)
    qc = quant.quantize_corpus(x, 2, 48, "bf16")
    codes = qc.q.double()
    dots = tc_dots(codes[:48], codes[48:], model=model)
    f32 = x[:48] @ x[48:].T
    sq, l1, delta = qc.sq, qc.l1, qc.delta
    if metric == "l2":
        band_s = (2.0 * dots - sq[48:][None, :]) - sq[:48][:, None]
        join_s = (2.0 * f32 - sq[48:][None, :]) - sq[:48][:, None]
    else:
        band_s, join_s = dots, f32
    thr = float(join_s.median())
    eps = ref.quant_eps_tile(delta[0], delta[1], l1[:48], l1[48:], dim=d,
                             metric=metric)
    kept = join_s >= thr
    band = band_s >= thr - eps
    assert 0 < int(kept.sum()) < kept.numel()
    assert bool(band[kept].all())
    # and the slack the argument spends: the modelled error stays inside
    # the eps term 2*d*d_lo*d_hi it is charged to
    err = (dots.double() - codes[:48] @ codes[48:].T).abs()
    slack = 2.0 * d * float(delta[0]) * float(delta[1])
    assert float(err.max()) <= slack


@pytest.mark.parametrize("d", [1041, 1536, 4096])
def test_int8_dot_rounded_once_equals_float64(d):
    """The kernels' int8 dot past 1,040: the s32 sum is exact (|dot| <=
    d * 127^2 < 2^31) and converts once, rounding to nearest; that equals
    the float64 evaluation of the dot rounded to float32.  Dots here pass
    2^24 (every code 127 but about one in 500), so float32 cannot hold
    every one, and from 1,536 on the plain float32 matmul misses some."""
    assert INT8_EXACT_D < d <= INT8_TC_MAX_D
    rng = np.random.default_rng(d)

    def codes(n):
        few = rng.random((n, d)) < 0.002
        return 127 - few * rng.integers(1, 4, (n, d))

    a = codes(64) * rng.choice([-1, 1], (64, 1))
    b = codes(48)
    exact = a.astype(np.int64) @ b.astype(np.int64).T
    assert 2 ** 24 < int(np.abs(exact).max()) < 2 ** 31
    once = exact.astype(np.float32)                  # __int2float_rn
    f64 = (a.astype(np.float64) @ b.astype(np.float64).T).astype(np.float32)
    assert np.array_equal(once, f64)
    if d >= 1536:
        plain = (torch.as_tensor(a, dtype=torch.float32)
                 @ torch.as_tensor(b, dtype=torch.float32).T).numpy()
        assert not np.array_equal(plain, once)
