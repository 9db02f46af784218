"""A plain-torch model of B10's tiled algorithm (``csrc/ssd_chunk.cu``),
held on the CPU against the plain intra-chunk step and, through
``ssd_inter_chunk``, against the JAX package's chunked scan and its
sequential oracle.

The model does what the kernel does, in the kernel's order of tiles:
C·Bᵀ formed once per (batch row, chunk) for every head, in 64-row
i-tiles; below the diagonal tile the decay factored about one reference
row r = i0 - 1 (``exp(cums_i - cums_j) = u_i v_j``, both factors <= 1
where every dt * A <= 0), the rows scaled by u once; on the diagonal
tile, and on every tile of a head with some dt * A > 0, the explicit
masked exponent.  It runs in float64 and in float32 over the cells the
card's tests use: the usual ranges, a chunk whose cumsum spans far more
than 88 (dt up to 2, A down to -16: a single reference for the whole
chunk would overflow), and heads that grow.  Tolerance: the reference's
1e-4 kernel limit; the float64 model also agrees with a float64
evaluation of the plain formula to 1e-10 (the factorisation is exact
algebra).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as r_ref
from repro.models import ssm as r_ssm
from repro_torch.kernels import ref
from repro_torch.kernels.ssd_chunk import ssd_inter_chunk

TILE = 64      # rows of the kernel's i-tile
H, P, N = 5, 8, 16


def tiles_model(x, dt, A, Bm, Cm, *, chunk: int, tile: int = TILE):
    """B10's tiled algorithm in plain torch, in the inputs' dtype.
    Returns (y [B, T, H, P], S [B, nc, H, N, P], cd [B, T, H])."""
    Bsz, T, Hh, Pd = x.shape
    Nn = Bm.shape[-1]
    L, nc = chunk, T // chunk
    xc = x.reshape(Bsz, nc, L, Hh, Pd)
    dtc = dt.reshape(Bsz, nc, L, Hh)
    Bc, Cc = Bm.reshape(Bsz, nc, L, Nn), Cm.reshape(Bsz, nc, L, Nn)
    a = dtc * A
    cums = torch.cumsum(a, dim=2)                           # [B, nc, L, H]
    explicit = (a > 0).any(dim=2)[:, :, None, :, None]      # [B, nc, 1, H, 1]
    y = torch.zeros_like(xc)
    for i0 in range(0, L, tile):
        i1 = min(i0 + tile, L)
        rows = torch.arange(i0, i1)
        # the strip C_i . B_j, j < i1, once for all heads, 0 above the diagonal
        strip = torch.einsum("bcin,bcjn->bcij", Cc[:, :, i0:i1], Bc[:, :, :i1])
        strip = torch.where(torch.arange(i1)[None, :] <= rows[:, None],
                            strip, 0.0)
        acc = torch.zeros_like(xc[:, :, i0:i1])
        if i0 > 0:
            ref_row = cums[:, :, i0 - 1:i0]
            v = torch.exp(ref_row - cums[:, :, :i0])            # <= 1
            u = torch.exp(cums[:, :, i0:i1] - ref_row)          # <= 1
            xs = xc[:, :, :i0] * (v * dtc[:, :, :i0])[..., None]
            factored = torch.einsum("bcij,bcjhp->bcihp", strip[..., :i0], xs)
            factored = factored * u[..., None]
            seg = cums[:, :, i0:i1, None, :] - cums[:, :, None, :i0, :]
            exact = torch.einsum("bcij,bcijh,bcjh,bcjhp->bcihp",
                                 strip[..., :i0], torch.exp(seg),
                                 dtc[:, :, :i0], xc[:, :, :i0])
            acc = torch.where(explicit, exact, factored)
        # the diagonal tile: the exponent only where j <= i
        seg = cums[:, :, i0:i1, None, :] - cums[:, :, None, i0:i1, :]
        tril = (torch.arange(i0, i1)[None, :] <= rows[:, None])[..., None]
        decay = torch.where(tril, torch.exp(torch.where(tril, seg, 0.0)), 0.0)
        acc = acc + torch.einsum("bcij,bcijh,bcjh,bcjhp->bcihp",
                                 strip[..., i0:i1], decay, dtc[:, :, i0:i1],
                                 xc[:, :, i0:i1])
        y[:, :, i0:i1] = acc
    dend = torch.exp(cums[:, :, -1:] - cums) * dtc
    S = torch.einsum("bcjn,bcjh,bcjhp->bchnp", Bc, dend, xc)
    return y.reshape(Bsz, T, Hh, Pd), S, torch.exp(cums).reshape(Bsz, T, Hh)


def plain64(x, dt, A, Bm, Cm, *, chunk: int):
    """The plain intra-chunk formula (``ref.ssd_intra_chunk``) in the
    inputs' dtype, without its cast to float32."""
    Bsz, T, Hh, Pd = x.shape
    L, nc, Nn = chunk, T // chunk, Bm.shape[-1]
    xc = x.reshape(Bsz, nc, L, Hh, Pd)
    dtc = dt.reshape(Bsz, nc, L, Hh)
    Bc, Cc = Bm.reshape(Bsz, nc, L, Nn), Cm.reshape(Bsz, nc, L, Nn)
    cums = torch.cumsum(dtc * A, dim=2)
    CB = torch.einsum("bcln,bcmn->bclm", Cc, Bc)
    seg = cums[:, :, :, None, :] - cums[:, :, None, :, :]
    tril = torch.ones(L, L, dtype=torch.bool).tril()[None, None, :, :, None]
    decay = torch.where(tril, torch.exp(torch.where(tril, seg, 0.0)), 0.0)
    W = CB[..., None] * decay * dtc[:, :, None, :, :]
    y = torch.einsum("bclmh,bcmhp->bclhp", W, xc).reshape(Bsz, T, Hh, Pd)
    dend = torch.exp(cums[:, :, -1:, :] - cums) * dtc
    S = torch.einsum("bclh,bcln,bclhp->bchnp", dend, Bc, xc)
    return y, S, torch.exp(cums).reshape(Bsz, T, Hh)


def make_cell(cell: str, L: int, seed: int):
    """numpy inputs for one cell, T = 2 L: ``usual`` (dt in [0.01, 0.2], A
    in -[0.5, 2]), ``span`` (dt a multiple of 1/8 up to 2, integer A down
    to -16: exact cumsums spanning hundreds within a chunk) or ``grow``
    (some heads with A > 0)."""
    rng = np.random.default_rng(seed)
    T = 2 * L
    x = rng.normal(size=(1, T, H, P))
    Bm, Cm = rng.normal(size=(2, 1, T, N))
    if cell == "span":
        dt = rng.integers(1, 17, size=(1, T, H)) / 8
        A = np.array([-16.0, -9.0, -3.0, -1.0, -16.0])
    else:
        dt = rng.uniform(0.01, 0.2, size=(1, T, H))
        A = -rng.uniform(0.5, 2, size=(H,))
        if cell == "grow":
            A[[0, 3]] = [0.1, 0.05]
    return [v.astype(np.float32) for v in (x, dt, A, Bm, Cm)]


CELLS = [("usual", 16), ("usual", 96), ("usual", 256), ("span", 64),
         ("span", 96), ("grow", 16), ("grow", 96)]


@pytest.mark.parametrize("cell,L", CELLS)
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_tiles_match_plain(cell, L, dtype):
    """The model's y, S and cd against the plain intra-chunk step (1e-4),
    and in float64 against the plain formula in float64 (1e-10)."""
    args = make_cell(cell, L, L)
    got = tiles_model(*(torch.tensor(v, dtype=dtype) for v in args),
                      chunk=L)
    want = ref.ssd_intra_chunk(*(torch.tensor(v) for v in args), chunk=L)
    for g, w in zip(got, want):
        assert bool(torch.isfinite(g).all())
        torch.testing.assert_close(g.float(), w, rtol=1e-4, atol=1e-4)
    if dtype == torch.float64:
        exact = plain64(*(torch.tensor(v, dtype=dtype) for v in args),
                        chunk=L)
        for g, w in zip(got, exact):
            torch.testing.assert_close(g, w, rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize("L", [64, 96])
def test_tiles_factors_stay_below_one(L):
    """On the span cell the model's u and v are finite and <= 1 in
    float32, where one reference for the whole chunk (exp(cums_i) times
    exp(-cums_j)) overflows."""
    _x, dt, A, _B, _C = (torch.tensor(v) for v in make_cell("span", L, L))
    cums = torch.cumsum((dt * A).reshape(1, 2, L, H), dim=2)
    assert float((cums[:, :, 0] - cums[:, :, -1]).max()) > 88
    with torch.no_grad():
        naive = torch.exp(-cums)
    assert not bool(torch.isfinite(naive).all())
    for i0 in range(TILE, L, TILE):
        ref_row = cums[:, :, i0 - 1:i0]
        v = torch.exp(ref_row - cums[:, :, :i0])
        u = torch.exp(cums[:, :, i0:i0 + TILE] - ref_row)
        for f in (u, v):
            assert bool(torch.isfinite(f).all()) and float(f.max()) <= 1


@pytest.mark.parametrize("cell,L", CELLS)
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_tiles_through_inter_chunk_match_jax(cell, L, dtype):
    """The model's step carried through ``ssd_inter_chunk`` against the
    JAX package's chunked scan (y and the final state) and its sequential
    oracle (1e-4)."""
    args = make_cell(cell, L, L + 1)
    y_i, S, cd = tiles_model(*(torch.tensor(v, dtype=dtype) for v in args),
                             chunk=L)
    Cm = torch.tensor(args[4])
    y, h_end = ssd_inter_chunk(y_i.float(), S.float(), cd.float(), Cm,
                               chunk=L)
    wy, wh = r_ssm.ssd_chunked(*(jnp.asarray(v) for v in args), L)
    np.testing.assert_allclose(y.numpy(), np.asarray(wy), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(h_end.numpy(), np.asarray(wh), rtol=1e-4,
                               atol=1e-4)
    seq = r_ref.ssd_chunk(*(jnp.asarray(v) for v in args))
    np.testing.assert_allclose(y.numpy(), np.asarray(seq), rtol=1e-4,
                               atol=1e-4)
