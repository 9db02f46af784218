"""B3 pcit_filter on the CPU: a model of the kernel's prefilter
(``csrc/pcit_filter.cu``) held against its exact chain, and the wrapper's
launch grid and refusals.

The prefilter decides a trio from rsqrt.approx / rcp.approx of hoisted
terms and leaves it to the exact chain where the approximate margin is
within its error bound.  The model here takes every approximation at a
random sign of most of its documented error (2^-22 relative), so it errs
at least as much as the card does; on trios packed around their
boundaries, every trio it decides must agree with the exact chain.
``tests/test_torch_kernels_gpu.py`` runs the kernel's own prefilter on
the same trios.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import pcit_filter as b3

F32 = np.float32
EPS = F32(1e-12)
THIRD = F32(F32(1.0) / F32(3.0))
DOM_LO, DOM_HI = F32(2.0 ** -20), F32(1.0 - 2.0 ** -10)
TAU = F32(2.0 ** -19)
APPROX = 2.0 ** -22      # relative error of rsqrt.approx / rcp.approx


def exact_explains(a, b, c, third_by_division: bool = False):
    """The kernel's exact chain in float32, op for op (one IEEE rounding
    each; the mean is a product by float32(1/3), or with
    ``third_by_division`` a division by 3 as the plain version on the CPU
    rounds it)."""
    a, b, c = (np.asarray(t, F32) for t in (a, b, c))
    with np.errstate(all="ignore"):
        oma, omb, omc = F32(1) - a * a, F32(1) - b * b, F32(1) - c * c
        rxy_z = (a - b * c) / np.sqrt(np.maximum(omb * omc, EPS))
        rxz_y = (b - a * c) / np.sqrt(np.maximum(oma * omc, EPS))
        ryz_x = (c - a * b) / np.sqrt(np.maximum(oma * omb, EPS))
        s = rxy_z / (a + EPS) + rxz_y / (b + EPS) + ryz_x / (c + EPS)
        e = s / F32(3) if third_by_division else s * THIRD
        return (np.abs(a) <= np.abs(e * b)) & (np.abs(a) <= np.abs(e * c))


def ulp_step(x, n):
    """x (float32) moved by n (int64) representable floats, in order."""
    i = np.asarray(x, F32).view(np.int32).astype(np.int64)
    key = np.where(i < 0, -(i & 0x7FFFFFFF), i) + n
    key = np.clip(key, -0x7F7FFFFF, 0x7F7FFFFF)
    i = np.where(key < 0, (-key) | -0x80000000, key).astype(np.int32)
    return i.view(F32)


def prefilter_model(a, b, c, rng, frac: float = 0.7):
    """The kernel's prefilter with every approximate reciprocal off by
    +-frac * 2^-22 (random sign) before its float32 rounding: 1 explained,
    0 not, -1 left to the exact chain."""
    a, b, c = (np.asarray(t, F32) for t in (a, b, c))

    def approx(x64):
        s = rng.choice([-frac, frac], size=x64.shape) * APPROX
        return (x64 * (1.0 + s)).astype(F32)

    def hoist(r):
        om = F32(1) - r * r
        q = approx(1.0 / np.sqrt(om.astype(np.float64)))
        dom = (np.abs(r) >= DOM_LO) & (np.abs(r) <= DOM_HI)
        g = np.where(dom, approx(1.0 / (r + EPS).astype(np.float64)),
                     np.nan).astype(F32)
        return q, g

    with np.errstate(all="ignore"):
        (qa, ga), (qb, gb), (qc, gc) = hoist(a), hoist(b), hoist(c)
        t1 = (((a - b * c) * qb) * qc) * ga
        t2 = (((b - a * c) * qa) * qc) * gb
        t3 = (((c - a * b) * qa) * qb) * gc
        e = np.abs(((t1 + t2) + t3) * THIRD)
        bd = ((np.abs(t1) + np.abs(t2)) + np.abs(t3)) * TAU
        m = np.fmin(np.abs(b), np.abs(c))
        aa = np.abs(a)
        return np.where((e - bd) * m > aa, 1,
                        np.where((e + bd) * m < aa, 0, -1)).astype(np.int32)


def boundary_trios(rng, n_bc: int = 48, n_a: int = 1024):
    """Trios (a, b, c) float32 packed around the exact chain's boundary in
    a: for random (b, c), every a where the verdict flips on a grid is
    bisected to adjacent floats, and a is stepped from there by 0..8 ulps
    and by 2^4 .. 2^22 ulps either way; plus random trios."""
    sign = rng.choice([-1.0, 1.0], size=(2, n_bc))
    b = (sign[0] * rng.uniform(0.02, 0.99, n_bc)).astype(F32)
    c = (sign[1] * rng.uniform(0.02, 0.99, n_bc)).astype(F32)
    grid = np.linspace(-0.995, 0.995, n_a).astype(F32)
    v = exact_explains(grid[None, :], b[:, None], c[:, None])
    rows, cols = np.nonzero(v[:, 1:] != v[:, :-1])
    lo, hi = grid[cols].copy(), grid[cols + 1].copy()
    bb, cc = b[rows], c[rows]
    v_lo = v[rows, cols]
    for _ in range(64):
        mid = ((lo.astype(np.float64) + hi) / 2).astype(F32)
        same = exact_explains(mid, bb, cc) == v_lo
        lo = np.where(same, mid, lo)
        hi = np.where(same, hi, mid)
    steps = np.concatenate([np.arange(-8, 9), 2 ** np.arange(4, 23),
                            -(2 ** np.arange(4, 23))])
    a = ulp_step(lo[:, None], steps[None, :].astype(np.int64))
    bb = np.broadcast_to(bb[:, None], a.shape)
    cc = np.broadcast_to(cc[:, None], a.shape)
    n_rand = 20000
    ra = rng.uniform(-1, 1, n_rand).astype(F32)
    rb = rng.uniform(-1, 1, n_rand).astype(F32)
    rc = rng.uniform(-1, 1, n_rand).astype(F32)
    return (np.concatenate([a.ravel(), ra]), np.concatenate([bb.ravel(), rb]),
            np.concatenate([cc.ravel(), rc]))


# values at and past the prefilter's domain: |r| near and at 1, r + 1e-12
# at 0, tiny, subnormal, zero, NaN
EDGE_VALUES = np.array([1 - 2.0 ** -10, np.nextafter(F32(1 - 2.0 ** -10),
                                                    F32(1)),
                        1.0, -1.0, 0.99999994, -0.9999, 2.0 ** -20,
                        np.nextafter(F32(2.0 ** -20), F32(0)), -1e-12, 1e-12,
                        0.0, 1e-30, 5e-45, np.nan, 0.5, -0.3], dtype=F32)


def edge_trios():
    """Every combination of EDGE_VALUES for (a, b, c)."""
    g = np.stack(np.meshgrid(EDGE_VALUES, EDGE_VALUES, EDGE_VALUES,
                             indexing="ij")).reshape(3, -1)
    return g[0], g[1], g[2]


@pytest.mark.parametrize("seed", range(4))
def test_b3_prefilter_model_never_decides_against_exact(seed):
    """On trios packed around their boundaries (and random ones), the
    prefilter with its approximations at their worst decides only as the
    exact chain does; it still decides most random trios."""
    rng = np.random.default_rng(seed)
    a, b, c = boundary_trios(rng)
    exact = exact_explains(a, b, c)
    assert exact.any() and (~exact).any()
    for frac in (0.7, -0.7, 0.0):
        got = prefilter_model(a, b, c, rng, frac=abs(frac))
        decided = got >= 0
        assert bool((got[decided] == exact[decided]).all())
    # far from the boundary it does decide: the random tail
    got = prefilter_model(a[-20000:], b[-20000:], c[-20000:], rng)
    assert float((got >= 0).mean()) > 0.99


def test_b3_prefilter_model_leaves_edges_to_exact():
    """Out of the domain (|r| < 2^-20, |r| > 1 - 2^-10, NaN) nothing is
    decided by the prefilter; inside it, decisions agree."""
    a, b, c = edge_trios()
    got = prefilter_model(a, b, c, np.random.default_rng(0))
    dom = [(np.abs(t) >= DOM_LO) & (np.abs(t) <= DOM_HI) for t in (a, b, c)]
    inside = dom[0] & dom[1] & dom[2]
    assert bool((got[~inside] == -1).all())
    decided = got >= 0
    assert bool((got[decided] == exact_explains(a, b, c)[decided]).all())


def test_b3_bound_has_margin():
    """tau (2^-19) covers the header's error bound 4.91e-7 W with room for
    the float32 roundings of lo and hi: (tau - k) W >= 3.01 u |E'|, |E'| <=
    0.34 W."""
    u, d = 2.0 ** -24, APPROX
    term = (1 + d) ** 3 * (1 + u) ** 3.5 - 1
    k = (1 / 3 + u) * (term + 3.01 * u + 4.02 * u + 2 * u) * (1 + 1e-6)
    assert term <= 9.3e-7 and k <= 4.91e-7
    assert float(TAU) - k >= 3.01 * u * 0.34


@pytest.mark.parametrize("B,M,N,grid", [(1, 1, 1, (1, 1, 1)),
                                        (40, 1024, 1024, (32, 128, 40)),
                                        (2, 9, 33, (2, 2, 2)),
                                        (3, 8 * 65535, 64, (2, 65535, 3))])
def test_b3_launch_grid(B, M, N, grid):
    assert b3.launch_grid(B, M, N) == grid


@pytest.mark.parametrize("B,M", [(65536, 8), (1, 8 * 65535 + 1)])
def test_b3_launch_grid_refuses(B, M):
    with pytest.raises(ValueError, match="launch grid"):
        b3.launch_grid(B, M, 32)


def _args(B=1, M=2, N=3, Z=6):
    return (torch.zeros(B, M, N), torch.zeros(B, M, Z), torch.zeros(B, N, Z),
            torch.zeros(B, M, dtype=torch.int32),
            torch.zeros(B, N, dtype=torch.int32))


@pytest.mark.parametrize("kw,match", [
    (dict(visits=torch.zeros(1, 2, 3, dtype=torch.int64)), "visits"),
    (dict(visits=torch.zeros(1, 3, 2, dtype=torch.int32)), "visits"),
    (dict(stats=torch.zeros(2, dtype=torch.int64)), "stats"),
    (dict(stats=torch.zeros(3, dtype=torch.int32)), "stats"),
    (dict(), "CUDA")])
def test_b3_wrapper_refuses(kw, match):
    """Bad visits / stats operands are refused before anything is built,
    and CPU tensors always are."""
    with pytest.raises(ValueError, match=match):
        b3.pcit_filter_cuda(*_args(), **kw)


def test_b3_probe_refuses():
    x = torch.zeros(4)
    with pytest.raises(ValueError, match="one shape"):
        b3.pcit_probe_cuda(x, x, torch.zeros(5), exact=True)
    with pytest.raises(ValueError, match="float32"):
        b3.pcit_probe_cuda(x.double(), x, x, exact=True)
    with pytest.raises(ValueError, match="CUDA"):
        b3.pcit_probe_cuda(x, x, x, exact=False)


def test_b3_ulp_step():
    x = np.array([0.0, 1.0, -1.0, -0.0, 2.0 ** -149], dtype=F32)
    assert ulp_step(x, np.int64(1))[1] == np.nextafter(F32(1), F32(2))
    assert ulp_step(x, np.int64(1))[2] == np.nextafter(F32(-1), F32(0))
    assert ulp_step(x, np.int64(-1))[0] == -(2.0 ** -149)
    assert ulp_step(x, np.int64(-1))[4] == 0.0


def test_b3_exact_model_is_the_plain_chain():
    """The float32 model of the exact chain is the plain version's chain
    (kernels/ref.py) trio by trio, where both take the mean by a division
    by 3 (the kernel, as PyTorch's CUDA division by a scalar, multiplies
    by float32(1/3) instead)."""
    from repro_torch.kernels import ref
    a, b, c = boundary_trios(np.random.default_rng(5), n_bc=8, n_a=256)
    ea, eb, ec = edge_trios()
    a, b, c = (np.concatenate(t) for t in ((a, ea), (b, eb), (c, ec)))
    n = a.size
    keep = ref.pcit_filter(torch.from_numpy(a).view(n, 1, 1),
                           torch.from_numpy(b).view(n, 1, 1),
                           torch.from_numpy(c).view(n, 1, 1),
                           torch.full((n, 1), -1), torch.full((n, 1), -2))
    want = ~exact_explains(a, b, c, third_by_division=True)
    np.testing.assert_array_equal(keep.view(n).numpy(), want)
