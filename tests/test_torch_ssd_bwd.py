"""B10's backward on the CPU: the plain gradient ``repro_torch.kernels.ref.
ssd_intra_chunk_bwd`` against torch autograd of the plain forward
(``ref.ssd_intra_chunk``) and against autograd of a float64 formula (the
per-chunk recurrence h_t = exp(dt_t A) h_{t-1} + dt_t B_t x_t^T, y_t = C_t
h_t, S = h_L, cd_t = exp(cums_t), independent of the masked-matrix form);
and the port's ``models.ssm.ssd_chunked`` (x, dt, A, B, C and h0) against
``jax.vjp`` of the JAX package's ``repro.models.ssm.ssd_chunked``, with
``ops.ssd_intra_chunk`` taking its CUDA branch on CPU tensors
(``ops.SsdIntraChunk``, the kernel wrappers replaced by counting plain
versions: the forward and the plain gradient where the kernels would run).

Cells: L in {1, 16, 64, 256} x N in {16, 128} x H in {1, 3, 8}, T = L and
T = 4 L, x / B / C strided views into one projection (as the model passes
them), dt * A < 0; a dyadic cell with dt * A > 0 on some heads (every
cumsum exact); and, for the plain gradient, a chunk whose cumsum spans
hundreds (a Mamba layer's real dt and A = -e), where exp above the
diagonal overflows.  The JAX comparison keeps each chunk's span below 88:
the reference takes exp of the whole [L, L] difference before masking it,
so past that its own gradient is NaN.  Tolerance: 2e-5 of max(1, max |g|)
per gradient (float32 sums in other orders; ddt and dA sum terms that
cancel, so never element by element); in the wide-span cell, where
float32's roundings of the cumsum alone exceed that in dA, the float64
formula within it of the recurrence and the float32 error at most twice
autograd's.
"""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.models import ssm as r_ssm
from repro_torch.kernels import ops, ref
from repro_torch.kernels import ssd_chunk as ssd_mod
from repro_torch.models import ssm

NAMES = ("dx", "ddt", "dA", "dB", "dC")


@pytest.fixture(autouse=True)
def one_thread():
    """Thousands of small float64 steps: one intra-op thread a test process
    keeps parallel test workers from thrashing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
GRID = [(L, N, H, m) for L in (1, 16, 64, 256) for N in (16, 128)
        for H in (1, 3, 8) for m in (1, 4)]
P = 8
POSITIVE_A = (0.125, -1.0, 0.0625, -2.0, -0.5, 0.125, -1.5, -0.75)


def near(got, want, what):
    want = np.asarray(want, np.float64)
    t = 2e-5 * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(np.asarray(got, np.float64), want, rtol=0,
                               atol=t, err_msg=what)


def inputs(B, T, H, N, seed, kind="neg"):
    """numpy x [B, T, H, P], dt [B, T, H], A [H], B / C [B, T, N] and the
    cotangents dy, dS (chunk 1 S is per position), dcd.  kind: "neg"
    (dt in [0.01, 0.1], A in -[0.5, 1.5]: spans below 88 at L = 256),
    "dyadic" (dt a multiple of 1/32, A with positive heads) or "wide" (dt
    up to 2, A = -e)."""
    rng = np.random.default_rng(seed)
    f = np.float32
    x = rng.normal(size=(B, T, H, P)).astype(f)
    Bm = rng.normal(size=(B, T, N)).astype(f)
    Cm = rng.normal(size=(B, T, N)).astype(f)
    if kind == "neg":
        dt = rng.uniform(0.01, 0.1, size=(B, T, H)).astype(f)
        A = (-rng.uniform(0.5, 1.5, size=(H,))).astype(f)
    elif kind == "dyadic":
        dt = (rng.integers(1, 9, size=(B, T, H)) / 32).astype(f)
        A = np.resize(np.array(POSITIVE_A, f), H)
    else:
        dt = np.minimum(rng.exponential(0.8, size=(B, T, H)), 2.0).astype(f)
        A = np.full((H,), -math.e, f)
    return x, dt, A, Bm, Cm


def cotangents(B, T, H, N, L, seed):
    rng = np.random.default_rng(seed + 1000)
    f = np.float32
    return (rng.normal(size=(B, T, H, P)).astype(f),
            rng.normal(size=(B, T // L, H, N, P)).astype(f),
            rng.normal(size=(B, T, H)).astype(f))


def strided(x, Bm, Cm):
    """x, B and C as views into one [B, T, H P + 2 N] projection."""
    Bsz, T, H, Pd = x.shape
    N = Bm.shape[-1]
    xBC = torch.cat([torch.tensor(x).reshape(Bsz, T, H * Pd),
                     torch.tensor(Bm), torch.tensor(Cm)], dim=-1)
    return (xBC[..., :H * Pd].unflatten(-1, (H, Pd)),
            xBC[..., H * Pd:H * Pd + N], xBC[..., H * Pd + N:])


def recurrence64(x, dt, A, Bm, Cm, L):
    """(y, S, cd) of the intra-chunk step by its per-chunk recurrence, in
    float64: every chunk's state walks its L positions in order, all chunks
    at once."""
    Bsz, T, H, Pd = x.shape
    N = Bm.shape[-1]
    nc = T // L
    xc = x.reshape(Bsz, nc, L, H, Pd)
    dtc = dt.reshape(Bsz, nc, L, H)
    Bc, Cc = Bm.reshape(Bsz, nc, L, N), Cm.reshape(Bsz, nc, L, N)
    h = torch.zeros(Bsz, nc, H, N, Pd, dtype=torch.float64)
    ys = []
    for t in range(L):
        a = torch.exp(dtc[:, :, t] * A)                           # [B, nc, H]
        h = a[..., None, None] * h + torch.einsum(
            "bch,bcn,bchp->bchnp", dtc[:, :, t], Bc[:, :, t], xc[:, :, t])
        ys.append(torch.einsum("bcn,bchnp->bchp", Cc[:, :, t], h))
    cums = torch.cumsum(dtc * A, dim=2)
    return (torch.stack(ys, 2).reshape(Bsz, T, H, Pd), h,
            torch.exp(cums).reshape(Bsz, T, H))


def vjp_torch(fn, args, cot):
    """Gradients of sum(out * cot) over the five inputs."""
    ins = [a.detach().requires_grad_(True) for a in args]
    outs = fn(*ins)
    return torch.autograd.grad(outs, ins, cot)


def check_plain(L, N, H, m, kind, seed):
    T = m * L
    x, dt, A, Bm, Cm = inputs(1 if L == 256 else 2, T, H, N, seed, kind)
    Bsz = x.shape[0]
    dy, dS, dcd = (torch.tensor(c) for c in cotangents(Bsz, T, H, N, L,
                                                        seed))
    xs, Bs, Cs = strided(x, Bm, Cm)
    args = (xs, torch.tensor(dt), torch.tensor(A), Bs, Cs)
    got = ref.ssd_intra_chunk_bwd(*args, dy, dS, dcd, chunk=L)
    want_t = vjp_torch(lambda *a: ref.ssd_intra_chunk(*a, chunk=L), args,
                       (dy, dS, dcd))
    args64 = [torch.tensor(a, dtype=torch.float64)
              for a in (x, dt, A, Bm, Cm)]
    want_64 = vjp_torch(lambda *a: recurrence64(*a, L), args64,
                        (dy.double(), dS.double(), dcd.double()))
    if kind != "wide":
        for name, g, wt, w64 in zip(NAMES, got, want_t, want_64):
            assert g.dtype == torch.float32 and g.shape == wt.shape, name
            near(g.numpy(), wt.numpy(), f"{name} vs torch autograd")
            near(g.numpy(), w64.numpy(), f"{name} vs the float64 recurrence")
        return
    # spans of hundreds: float32's own roundings of the cumsum reach dA
    # beyond 2e-5 in either float32 version, so the formula is held to the
    # recurrence in float64, and its float32 error against it to twice
    # that of autograd of the plain forward (the rule B10's backward meets
    # on the card on jamba's real inputs)
    got64 = ref.ssd_intra_chunk_bwd(*args64, dy.double(), dS.double(),
                                    dcd.double(), chunk=L,
                                    dtype=torch.float64)
    for name, g, g64, wt, w64 in zip(NAMES, got, got64, want_t, want_64):
        assert bool(torch.isfinite(g).all()) and bool(
            torch.isfinite(wt).all()), name
        near(g64.numpy(), w64.numpy(), f"{name} (float64) vs the recurrence")
        err = float((g.double() - w64).abs().max())
        err_t = float((wt.double() - w64).abs().max())
        assert err <= 2 * err_t, (name, err, err_t)


@pytest.mark.parametrize("L,N,H,m", GRID)
def test_plain_backward_matches_autograd_and_float64(L, N, H, m):
    check_plain(L, N, H, m, "neg", L + N + H + m)


@pytest.mark.parametrize("L,H", [(16, 8), (64, 3)])
def test_plain_backward_dyadic_positive_a(L, H):
    check_plain(L, 16, H, 4, "dyadic", 7 * L + H)


@pytest.mark.parametrize("L", [64, 256])
def test_plain_backward_wide_span(L):
    """A chunk's cumsum spans hundreds: exp above the diagonal overflows,
    and neither the plain gradient nor autograd of the plain forward may
    turn it into NaN."""
    x, dt, A, *_ = inputs(1, L, 3, 16, L, "wide")
    cums = np.cumsum(dt[0] * A, axis=0)
    assert float((cums[0] - cums[-1]).min()) > 88
    check_plain(L, 16, 3, 1, "wide", L)


def test_absent_cotangents_count_as_zero():
    x, dt, A, Bm, Cm = (torch.tensor(a) for a in inputs(2, 32, 3, 16, 5))
    dy, dS, dcd = (torch.tensor(c) for c in cotangents(2, 32, 3, 16, 16, 5))
    args = (x, dt, A, Bm, Cm)
    for cot in ((dy, None, None), (None, dS, None), (None, None, dcd)):
        got = ref.ssd_intra_chunk_bwd(*args, *cot, chunk=16)
        full = [torch.zeros_like(t) if c is None else c
                for c, t in zip(cot, (dy, dS, dcd))]
        want = ref.ssd_intra_chunk_bwd(*args, *full, chunk=16)
        for g, w in zip(got, want):
            assert torch.equal(g, w)


# ---------------------------------------------------------------------------
# The port's ssd_chunked through SsdIntraChunk against jax.vjp
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_branch(monkeypatch):
    """``ops.ssd_intra_chunk`` takes its CUDA branch on CPU tensors, the
    kernel wrappers replaced by their plain versions; returns the calls."""
    calls = []

    def fwd(x, dt, A, Bm, Cm, *, chunk):
        calls.append("fwd")
        return ref.ssd_intra_chunk(x, dt, A, Bm, Cm, chunk=chunk)

    def bwd(x, dt, A, Bm, Cm, dy, dS, dcd, *, chunk):
        calls.append("bwd")
        return ref.ssd_intra_chunk_bwd(x, dt, A, Bm, Cm, dy, dS, dcd,
                                       chunk=chunk)

    monkeypatch.setattr(ssd_mod, "ssd_chunk_cuda", fwd)
    monkeypatch.setattr(ssd_mod, "ssd_chunk_bwd_cuda", bwd)
    monkeypatch.setattr(ops, "_on_cpu", lambda t: False)
    return calls


@pytest.mark.parametrize("L,N,H,m", [c for c in GRID if c[0] < 256]
                         + [(256, 16, 3, 1), (256, 128, 1, 1)])
def test_ssd_chunked_grads_match_jax(cuda_branch, L, N, H, m):
    T = m * L
    seed = 3 * L + N + H + m
    x, dt, A, Bm, Cm = inputs(2, T, H, N, seed)
    rng = np.random.default_rng(seed + 1)
    h0 = rng.normal(size=(2, H, N, P)).astype(np.float32)
    dy = rng.normal(size=(2, T, H, P)).astype(np.float32)
    dh = rng.normal(size=(2, H, N, P)).astype(np.float32)
    want = jax.jit(lambda a, c: jax.vjp(
        lambda *p: r_ssm.ssd_chunked(*p[:5], L, h0=p[5]), *a)[1](c))(
        tuple(jnp.asarray(a) for a in (x, dt, A, Bm, Cm, h0)),
        (jnp.asarray(dy), jnp.asarray(dh)))
    xs, Bs, Cs = strided(x, Bm, Cm)
    ins = [t.detach().requires_grad_(True) for t in
           (xs, torch.tensor(dt), torch.tensor(A), Bs, Cs,
            torch.tensor(h0))]
    y, hT = ssm.ssd_chunked(*ins[:5], L, h0=ins[5])
    got = torch.autograd.grad((y, hT), ins, (torch.tensor(dy),
                                             torch.tensor(dh)))
    assert cuda_branch == ["fwd", "bwd"]
    for name, g, w in zip(("dx", "ddt", "dA", "dB", "dC", "dh0"), got,
                          want):
        assert g.shape == w.shape, name
        near(g.numpy(), np.asarray(w), f"{name} vs jax.vjp")


def test_cuda_branch_without_grad_launches_the_forward_alone(cuda_branch):
    x, dt, A, Bm, Cm = (torch.tensor(a) for a in inputs(1, 32, 3, 16, 9))
    with torch.no_grad():
        y, S, cd = ops.ssd_intra_chunk(x, dt, A, Bm, Cm, chunk=16)
    assert cuda_branch == ["fwd"] and not y.requires_grad


# ---------------------------------------------------------------------------
# The backward kernel's launch split (chosen by the wrapper on the host)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cells,N,H,sms,want", [
    (16, 16, 128, 132, 16),  # jamba's layer 0: 8 heads a block, 256 blocks
    (128, 128, 24, 132, 1),  # mamba2-130m's microbatch fills the card
    (2, 128, 9, 132, 9),     # a head a block
    (4, 18, 25, 132, 25),
    (66, 128, 24, 132, 1),   # half the SMs: no split
    (40, 50, 24, 132, 6),    # 4 heads a block
    (8, 32, 24, 132, 24),    # 32-column N tiles
    (20, 64, 24, 132, 12),   # 64-column N tiles, 2 heads a block
    (33, 200, 24, 132, 1),   # two 128-column N tiles a cell fill half
    (32, 200, 24, 132, 5)])  # ... just short of it
def test_bwd_s_splits(cells, N, H, sms, want):
    """Blocks that split dB's S term: a whole number of heads each, every
    head in exactly one block."""
    kbs = ssd_mod.bwd_s_splits(cells, N, H, sms)
    assert kbs == want
    per = -(-H // kbs)
    assert (kbs - 1) * per < H <= kbs * per
