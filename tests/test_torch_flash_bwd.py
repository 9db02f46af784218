"""B9's backward: the plain version ``repro_torch.kernels.ref.
flash_attention_bwd`` against torch autograd of the plain forward
(``ref.flash_attention``) and against ``jax.vjp`` of the JAX package's
plain attention (``repro.kernels.ref.flash_attention``), and the autograd
route of ``ops.flash_attention`` on the CPU.

Cells: causal and full, G in {1, 4}, hd in {16, 128}, Tq = Tk, Tq < Tk
and Tq > Tk (end-aligned: with causal masking the first Tq - Tk rows see
no key and average v over every key).  Inputs are float32 from a seed;
lse is the forward's m + log(l) (``ref.flash_block``).  Tolerance: 2e-5
of max(1, max |g|) per gradient (float32 sums in other orders).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.kernels import ref as r_ref
from repro_torch.kernels import flash_attention as flash_mod
from repro_torch.kernels import ops, ref

CELLS = [(causal, G, hd, Tq, Tk)
         for causal in (True, False) for G in (1, 4) for hd in (16, 128)
         for Tq, Tk in ((32, 32), (20, 32), (40, 24))]


def inputs(G, hd, Tq, Tk, seed=0, B=2, KV=2):
    rng = np.random.default_rng(seed + 7 * hd + Tq)
    q = rng.normal(size=(B, Tq, KV * G, hd)).astype(np.float32)
    k = rng.normal(size=(B, Tk, KV, hd)).astype(np.float32)
    v = rng.normal(size=(B, Tk, KV, hd)).astype(np.float32)
    do = rng.normal(size=(B, Tq, KV * G, hd)).astype(np.float32)
    return q, k, v, do


def lse_of(q, k, v, causal):
    _o, m, l = ref.flash_block(q, k, v, causal=causal)
    return m + torch.log(l)


def near(got, want, what):
    want = np.asarray(want, np.float32)
    t = 2e-5 * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=0,
                               atol=t, err_msg=what)


@pytest.mark.parametrize("causal,G,hd,Tq,Tk", CELLS)
def test_plain_backward_matches_autograd_and_jax(causal, G, hd, Tq, Tk):
    q, k, v, do = inputs(G, hd, Tq, Tk)
    qt, kt, vt = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    o = ref.flash_attention(qt, kt, vt, causal=causal)
    want_t = torch.autograd.grad(o, (qt, kt, vt), torch.tensor(do))
    _, vjp = jax.vjp(lambda a, b, c: r_ref.flash_attention(
        a, b, c, causal=causal), *(jnp.asarray(a) for a in (q, k, v)))
    want_j = vjp(jnp.asarray(do))
    got = ref.flash_attention_bwd(
        *(torch.tensor(a) for a in (q, k, v)), o.detach(),
        lse_of(*(torch.tensor(a) for a in (q, k, v)), causal),
        torch.tensor(do), causal=causal)
    for name, g, wt, wj in zip("qkv", got, want_t, want_j):
        assert g.dtype == torch.float32 and g.shape == wt.shape
        near(g.numpy(), wt.numpy(), f"d{name} vs torch")
        near(g.numpy(), np.asarray(wj), f"d{name} vs jax")


def test_rows_without_keys_average_v():
    """Causal Tq > Tk: the first Tq - Tk rows see no key; their output is
    the mean of v, their dv share is dO / Tk and they pass no gradient to
    q or k."""
    q, k, v, do = (torch.tensor(a) for a in inputs(2, 16, 12, 4))
    o = ref.flash_attention(q, k, v, causal=True)
    torch.testing.assert_close(o[:, :8], v.mean(1, keepdim=True)
                               .repeat_interleave(2, dim=2)
                               .expand(-1, 8, -1, -1))
    do_none = do.clone()
    do_none[:, 8:] = 0
    dq, dk, dv = ref.flash_attention_bwd(q, k, v, o, lse_of(q, k, v, True),
                                         do_none, causal=True)
    assert float(dq.abs().max()) == 0.0 and float(dk.abs().max()) == 0.0
    want = do_none.reshape(2, 12, 2, 2, 16).sum((1, 3)) / 4
    torch.testing.assert_close(dv, want[:, None].expand(-1, 4, -1, -1))


def test_cpu_route_differentiates_the_plain_version():
    q, k, v, do = (torch.tensor(a, requires_grad=True)
                   for a in inputs(4, 16, 20, 32))
    got = torch.autograd.grad(ops.flash_attention(q, k, v, causal=True),
                              (q, k, v), do.detach())
    want = torch.autograd.grad(ref.flash_attention(q, k, v, causal=True),
                               (q, k, v), do.detach())
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_cuda_route_goes_through_the_kernel_pair(monkeypatch):
    """The CUDA branch of ``ops.flash_attention`` (taken here on CPU
    tensors with the kernel wrappers replaced by their plain versions):
    with a gradient it launches the forward with ``lse`` and the backward
    kernel, and its gradients are those of the plain attention; without
    one it launches the forward alone."""
    calls = []

    def fwd(q, k, v, *, causal, with_lse=False):
        calls.append(("fwd", with_lse))
        o = ref.flash_attention(q, k, v, causal=causal)
        return (o, lse_of(q, k, v, causal)) if with_lse else o

    def bwd(q, k, v, o, lse, do, *, causal):
        calls.append(("bwd", causal))
        return tuple(g.to(q.dtype) for g in ref.flash_attention_bwd(
            q, k, v, o, lse, do, causal=causal))

    monkeypatch.setattr(flash_mod, "flash_attention_cuda", fwd)
    monkeypatch.setattr(flash_mod, "flash_attention_bwd_cuda", bwd)
    monkeypatch.setattr(ops, "_on_cpu", lambda t: False)
    q, k, v, do = (torch.tensor(a, requires_grad=True)
                   for a in inputs(4, 16, 32, 32))
    got = torch.autograd.grad(ops.flash_attention(q, k, v, causal=True),
                              (q, k, v), do.detach())
    assert calls == [("fwd", True), ("bwd", True)]
    want = torch.autograd.grad(ref.flash_attention(q, k, v, causal=True),
                               (q, k, v), do.detach())
    for g, w in zip(got, want):
        near(g.numpy(), w.numpy(), "route")
    calls.clear()
    with torch.no_grad():
        ops.flash_attention(q, k, v, causal=False)
    ops.flash_attention(q.detach(), k.detach(), v.detach(), causal=False)
    assert calls == [("fwd", False), ("fwd", False)]
