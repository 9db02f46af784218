"""The port's optimizer and gradient codecs (``repro_torch/optim``) held
against the JAX package's (``repro/optim``) on the CPU.

Trees are numpy arrays from a seed, handed to both.  Tolerances: the
schedule and AdamW to 1e-6 (float32, the same operations in the same
order; XLA may contract a multiply-add), the int8 codes and scales
exactly.  The bf16 stochastic rounding draws from a ``torch.Generator``
where the reference draws from a ``jax.random`` key, so it is held to
its law instead: every value lands on one of the two bf16 neighbours of
x, and the mean of 1e5 draws is x within 3 sigma.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.optim import adamw as r_adamw
from repro.optim import compress as r_compress
from repro_torch.models.common import tree_leaves
from repro_torch.optim import (AdamWConfig, adamw_init, adamw_update,
                               cosine_lr)
from repro_torch.optim import adamw as t_adamw
from repro_torch.optim import compress


def tree(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return {"embed": (rng.normal(size=(7, 5)) * scale).astype(np.float32),
            "layers": {"w": (rng.normal(size=(3, 5, 4)) * scale).astype(
                           np.float32),
                       "b": (rng.normal(size=(4,)) * scale).astype(
                           np.float32)},
            "norm": (rng.normal(size=(5,)) * scale).astype(np.float32)}


def to_torch(t):
    return {k: to_torch(v) if isinstance(v, dict) else torch.tensor(v)
            for k, v in t.items()}


@pytest.mark.parametrize("warmup,total", [(100, 10_000), (3, 20), (1, 5),
                                          (0, 1)])
def test_cosine_lr_every_step(warmup, total):
    cfg = AdamWConfig(warmup_steps=warmup, total_steps=total)
    rcfg = r_adamw.AdamWConfig(warmup_steps=warmup, total_steps=total)
    stride = max(1, total // 200)
    for step in list(range(0, total + 3, stride)) + [total - 1, total]:
        want = float(r_adamw.cosine_lr(rcfg, jnp.asarray(step, jnp.int32)))
        np.testing.assert_allclose(cosine_lr(cfg, step), want, rtol=1e-6,
                                   err_msg=str(step))
        assert cosine_lr(cfg, torch.tensor(step, dtype=torch.int32)) == \
            cosine_lr(cfg, step)


@pytest.mark.parametrize("grad_scale", [1e-2, 10.0],
                         ids=["unclipped", "clipped"])
def test_adamw_update_three_steps(grad_scale):
    """Three steps on a random tree: parameters, moments, count and the
    global norm against the reference; clip_norm 1 clips the larger
    gradients and leaves the smaller ones."""
    cfg = AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=10)
    rcfg = r_adamw.AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=10)
    p_np = tree(0)
    rp = jax.tree.map(jnp.asarray, p_np)
    ropt = r_adamw.adamw_init(rp)
    tp = to_torch(p_np)
    opt = adamw_init(tp)
    for s in range(3):
        g_np = tree(10 + s, grad_scale)
        rp, ropt, rnorm = jax.jit(
            lambda p, o, g: r_adamw.adamw_update(rcfg, g, o, p))(
                rp, ropt, jax.tree.map(jnp.asarray, g_np))
        tp2, opt, norm = adamw_update(cfg, to_torch(g_np), opt, tp)
        assert tp2 is tp
        np.testing.assert_allclose(float(norm), float(rnorm), rtol=1e-6)
        assert (float(norm) > 1.0) == (grad_scale > 1.0)
        assert int(opt["count"]) == int(ropt["count"]) == s + 1
        for name, got, want in (("p", tp, rp), ("m", opt["m"], ropt["m"]),
                                ("v", opt["v"], ropt["v"])):
            w = dict(tree_leaves(jax.tree.map(np.asarray, want)))
            for path, t in tree_leaves(got):
                np.testing.assert_allclose(t.numpy(), w[path], rtol=1e-6,
                                           atol=1e-7,
                                           err_msg=f"{name} {path} {s}")


def test_adamw_slices_large_leaves(monkeypatch):
    """A leaf above SLICE_ELEMENTS is updated in runs of rows with
    the same result, in the parameter's dtype."""
    p_np, g_np = tree(1), tree(2)
    cfg = AdamWConfig(lr=1e-2, warmup_steps=1, total_steps=5)
    whole = to_torch(p_np)
    adamw_update(cfg, to_torch(g_np), adamw_init(whole), whole)
    monkeypatch.setattr(t_adamw, "SLICE_ELEMENTS", 4)
    sliced = to_torch(p_np)
    adamw_update(cfg, to_torch(g_np), adamw_init(sliced), sliced)
    for (path, a), (_, b) in zip(tree_leaves(whole), tree_leaves(sliced)):
        assert torch.equal(a, b), path
    bf = {"w": torch.tensor(p_np["embed"]).to(torch.bfloat16)}
    adamw_update(cfg, {"w": torch.tensor(g_np["embed"])}, adamw_init(bf), bf)
    assert bf["w"].dtype == torch.bfloat16


def test_int8_codes_and_scales_equal_reference():
    """Codes and scales equal the reference's, block for block (a leaf
    that does not fill its last 256-block, an all-zero leaf), and the
    round trip to within half a code step."""
    rng = np.random.default_rng(3)
    t_np = {"a": (rng.normal(size=(3, 300)) * 5).astype(np.float32),
            "b": {"c": rng.normal(size=(256,)).astype(np.float32),
                  "z": np.zeros((7,), np.float32)}}
    want = r_compress.compress_int8(jax.tree.map(jnp.asarray, t_np))
    got = compress.compress_int8(to_torch(t_np))
    for key in (("a",), ("b", "c"), ("b", "z")):
        w, g = want, got
        for k in key:
            w, g = w[k], g[k]
        np.testing.assert_array_equal(g["codes"].numpy(),
                                      np.asarray(w["codes"]))
        np.testing.assert_array_equal(g["scale"].numpy(),
                                      np.asarray(w["scale"]))
        assert g["codes"].dtype == torch.int8
        assert g["shape"] == tuple(w["shape"])
    back = compress.decompress_int8(got)
    rback = r_compress.decompress_int8(want)
    for path, t in tree_leaves(back):
        w = dict(tree_leaves(jax.tree.map(np.asarray, rback)))[path]
        np.testing.assert_array_equal(t.numpy(), w)
        orig = dict(tree_leaves(t_np))[path]
        step = np.abs(orig).max() / 127.0
        assert np.abs(t.numpy() - orig).max() <= 0.5 * step + 1e-7


def test_bf16_cast_without_generator_equals_reference():
    t_np = tree(4)
    want = r_compress.compress_bf16(jax.tree.map(jnp.asarray, t_np))
    got = compress.compress_bf16(to_torch(t_np))
    w = dict(tree_leaves(jax.tree.map(
        lambda a: np.asarray(a.astype(jnp.float32)), want)))
    for path, t in tree_leaves(got):
        assert t.dtype == torch.bfloat16
        np.testing.assert_array_equal(t.float().numpy(), w[path])


def test_bf16_stochastic_rounding_is_unbiased():
    """1e5 draws of each value land on its two bf16 neighbours (towards
    zero and the next one away), and their mean is the value within 3
    sigma of the two-point law; exact bf16 values, zero and NaN stay."""
    xs = torch.tensor([1.0 + 2.0 ** -10, -3.14159, 1e-3 + 1e-7, 7.5e4,
                       -2.0 ** -20 * 1.3], dtype=torch.float32)
    n = 100_000
    gen = torch.Generator().manual_seed(0)
    draws = compress.compress_bf16(
        {"x": xs[None, :].expand(n, -1).contiguous()}, gen)["x"].float()
    for j, x in enumerate(xs.tolist()):
        lo = torch.tensor(x).to(torch.bfloat16)
        bits = torch.tensor([x], dtype=torch.float32).view(torch.int32)
        down = (bits & -65536).view(torch.float32).item()   # towards zero
        up = ((bits & -65536) + 65536).view(torch.float32).item()
        vals = set(draws[:, j].unique().tolist())
        assert vals <= {down, up} and len(vals) == 2, (x, vals)
        assert float(lo) in (down, up)
        p_up = (x - down) / (up - down)
        sigma = abs(up - down) * np.sqrt(p_up * (1 - p_up) / n)
        assert abs(float(draws[:, j].double().mean()) - x) <= 3 * sigma, x
    exact = torch.tensor([0.0, 1.5, -2.0, float("nan")])
    out = compress.compress_bf16({"e": exact}, gen)["e"].float()
    assert torch.equal(out[:3], exact[:3]) and torch.isnan(out[3])
