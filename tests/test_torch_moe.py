"""The port's mixture-of-experts layer (``repro_torch/models/moe.py``) held
against the JAX package's ``repro.models.moe`` on the CPU.

Inputs are made from a seed with numpy; the JAX parameters
(``repro.models.common.init_tree`` over ``moe_defs``) are carried across
as numpy arrays, so both packages compute the same function.  Routing is
held index-exact: the top-k experts (the lower index first among equal
probabilities, forced here by two equal router columns), each choice's
slot and whether it is kept.  Tolerances, of max(1, max |want|):

  * float32: 1e-5 for the output and the aux loss (the same float32
    products in another order);
  * bfloat16: 2e-2 for the output (the two frameworks round bf16 at other
    places), 1e-5 for the aux loss, which both form in float32 from the
    same bf16 inputs.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.models import common as r_common
from repro.models import lm as r_lm
from repro.models import moe as r_moe
from repro.models.config import ModelConfig as RConfig
from repro_torch.configs import get_config
from repro_torch.models import common, lm, moe
from repro_torch.models.config import ModelConfig

BASE = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
            vocab_size=64)
CASES = {
    "top2": dict(moe_experts=4, moe_top_k=2),
    "top1_shared": dict(moe_experts=4, moe_top_k=1, moe_shared=True),
    # C = round(0.5 * 32 * 2 / 4) = 8 slots for 64 choices: some drop
    "drops": dict(moe_experts=4, moe_top_k=2, capacity_factor=0.5),
    "drops_top1_shared": dict(moe_experts=8, moe_top_k=1, moe_shared=True,
                              capacity_factor=0.5),
}
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def configs(dtype="f32", **kw):
    jd, td = DTYPES[dtype]
    base = dict(BASE, **kw)
    return RConfig(dtype=jd, **base), ModelConfig(dtype=td, **base)


def moe_params(rc, tc, seed=0, tie=None):
    """The JAX MoE parameters of ``rc`` and the port's copy.  ``tie``:
    (a, b) router columns made equal, so every token ties on them."""
    rp = r_common.init_tree(r_moe.moe_defs(rc), jax.random.PRNGKey(seed),
                            rc.dtype)
    if tie is not None:
        a, b = tie
        rp["router"] = rp["router"].at[:, b].set(rp["router"][:, a])
    tree = jax.tree.map(lambda a: np.asarray(a.astype(jnp.float32)), rp)
    return rp, common.tree_from_numpy(moe.moe_defs(tc), tree, tc.dtype)


def inputs(B=2, T=16, d=64, seed=1):
    return np.random.default_rng(seed).normal(size=(B, T, d)).astype(
        np.float32)


def near(got, want, rel):
    want = np.asarray(want, np.float32)
    t = rel * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=t,
                               atol=t)


def reference_routing(rc, rp, x):
    """The reference's routing steps (``moe.py:48-64``) on the same input:
    (gate_idx [n, k], slot [n * k], keep [n * k], C)."""
    xt = jnp.asarray(x, rc.dtype).reshape(-1, rc.d_model)
    logits = xt.astype(jnp.float32) @ rp["router"].astype(jnp.float32)
    probs = jax.nn.softmax(logits, axis=-1)
    _vals, gate_idx = jax.lax.top_k(probs, rc.moe_top_k)
    n = xt.shape[0]
    C = int(max(1, round(rc.capacity_factor * n * rc.moe_top_k
                         / rc.moe_experts)))
    eidx = gate_idx.reshape(-1)
    onehot = jax.nn.one_hot(eidx, rc.moe_experts, dtype=jnp.int32)
    ranks = jnp.cumsum(onehot, axis=0) - onehot
    slot = jnp.take_along_axis(ranks, eidx[:, None], axis=-1)[:, 0]
    return (np.asarray(gate_idx), np.asarray(slot), np.asarray(slot < C), C)


def port_routing(tc, tp, x):
    xt = torch.tensor(x).to(tc.dtype).reshape(-1, tc.d_model)
    _probs, _vals, gate_idx = moe.route(tc, tp["router"], xt)
    flat_idx, keep, _counts, C = moe.dispatch(tc, gate_idx)
    return gate_idx.numpy(), flat_idx.numpy(), keep.numpy(), C


def check_routing(tc, tp, rc, rp, x):
    """Index-exact routing; returns the number of dropped choices."""
    g_idx, flat_idx, keep, C = port_routing(tc, tp, x)
    w_idx, w_slot, w_keep, w_C = reference_routing(rc, rp, x)
    assert C == w_C
    np.testing.assert_array_equal(g_idx, w_idx)
    np.testing.assert_array_equal(keep, w_keep)
    eidx = w_idx.reshape(-1)
    want_flat = np.where(w_keep, eidx * C + np.minimum(w_slot, C - 1),
                         tc.moe_experts * C)
    np.testing.assert_array_equal(flat_idx, want_flat)
    return int((~keep).sum())


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_apply_moe_matches_jax(case, dtype):
    rc, tc = configs(dtype, **CASES[case])
    rp, tp = moe_params(rc, tc)
    x = inputs()
    dropped = check_routing(tc, tp, rc, rp, x)
    if case.startswith("drops"):
        assert dropped > 0
    out, aux = moe.apply_moe(tc, tp, torch.tensor(x).to(tc.dtype))
    w_out, w_aux = r_moe.apply_moe(rc, rp, jnp.asarray(x, rc.dtype))
    assert out.dtype == tc.dtype and out.shape == x.shape
    assert aux.dtype == torch.float32
    near(out.float().numpy(), np.asarray(w_out.astype(jnp.float32)),
         1e-5 if dtype == "f32" else 2e-2)
    near(float(aux), float(w_aux), 1e-5)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("k", [1, 2])
def test_router_tie_takes_the_lower_expert(dtype, k):
    """Router columns 1 and 2 equal: every token's probabilities tie on
    them, and jax.lax.top_k takes expert 1 before expert 2; so does the
    port, choice for choice and slot for slot."""
    rc, tc = configs(dtype, moe_experts=4, moe_top_k=k)
    rp, tp = moe_params(rc, tc, tie=(1, 2))
    x = inputs(seed=3)
    xt = torch.tensor(x).to(tc.dtype).reshape(-1, 64)
    probs, _vals, idx = moe.route(tc, tp["router"], xt)
    assert torch.equal(probs[:, 1], probs[:, 2])
    check_routing(tc, tp, rc, rp, x)
    both = (idx == 1).any(-1) & (idx == 2).any(-1)
    one = (idx == 1).any(-1) ^ (idx == 2).any(-1)
    # where only one of the tied pair made the top k, it is expert 1
    assert bool((idx[one] != 2).all())
    if k == 2:
        assert int(both.sum()) > 0
    assert int(one.sum()) > 0
    out, aux = moe.apply_moe(tc, tp, torch.tensor(x).to(tc.dtype))
    w_out, w_aux = r_moe.apply_moe(rc, rp, jnp.asarray(x, rc.dtype))
    near(out.float().numpy(), np.asarray(w_out.astype(jnp.float32)),
         1e-5 if dtype == "f32" else 2e-2)
    near(float(aux), float(w_aux), 1e-5)


def test_moe_routing_mass_conservation():
    """Counterpart of tests/test_models.py:102: with generous capacity,
    nothing drops, the gates of each token sum to 1, and the Switch aux
    loss is at least its balanced value 1 (up to rounding)."""
    rc, tc = configs(moe_experts=4, moe_top_k=2, capacity_factor=8.0)
    rp = r_lm.init_params(rc, jax.random.PRNGKey(0))
    tree = jax.tree.map(lambda a: np.asarray(a.astype(jnp.float32)), rp)
    tp = lm.params_from_numpy(tc, tree)
    p0 = {k: v[0] for k, v in tp["layers"]["pos0"]["moe"].items()}
    x = np.random.default_rng(1).normal(size=(2, 8, 64)).astype(np.float32)
    out, aux = moe.apply_moe(tc, p0, torch.tensor(x))
    assert out.shape == x.shape and bool(torch.isfinite(out).all())
    assert float(aux) >= 0.99
    _probs, vals, idx = moe.route(tc, p0["router"], torch.tensor(x).view(-1, 64))
    _flat, keep, _counts, _C = moe.dispatch(tc, idx)
    assert bool(keep.all())
    torch.testing.assert_close(vals.sum(-1), torch.ones(16))
    r_p0 = jax.tree.map(lambda a: a[0], rp["layers"]["pos0"]["moe"])
    w_out, w_aux = r_moe.apply_moe(rc, r_p0, jnp.asarray(x))
    near(out.numpy(), np.asarray(w_out), 1e-5)
    near(float(aux), float(w_aux), 1e-5)


@pytest.mark.parametrize("cf,n,k,E", [
    (1.25, 4, 2, 16),       # jamba decoding at batch 4: round(0.625) = 1
    (1.25, 4, 1, 16),       # llama4-scout at batch 4: max(1, round(0.3125))
    (1.25, 32768, 2, 16),   # jamba's prefill_32k row: 5,120
    (1.25, 16, 1, 8),       # a half: round(2.5) = 2
    (1.0, 6, 1, 4),         # a half: round(1.5) = 2
    (0.01, 3, 1, 128),      # below one slot: 1
])
def test_capacity_is_the_reference_expression(cf, n, k, E):
    _, tc = configs(moe_experts=E, moe_top_k=k, capacity_factor=cf)
    assert moe.capacity(tc, n) == int(max(1, round(cf * n * k / E)))


def test_decode_capacity_drops_colliding_choices():
    """At decode n = B: jamba's configured capacity gives one slot per
    expert at batch 4, so a second choice of the same expert drops (the
    reference's behaviour, ROADMAP.md C.3); raising capacity_factor keeps
    every choice."""
    cfg = get_config("jamba_v0_1_52b")
    assert moe.capacity(cfg, 4) == 1
    assert moe.capacity(get_config("llama4_scout_17b_a16e"), 4) == 1
    assert moe.capacity(cfg, 32768) == 5120
    _, tc = configs(moe_experts=4, moe_top_k=2)
    idx = torch.tensor([[0, 1], [0, 2], [3, 0], [1, 2]])
    flat, keep, counts, C = moe.dispatch(tc, idx)
    assert C == 2 and counts.tolist() == [3, 2, 2, 1]
    # expert 0's third choice (token 2) is past the 2 slots
    assert keep.tolist() == [True, True, True, True, True, False, True, True]
    assert flat.tolist() == [0, 2, 1, 4, 6, 8, 3, 5]
    big = dataclasses.replace(tc, capacity_factor=4.0)
    assert bool(moe.dispatch(big, idx)[1].all())


def test_moe_defs_match_reference():
    for shared in (False, True):
        rc, tc = configs(moe_experts=4, moe_top_k=1, moe_shared=shared)
        want = r_moe.moe_defs(rc)
        got = moe.moe_defs(tc)
        flat_w = jax.tree.leaves(want, is_leaf=lambda a: isinstance(
            a, r_common.ParamDef))
        flat_g = [d for _p, d in common.tree_leaves(got)]
        assert [(d.shape, d.spec, d.init, d.scale) for d in flat_g] == [
            (d.shape, d.spec, d.init, d.scale) for d in flat_w]
