"""The port's attention LM family (``repro_torch/models/{attention,common,
lm}.py``, the dense configs, ``launch/{steps,serve}.py``) held against the
JAX package's, on the CPU.

Inputs are made from a seed with numpy; the JAX parameters
(``repro.models.lm.init_params``, ``repro.models.common.init_tree``) are
carried across with ``lm.params_from_numpy``, so both packages compute
the same function.  The counterparts of tests/test_models.py's attention,
MoE and hybrid cases (decode == forward for ``dense``, ``qknorm_swa``,
``moe``, ``hybrid`` and ``mrope``; the blocked and banded paths against
plain sdpa) come first; its ``ssm`` case is in tests/test_torch_ssm.py.
The smoke configs of the dense, MoE (llama4-scout, llama4-maverick),
hybrid (jamba) and vision (qwen2-vl) archs are then held end to end;
the MoE layer alone is tests/test_torch_moe.py, whisper
tests/test_torch_whisper.py.  Tolerances:

  * RoPE, M-RoPE and the MLPs: 1e-6 (the same float32 ops);
  * the attention paths and ``attention()``: 1e-5 in float32, the bound
    of tests/test_models.py's path checks;
  * forward and decode logits: 1e-4 of max(1, max |logit|) in float32,
    2e-2 of it in bf16 (the two frameworks round bf16 at other places),
    as tests/test_torch_ssm.py holds the Mamba2 stack;
  * the port's decode against its own forward: 2e-2, the bound of
    tests/test_models.py:50.

On the CPU, self attention without a window runs B9's plain version
(``kernels/ref.py``); ``test_unwindowed_attention_routes_to_b9`` shows
that it is reached through ``ops.flash_attention`` at every length.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_config as r_get_config
from repro.configs import get_smoke_config as r_smoke
from repro.launch import serve as r_serve
from repro.launch import steps as r_steps
from repro.models import attention as r_attn
from repro.models import common as r_common
from repro.models import lm as r_lm
from repro.models.config import ModelConfig as RConfig
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.kernels import ops
from repro_torch.launch import serve as t_serve
from repro_torch.launch import steps
from repro_torch.models import attention, common, lm, moe, whisper
from repro_torch.models.config import ModelConfig

DENSE = ("qwen3_14b", "starcoder2_3b", "deepseek_coder_33b",
         "h2o_danube_1_8b")
# the MoE, hybrid and vision archs (ROADMAP.md A.17 items 2-3)
MIXED = ("jamba_v0_1_52b", "llama4_scout_17b_a16e",
         "llama4_maverick_400b_a17b", "qwen2_vl_72b")
TINY = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
            vocab_size=64)
# tests/test_models.py's attention-family configs
CONFIGS = {
    "dense": dict(n_layers=4),
    "qknorm_swa": dict(n_kv_heads=4, qk_norm=True, window=6),
    "mrope": dict(pos="mrope", mrope_sections=(4, 2, 2)),
    # capacity raised so that no choice drops at decode (n = B)
    "moe": dict(moe_experts=4, moe_top_k=2, capacity_factor=4.0),
    "hybrid": dict(family="hybrid", n_layers=4, layer_pattern=("M", "A"),
                   ssm_state=16, ssm_head_dim=16, ssm_chunk=4),
}


def tiny(**kw):
    """(JAX config, port config), float32, with the same fields."""
    base = dict(TINY, **kw)
    return RConfig(dtype=jnp.float32, **base), \
        ModelConfig(dtype=torch.float32, **base)


def to_numpy(tree):
    return jax.tree.map(lambda a: np.asarray(a.astype(jnp.float32)), tree)


def carry(rc, tc, seed=1):
    """JAX parameters of ``rc`` and the port's copy of them."""
    rp = r_lm.init_params(rc, jax.random.PRNGKey(seed))
    return rp, lm.params_from_numpy(tc, to_numpy(rp))


def tokens(vocab, B, T, seed=2):
    return np.random.default_rng(seed).integers(0, vocab, (B, T)).astype(
        np.int32)


def near(got, want, rel):
    want = np.asarray(want, np.float32)
    t = rel * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=t,
                               atol=t)


def qkv(seed, B=2, T=64, H=4, KV=2, hd=16):
    rng = np.random.default_rng(seed)
    return tuple(rng.normal(size=(B, T, h, hd)).astype(np.float32)
                 for h in (H, KV, KV))


# ---------------------------------------------------------------------------
# Counterparts of tests/test_models.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", list(CONFIGS))
def test_decode_matches_forward(name):
    """Token-by-token decoding through the ring-buffer caches equals the
    forward pass (the port's own), and both equal the JAX package's."""
    rc, tc = tiny(**CONFIGS[name])
    rp, tp = carry(rc, tc)
    B, T = 2, 16
    toks = tokens(tc.vocab_size, B, T)
    fwd, aux = lm.forward(tc, tp, {"tokens": torch.tensor(toks)})
    state = lm.init_decode_state(tc, B, max_len=T)
    step = steps.build_serve_step(tc)
    outs = []
    for t in range(T):
        lg, state = step(tp, state, torch.tensor(toks[:, t:t + 1]))
        outs.append(lg)
    assert state["pos"] == T
    dec = torch.cat(outs, dim=1)
    assert float((fwd - dec).abs().max()) < 2e-2, name
    want, w_aux = jax.jit(lambda p, b: r_lm.forward(rc, p, b))(
        rp, {"tokens": jnp.asarray(toks)})
    near(fwd.numpy(), want, 1e-4)
    near(dec.numpy(), want, 1e-4)
    # the MoE layers' aux loss, summed over layers as the reference sums it
    assert (float(aux) == 0.0) == (tc.moe_experts == 0)
    near(float(aux), float(w_aux), 1e-5)


@pytest.mark.parametrize("causal,window", [(True, None), (True, 16),
                                           (False, None)])
def test_blocked_attention_matches_plain(causal, window):
    q, k, v = qkv(0)
    bias = attention.causal_window_bias(64, 64, causal=causal, window=window)
    tq, tk, tv = (torch.tensor(a) for a in (q, k, v))
    want = attention.sdpa(tq, tk, tv, bias)
    out = attention.blocked_sdpa(tq, tk, tv, causal=causal, window=window,
                                 block_k=16)
    torch.testing.assert_close(out, want, rtol=1e-5, atol=1e-5)
    r_want = r_attn.sdpa(*(jnp.asarray(a) for a in (q, k, v)),
                         r_attn.causal_window_bias(64, 64, causal=causal,
                                                   window=window))
    np.testing.assert_allclose(want.numpy(), np.asarray(r_want), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_array_equal(bias.numpy(), np.asarray(
        r_attn.causal_window_bias(64, 64, causal=causal, window=window)))


def test_banded_swa_matches_plain():
    q, k, v = qkv(0)
    W = 16
    tq, tk, tv = (torch.tensor(a) for a in (q, k, v))
    want = attention.sdpa(tq, tk, tv, attention.causal_window_bias(
        64, 64, causal=True, window=W))
    out = attention.banded_sdpa(tq, tk, tv, window=W)
    torch.testing.assert_close(out, want, rtol=1e-5, atol=1e-5)
    r_out = r_attn.banded_sdpa(*(jnp.asarray(a) for a in (q, k, v)),
                               window=W)
    np.testing.assert_allclose(out.numpy(), np.asarray(r_out), rtol=1e-5,
                               atol=1e-5)


# ---------------------------------------------------------------------------
# Building blocks against the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("theta", [1e4, 1e6])
def test_rope_matches_jax(theta):
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 40, 4, 16)).astype(np.float32)
    pos = rng.integers(0, 32768, size=(2, 40)).astype(np.int32)
    np.testing.assert_array_equal(common.rope_freqs(16, theta),
                                  r_common.rope_freqs(16, theta))
    got = common.apply_rope(torch.tensor(x), torch.tensor(pos), theta)
    want = r_common.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
    # the angles are float32 products, as in the reference, of the same
    # frequencies (formed on the tensor's device)
    assert got.dtype == torch.float32
    assert torch.equal(common._freqs(16, theta, "cpu"), torch.tensor(
        common.rope_freqs(16, theta), dtype=torch.float32))


def test_mrope_matches_jax_and_degenerates_to_rope():
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 12, 4, 16)).astype(np.float32)
    pos3 = rng.integers(0, 64, size=(2, 12, 3)).astype(np.int32)
    got = common.apply_mrope(torch.tensor(x), torch.tensor(pos3), 1e4,
                             (4, 2, 2))
    want = r_common.apply_mrope(jnp.asarray(x), jnp.asarray(pos3), 1e4,
                                (4, 2, 2))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
    same = np.repeat(pos3[..., :1], 3, axis=-1)
    torch.testing.assert_close(
        common.apply_mrope(torch.tensor(x), torch.tensor(same), 1e4,
                           (4, 2, 2)),
        common.apply_rope(torch.tensor(x), torch.tensor(same[..., 0]), 1e4))
    with pytest.raises(ValueError, match="sections"):
        common.apply_mrope(torch.tensor(x), torch.tensor(pos3), 1e4,
                           (4, 2, 1))


@pytest.mark.parametrize("mlp", ["swiglu", "gelu"])
def test_mlp_matches_jax(mlp):
    rc, tc = tiny(mlp=mlp)
    defs = r_common.mlp_defs(rc)
    rp = r_common.init_tree(defs, jax.random.PRNGKey(5), jnp.float32)
    tp = {k: torch.tensor(np.asarray(a)) for k, a in rp.items()}
    assert set(tp) == set(common.mlp_defs(tc))
    x = np.random.default_rng(6).normal(size=(2, 8, 64)).astype(np.float32)
    got = common.apply_mlp(tc, tp, torch.tensor(x))
    want = r_common.apply_mlp(rc, rp, jnp.asarray(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


def test_sincos_positions_match_jax():
    np.testing.assert_array_equal(common.sincos_positions(24, 64),
                                  r_common.sincos_positions(24, 64))


ATTN_CASES = [  # (causal, window, T): the path the reference takes
    (True, None, 24),     # masked sdpa below the threshold
    (True, None, 64),     # blocked at the threshold and above
    (True, None, 37),     # ragged (see below)
    (False, None, 24),    # full (encoder) attention
    (False, None, 64),
    (True, 8, 48),        # banded: T >= 2W, T % W == 0
    (True, 6, 64),        # blocked with a window (T % W != 0)
    (True, 16, 24),       # masked sdpa with a window (T < 2W)
]


@pytest.mark.parametrize("causal,window,T", ATTN_CASES)
def test_attention_matches_jax(causal, window, T):
    """``attention()`` at T below and above ``attn_block_threshold``
    (32 here), causal, windowed and full, within 1e-5 in float32."""
    rc, tc = tiny(qk_norm=True, attn_block_threshold=32, attn_block_k=16)
    rp = r_common.init_tree(r_attn.attn_defs(rc), jax.random.PRNGKey(7),
                            jnp.float32)
    tp = {k: torch.tensor(np.asarray(a)) for k, a in rp.items()}
    x = np.random.default_rng(8).normal(size=(2, T, 64)).astype(np.float32)
    pos = np.broadcast_to(np.arange(T), (2, T)).astype(np.int32)
    got = attention.attention(tc, tp, torch.tensor(x), torch.tensor(pos),
                              causal=causal, window=window)
    if T % rc.attn_block_k and T >= rc.attn_block_threshold:
        # the reference's blocked path asserts T % block_k == 0; at a
        # ragged T it is held through its masked sdpa
        rc = dataclasses.replace(rc, attn_block_threshold=T + 1)
    want = r_attn.attention(rc, rp, jnp.asarray(x), jnp.asarray(pos),
                            causal=causal, window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("qk_norm", [False, True])
def test_cross_attention_matches_jax(qk_norm):
    """cross_kv over an encoder output and cross_attention of decoder rows
    against it (plain products, as in the reference), within 1e-5."""
    rc, tc = tiny(qk_norm=qk_norm)
    rp = r_common.init_tree(r_attn.attn_defs(rc), jax.random.PRNGKey(9),
                            jnp.float32)
    tp = {k: torch.tensor(np.asarray(a)) for k, a in rp.items()}
    rng = np.random.default_rng(10)
    mem = rng.normal(size=(2, 12, 64)).astype(np.float32)
    x = rng.normal(size=(2, 5, 64)).astype(np.float32)
    kv = attention.cross_kv(tc, tp, torch.tensor(mem))
    r_kv = r_attn.cross_kv(rc, rp, jnp.asarray(mem))
    for got, want in zip(kv, r_kv):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-5)
    got = attention.cross_attention(tc, tp, torch.tensor(x), kv)
    want = r_attn.cross_attention(rc, rp, jnp.asarray(x), r_kv)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("T", [8, 32, 64, 37])
def test_unwindowed_attention_routes_to_b9(monkeypatch, T):
    """Self attention without a window reaches ops.flash_attention (B9 on
    a CUDA tensor) once a call at every T, below and above the threshold;
    a windowed call does not."""
    calls = []
    plain = ops.flash_attention

    def counted(q, k, v, *, causal):
        calls.append((tuple(q.shape), causal))
        return plain(q, k, v, causal=causal)

    monkeypatch.setattr(ops, "flash_attention", counted)
    _, tc = tiny(attn_block_threshold=32, attn_block_k=16)
    tp = common.init_tree(attention.attn_defs(tc),
                          torch.Generator().manual_seed(0), torch.float32)
    x = torch.randn(1, T, 64, generator=torch.Generator().manual_seed(1))
    pos = torch.arange(T)[None]
    for causal in (True, False):
        attention.attention(tc, tp, x, pos, causal=causal)
    assert calls == [((1, T, 4, 16), True), ((1, T, 4, 16), False)]
    attention.attention(tc, tp, x, pos, window=4)
    assert len(calls) == 2


# ---------------------------------------------------------------------------
# The dense configs end to end
# ---------------------------------------------------------------------------

def smoke_pair(arch, dtype):
    rc, tc = r_smoke(arch), get_smoke_config(arch)
    if dtype == "f32":
        rc = dataclasses.replace(rc, dtype=jnp.float32)
        tc = dataclasses.replace(tc, dtype=torch.float32)
    return rc, tc


def rel(dtype):
    return 1e-4 if dtype == "f32" else 2e-2


# T = 32 puts h2o-danube's smoke window (16) on the banded path
SMOKE_T = 32


# bf16 MoE cells: the two frameworks round the bf16 hidden states at other
# places, so a token whose k-th and (k+1)-th router probabilities lie
# closer than that rounding may take another expert in each (a
# discontinuity, not an error: jamba's smoke config meets two such tokens
# at T = 32).  These cells run the reference eagerly on the port's expert
# choices, and hold every choice to the reference's own router: a chosen
# expert whose reference probability lies more than ROUTE_MARGIN below the
# reference's k-th largest fails, and a cell whose choices differ from the
# reference's own at more than MAX_FLIPS tokens fails.  The largest
# shortfall these cells read is 4.51e-4 (jamba's forward cell, one of its
# two flipped tokens; the other and the decode cell's one flip read
# 1.83e-4), and no cell flips more than 2 tokens.  f32 cells run the
# reference unpinned.
ROUTE_MARGIN = 2e-3
MAX_FLIPS = 2


class PinnedRouting:
    """Records the port's expert choices (``moe.route``, in call order)
    and hands them to the reference's ``jax.lax.top_k`` in the same
    order."""

    def __init__(self, monkeypatch):
        self.choices = []
        self.flips = 0
        route, top_k = moe.route, jax.lax.top_k

        def record(cfg, router, xt):
            out = route(cfg, router, xt)
            self.choices.append(out[2].numpy())
            return out

        def pinned(probs, k):
            idx = self.choices.pop(0)
            own_v, own_i = (np.asarray(a) for a in top_k(probs, k))
            vals = np.take_along_axis(np.asarray(probs), idx, axis=-1)
            short = float((own_v[:, -1:] - vals).max())
            assert short <= ROUTE_MARGIN, short
            self.flips += int((np.sort(idx, -1) != np.sort(own_i, -1))
                              .any(-1).sum())
            return jnp.asarray(vals), jnp.asarray(idx, own_i.dtype)

        monkeypatch.setattr(moe, "route", record)
        monkeypatch.setattr(jax.lax, "top_k", pinned)


def pin_routing(monkeypatch, rc, tc, dtype):
    """(reference config, PinnedRouting) for a bf16 MoE cell (the
    reference without scan or remat, compile options that leave its
    function as it is, so it runs eagerly); else (rc, None)."""
    if dtype == "f32" or not tc.moe_experts:
        return rc, None
    return (dataclasses.replace(rc, scan_layers=False, remat=False),
            PinnedRouting(monkeypatch))


@pytest.mark.parametrize("arch", DENSE + MIXED)
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_forward_and_prefill_match_jax(arch, dtype, monkeypatch):
    rc, tc = smoke_pair(arch, dtype)
    rp, tp = carry(rc, tc)
    toks = tokens(tc.vocab_size, 2, SMOKE_T)
    rc, pin = pin_routing(monkeypatch, rc, tc, dtype)
    got, _ = lm.forward(tc, tp, {"tokens": torch.tensor(toks)})
    fwd = (lambda p, b: r_lm.forward(rc, p, b)) if pin else \
        jax.jit(lambda p, b: r_lm.forward(rc, p, b))
    want = np.asarray(fwd(rp, {"tokens": jnp.asarray(toks)})[0])
    assert got.dtype == torch.float32
    near(got.numpy(), want, rel(dtype))
    pre = steps.build_prefill_step(tc)(tp, {"tokens": torch.tensor(toks)})
    near(pre.numpy(), want[:, -1], rel(dtype))
    assert pin is None or pin.flips <= MAX_FLIPS


@pytest.mark.parametrize("arch", DENSE + MIXED)
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_decode_step_matches_jax(arch, dtype, monkeypatch):
    """Token-by-token decoding against the JAX decode loop; h2o-danube's
    ring buffer (S = window = 16) wraps at T = 32.  The MoE archs decode
    at their configured capacity, as the reference does (ROADMAP.md C.3):
    at n = B = 2 tokens a step, colliding choices drop in both."""
    rc, tc = smoke_pair(arch, dtype)
    rp, tp = carry(rc, tc)
    B, T = 2, SMOKE_T
    toks = tokens(tc.vocab_size, B, T)
    rc, pin = pin_routing(monkeypatch, rc, tc, dtype)
    rstate = r_lm.init_decode_state(rc, B, T)
    rstep = (lambda p, s, t: r_lm.decode_step(rc, p, s, t)) if pin else \
        jax.jit(lambda p, s, t: r_lm.decode_step(rc, p, s, t))
    state = lm.init_decode_state(tc, B, T)
    for j in range(len(tc.pattern())):
        carry_j, r_carry_j = state["layers"][f"pos{j}"], \
            rstate["layers"][f"pos{j}"]
        assert set(carry_j) == set(r_carry_j)
        for c in carry_j:
            assert tuple(carry_j[c].shape) == tuple(r_carry_j[c].shape)
    step = steps.build_serve_step(tc)
    got, want = [], []
    for t in range(T):
        lt, state = step(tp, state, torch.tensor(toks[:, t:t + 1]))
        got.append(lt)
        lg, rstate = rstep(rp, rstate, jnp.asarray(toks[:, t:t + 1]))
        want.append(np.asarray(lg))
    near(torch.cat(got, dim=1).numpy(), np.concatenate(want, axis=1),
         rel(dtype))
    assert pin is None or (not pin.choices and pin.flips <= MAX_FLIPS)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_vision_embeds_match_jax(dtype):
    """qwen2-vl's early fusion: patch embeddings [B, vis, d] in front of
    the text tokens, positions over both, M-RoPE (4, 2, 2) with t = h = w;
    forward and prefill against the JAX package, and the prefill's
    B9 call covers all vis + T positions."""
    rc, tc = smoke_pair("qwen2_vl_72b", dtype)
    rp, tp = carry(rc, tc)
    toks = tokens(tc.vocab_size, 2, SMOKE_T)
    vis = np.random.default_rng(11).normal(
        size=(2, tc.vis_tokens, tc.d_model)).astype(np.float32)
    want, _ = jax.jit(lambda p, b: r_lm.forward(rc, p, b))(
        rp, {"tokens": jnp.asarray(toks), "vision_embeds": jnp.asarray(vis)})
    want = np.asarray(want)
    assert want.shape == (2, tc.vis_tokens + SMOKE_T, tc.vocab_size)
    batch = {"tokens": torch.tensor(toks), "vision_embeds": torch.tensor(vis)}
    got, _ = lm.forward(tc, tp, batch)
    near(got.numpy(), want, rel(dtype))
    x, positions = lm.embed_inputs(tc, tp, batch)
    assert x.shape == (2, tc.vis_tokens + SMOKE_T, tc.d_model)
    assert torch.equal(positions[1], torch.arange(tc.vis_tokens + SMOKE_T))
    pre = steps.build_prefill_step(tc)(tp, batch)
    near(pre.numpy(), want[:, -1], rel(dtype))


def test_audio_frames_embed_as_given():
    """The ``audio_frames`` frontend of ``lm.embed_inputs`` (ref
    ``lm.py:176-180``): the frames are the embeddings, cast to the
    config's dtype, positions 0..T-1."""
    _, tc = tiny(frontend="audio_frames")
    tp = lm.init_params(tc, 0)
    frames = torch.randn(2, 5, 64, dtype=torch.float64)
    x, positions = lm.embed_inputs(tc, tp, {"frames": frames})
    assert x.dtype == torch.float32 and torch.equal(x, frames.float())
    assert positions.shape == (2, 5) and positions[0].tolist() == [0, 1, 2,
                                                                   3, 4]


# serve() decodes greedily in bf16, so an MoE arch's tokens follow the
# routing discontinuity above; the MoE archs' decode steps are held
# against the reference by test_decode_step_matches_jax instead
@pytest.mark.parametrize("arch", DENSE + ("qwen2_vl_72b",))
def test_serve_matches_jax_tokens(arch):
    """serve() on the CPU with the JAX package's parameters and seed gives
    the JAX package's serve() tokens (teacher-forced prompt, then greedy
    decoding, bf16 smoke config)."""
    want = r_serve.serve(arch, smoke=True, batch=2, prompt_len=8,
                         gen_len=8, seed=0)
    _, tp = carry(r_smoke(arch), get_smoke_config(arch), seed=0)
    got = t_serve.serve(arch, smoke=True, batch=2, prompt_len=8, gen_len=8,
                        seed=0, device="cpu", params=tp)
    assert got.shape == (2, 16)
    np.testing.assert_array_equal(got, np.asarray(want))


@pytest.mark.parametrize("arch", DENSE + MIXED + ("whisper_large_v3",))
def test_config_and_param_count_match_reference(arch):
    """Field for field (dtype aside) and the exact parameter count, from
    the def trees alone (no allocation).  The port leaves out only the
    reference's sharding and compilation fields, which it has nothing to
    read with; ``remat`` it keeps (it trains), and ``fsdp`` (the dry run
    reads it)."""
    rc, tc = r_get_config(arch), get_config(arch)
    for f in dataclasses.fields(ModelConfig):
        if f.name != "dtype":
            assert getattr(tc, f.name) == getattr(rc, f.name), f.name
    left_out = {f.name for f in dataclasses.fields(RConfig)} - {
        f.name for f in dataclasses.fields(ModelConfig)}
    assert left_out == {"scan_layers", "attn_sp",
                        "seq_shard", "dp_axes", "tp_axis", "unroll_inner",
                        "moe_ec_constraint"}
    assert {f.name for f in dataclasses.fields(ModelConfig)} <= {
        f.name for f in dataclasses.fields(RConfig)}
    assert tc.dtype == torch.bfloat16
    mod, r_mod = steps.model_module(tc), r_steps.model_module(rc)
    assert mod.__name__.rsplit(".", 1)[1] == r_mod.__name__.rsplit(".", 1)[1]
    assert mod.count_params(tc) == r_mod.count_params(rc)
    rs, ts = r_smoke(arch), get_smoke_config(arch)
    assert mod.count_params(ts) == r_mod.count_params(rs)
    if tc.moe_experts:
        assert lm.count_active_params(tc) == r_lm.count_active_params(rc)
        assert lm.count_active_params(tc) < lm.count_params(tc)


def test_qwen3_14b_parameter_count():
    """The number chip_smoke.py's qwen3-14b phases hard-code."""
    assert lm.count_params(get_config("qwen3_14b")) == 14_768_307_200


def test_params_from_numpy_loads_attention_trees():
    rc, tc = tiny(qk_norm=True)
    tree = to_numpy(r_lm.init_params(rc, jax.random.PRNGKey(0)))
    tp = lm.params_from_numpy(tc, tree)
    a = tp["layers"]["pos0"]["attn"]
    assert a["wq"].shape == (2, 64, 4, 16) and a["wk"].shape == (2, 64, 2, 16)
    assert a["wo"].shape == (2, 4, 16, 64) and a["q_norm"].shape == (2, 16)
    assert set(tp["layers"]["pos0"]["mlp"]) == {"wi", "wg", "wo"}
    np.testing.assert_array_equal(a["wv"].numpy(),
                                  tree["layers"]["pos0"]["attn"]["wv"])
    del tree["layers"]["pos0"]["attn"]["k_norm"]
    with pytest.raises(ValueError, match="missing"):
        lm.params_from_numpy(tc, tree)


def test_window_caps_the_decode_cache():
    _, tc = tiny(window=6)
    st = lm.init_decode_state(tc, 3, max_len=20)
    assert st["layers"]["pos0"]["k"].shape == (2, 3, 6, 2, 16)
    _, tc = tiny()
    st = lm.init_decode_state(tc, 3, max_len=20)
    assert st["layers"]["pos0"]["v"].shape == (2, 3, 20, 2, 16)
