"""The port's encoder-decoder (``repro_torch/models/whisper.py``, its
``launch/steps.py`` branches) held against the JAX package's
``repro.models.whisper`` on the CPU.

Inputs are made from a seed with numpy; the JAX parameters
(``repro.models.whisper.init_params``) are carried across with
``whisper.params_from_numpy``, so both packages compute the same function.
Two configurations: whisper-large-v3's SMOKE config and the one of
tests/test_models.py's ``test_whisper_decode_matches_forward``.
Tolerances, of max(1, max |want|):

  * float32: 1e-4 (the same float32 ops in another order, as
    tests/test_torch_models.py holds the LM stacks);
  * bfloat16 (the smoke config's own dtype): 2e-2, the two frameworks
    round bf16 at other places;
  * the port's decode against its own forward: 2e-2, the bound of
    tests/test_models.py:70.

On the CPU the encoder's full and the decoder's causal self attention run
B9's plain version through ``ops.flash_attention``;
``test_self_attention_routes_to_b9`` counts those calls.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_config as r_get_config
from repro.configs import get_smoke_config as r_smoke
from repro.launch import steps as r_steps
from repro.models import whisper as r_whisper
from repro.models.config import ModelConfig as RConfig
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.kernels import ops
from repro_torch.launch import steps
from repro_torch.models import lm, whisper
from repro_torch.models.config import ModelConfig

TINY = dict(family="audio", encdec=True, n_layers=2, n_enc_layers=2,
            d_model=64, n_heads=4, n_kv_heads=4, d_ff=128, vocab_size=64,
            norm="layernorm", mlp="gelu", pos="sincos",
            frontend="audio_frames", tie_embeddings=True)
CONFIGS = ("smoke", "tiny")
DTYPES = ("f32", "bf16")
# encoder frames (not a multiple of B9's 64-row tiles) and decoder tokens
B, T_ENC, T_DEC = 2, 37, 8


def configs(name, dtype):
    """(JAX config, port config) with the same fields."""
    if name == "tiny":
        rc = RConfig(dtype=jnp.float32, **TINY)
        tc = ModelConfig(dtype=torch.float32, **TINY)
    else:
        rc, tc = r_smoke("whisper_large_v3"), get_smoke_config(
            "whisper_large_v3")
    if dtype == "f32":
        return (dataclasses.replace(rc, dtype=jnp.float32),
                dataclasses.replace(tc, dtype=torch.float32))
    return (dataclasses.replace(rc, dtype=jnp.bfloat16),
            dataclasses.replace(tc, dtype=torch.bfloat16))


def carry(rc, tc, seed=3):
    rp = r_whisper.init_params(rc, jax.random.PRNGKey(seed))
    tree = jax.tree.map(lambda a: np.asarray(a.astype(jnp.float32)), rp)
    return rp, whisper.params_from_numpy(tc, tree)


def inputs(tc, seed=4):
    rng = np.random.default_rng(seed)
    frames = rng.normal(size=(B, T_ENC, tc.d_model)).astype(np.float32)
    toks = rng.integers(0, tc.vocab_size, (B, T_DEC)).astype(np.int32)
    return frames, toks


def rel(dtype):
    return 1e-4 if dtype == "f32" else 2e-2


def near(got, want, r):
    want = np.asarray(want, np.float32)
    t = r * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=t,
                               atol=t)


@pytest.mark.parametrize("name", CONFIGS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_encode_matches_jax(name, dtype):
    rc, tc = configs(name, dtype)
    rp, tp = carry(rc, tc)
    frames, _ = inputs(tc)
    got = whisper.encode(tc, tp, torch.tensor(frames))
    want = jax.jit(lambda p, f: r_whisper.encode(rc, p, f))(
        rp, jnp.asarray(frames))
    assert got.dtype == tc.dtype and got.shape == (B, T_ENC, tc.d_model)
    near(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
         rel(dtype))


@pytest.mark.parametrize("name", CONFIGS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_forward_and_prefill_match_jax(name, dtype):
    rc, tc = configs(name, dtype)
    rp, tp = carry(rc, tc)
    frames, toks = inputs(tc)
    batch = {"frames": frames, "tokens": toks}
    want, w_aux = jax.jit(lambda p, b: r_whisper.forward(rc, p, b))(
        rp, jax.tree.map(jnp.asarray, batch))
    want = np.asarray(want)
    got, aux = whisper.forward(tc, tp, {k: torch.tensor(v)
                                        for k, v in batch.items()})
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert float(aux) == float(w_aux) == 0.0
    near(got.numpy(), want, rel(dtype))
    pre = steps.build_prefill_step(tc)(
        tp, {k: torch.tensor(v) for k, v in batch.items()})
    r_pre = jax.jit(r_steps.build_prefill_step(rc))(
        rp, jax.tree.map(jnp.asarray, batch))
    near(pre.numpy(), np.asarray(r_pre), rel(dtype))
    near(pre.numpy(), want[:, -1], rel(dtype))


@pytest.mark.parametrize("name", CONFIGS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_decode_step_matches_jax(name, dtype):
    """Token-by-token decoding against the JAX decode loop, both on
    cached self K/V and the precomputed cross K/V of one encoder memory;
    and (counterpart of tests/test_models.py:53) against the port's own
    teacher-forced forward."""
    rc, tc = configs(name, dtype)
    rp, tp = carry(rc, tc)
    frames, toks = inputs(tc)
    memory = whisper.encode(tc, tp, torch.tensor(frames))
    r_memory = jax.jit(lambda p, f: r_whisper.encode(rc, p, f))(
        rp, jnp.asarray(frames))
    state = whisper.init_decode_state(tc, tp, B, T_DEC, memory)
    rstate = r_whisper.init_decode_state(rc, rp, B, T_DEC, r_memory)
    for key in ("k", "v", "xk", "xv"):
        assert tuple(state[key].shape) == tuple(rstate[key].shape), key
        assert state[key].dtype == tc.dtype
    near(state["xk"].float().numpy(),
         np.asarray(rstate["xk"].astype(jnp.float32)), rel(dtype))
    rstep = jax.jit(lambda p, s, t: r_whisper.decode_step(rc, p, s, t))
    step = steps.build_serve_step(tc)
    got, want = [], []
    for t in range(T_DEC):
        lt, state = step(tp, state, torch.tensor(toks[:, t:t + 1]))
        got.append(lt)
        lg, rstate = rstep(rp, rstate, jnp.asarray(toks[:, t:t + 1]))
        want.append(np.asarray(lg))
    assert state["pos"] == T_DEC
    dec = torch.cat(got, dim=1)
    near(dec.numpy(), np.concatenate(want, axis=1), rel(dtype))
    fwd, _ = whisper.forward(tc, tp, {"frames": torch.tensor(frames),
                                      "tokens": torch.tensor(toks)})
    assert float((fwd - dec).abs().max()) < 2e-2 * max(
        1.0, float(fwd.abs().max()))


@pytest.mark.parametrize("pos", [0, 1, 7, 447, 1499, 65535])
def test_decode_position_embedding_matches_jax(pos):
    """The decode step's sin / cos at ``pos``, formed in float32 as the
    reference forms it (``whisper.py:171-175``).  XLA's and torch's
    float32 ``pow`` differ by an ulp at some of the divisors 10000^(2i/d)
    (11 of 640 at d = 1,280), so each angle pos / divisor may differ by
    two ulps of itself (the divisor's and the quotient's roundings), at
    most pos * 2^-22, and its sin / cos by that plus their own
    rounding (1e-6)."""
    d = 1280
    i = jnp.arange(d // 2)
    den = 10_000 ** (2 * i / d)
    ang = jnp.asarray(pos, jnp.int32).astype(jnp.float32) / den
    want = np.concatenate([np.asarray(jnp.sin(ang)),
                           np.asarray(jnp.cos(ang))])
    cfg = ModelConfig(d_model=d, n_heads=20)
    got = whisper._position_embedding(cfg, pos, "cpu")
    assert got.dtype == torch.float32 and got.shape == (1, 1, d)
    t_den = 10_000 ** (2 * torch.arange(d // 2) / d)
    assert t_den.dtype == torch.float32
    np.testing.assert_allclose(t_den.numpy(), np.asarray(den), rtol=2.0 ** -23,
                               atol=0)
    np.testing.assert_allclose(got[0, 0].numpy(), want, rtol=0,
                               atol=pos * 2.0 ** -22 + 1e-6)


def test_self_attention_routes_to_b9(monkeypatch):
    """The encoder's self attention reaches ops.flash_attention (B9 on a
    CUDA tensor) non-causal once a layer, the decoder's causal once a
    layer; cross-attention and the decode step do not."""
    calls = []
    plain = ops.flash_attention

    def counted(q, k, v, *, causal):
        calls.append((q.shape[1], k.shape[1], causal))
        return plain(q, k, v, causal=causal)

    monkeypatch.setattr(ops, "flash_attention", counted)
    rc, tc = configs("smoke", "bf16")
    tp = whisper.init_params(tc, 0)
    frames, toks = inputs(tc)
    steps.build_prefill_step(tc)(tp, {"frames": torch.tensor(frames),
                                      "tokens": torch.tensor(toks)})
    assert calls == [(T_ENC, T_ENC, False)] * tc.n_enc_layers + [
        (T_DEC, T_DEC, True)] * tc.n_layers
    memory = whisper.encode(tc, tp, torch.tensor(frames))
    del calls[:]
    state = whisper.init_decode_state(tc, tp, B, 4, memory)
    steps.build_serve_step(tc)(tp, state, torch.tensor(toks[:, :1]))
    assert calls == []


def test_whisper_config_and_parameters():
    """The full config field for field and its parameter count (the number
    the chip run's whisper phase hard-codes); the tree loads from the
    reference's and is seeded."""
    rc, tc = r_get_config("whisper_large_v3"), get_config("whisper_large_v3")
    for f in dataclasses.fields(ModelConfig):
        if f.name != "dtype":
            assert getattr(tc, f.name) == getattr(rc, f.name), f.name
    assert whisper.count_params(tc) == r_whisper.count_params(rc) \
        == 1_534_809_600
    assert steps.model_module(tc) is whisper
    assert steps.model_module(get_config("jamba_v0_1_52b")) is lm
    rs, ts = configs("smoke", "bf16")
    tree = jax.tree.map(lambda a: np.asarray(a.astype(jnp.float32)),
                        r_whisper.init_params(rs, jax.random.PRNGKey(0)))
    tp = whisper.params_from_numpy(ts, tree)
    assert tp["dec_layers"]["cross_attn"]["wq"].shape == (2, 64, 4, 16)
    assert tp["enc_norm"]["beta"].dtype == torch.bfloat16
    del tree["enc_layers"]["mlp"]["wi"]
    with pytest.raises(ValueError, match="missing"):
        whisper.params_from_numpy(ts, tree)
    a, b = whisper.init_params(ts, 5), whisper.init_params(ts, 5)
    assert torch.equal(a["embed"], b["embed"])
    assert not torch.equal(a["embed"], whisper.init_params(ts, 6)["embed"])
