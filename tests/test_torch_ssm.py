"""The port's Mamba2 stack (``repro_torch/models``, ``configs``, ``launch``)
held against the JAX package's, on the CPU.

Inputs are made from a seed with numpy; the JAX parameters
(``repro.models.lm.init_params``) are carried across with
``lm.params_from_numpy``, so both packages compute the same function.
Two configurations: the mamba2-130m SMOKE config and the "ssm" config of
tests/test_models.py.  Tolerances:

  * f32 copies of both configs: 1e-4 (the two run the same float32 ops in
    another order; the measured gap is ~3e-6);
  * bf16 (the configs' own dtype): 2e-2 * max(1, max |logit|), five bf16
    ulps of the largest logit — the two frameworks round bf16 at other
    places;
  * the SSD scan: 1e-4, the reference's kernel tolerance;
  * the port's decode against its own forward: 2e-2, the bound of
    tests/test_models.py:50.

The attention family has its own file, tests/test_torch_models.py.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_smoke_config as r_smoke
from repro.launch import serve as r_serve
from repro.models import lm as r_lm
from repro.models import ssm as r_ssm
from repro.models.config import ModelConfig as RConfig
from repro_torch.configs import get_config, get_smoke_config, registry
from repro_torch.kernels import ref
from repro_torch.launch import serve as t_serve
from repro_torch.launch import steps
from repro_torch.models import lm, ssm
from repro_torch.models.config import ModelConfig

SSM_KW = dict(n_layers=2, d_model=64, d_ff=0, vocab_size=64, family="ssm",
              layer_pattern=("M",), ssm_state=16, ssm_head_dim=16,
              ssm_chunk=4)
CONFIGS = ("smoke", "ssm")
DTYPES = ("f32", "bf16")


def configs(name, dtype):
    """(JAX config, port config) with the same fields."""
    if name == "ssm":
        rc = RConfig(dtype=jnp.float32, n_heads=0, n_kv_heads=0, **SSM_KW)
        tc = ModelConfig(dtype=torch.float32, **SSM_KW)
        if dtype == "bf16":
            rc = dataclasses.replace(rc, dtype=jnp.bfloat16)
            tc = dataclasses.replace(tc, dtype=torch.bfloat16)
        return rc, tc
    rc, tc = r_smoke("mamba2_130m"), get_smoke_config("mamba2_130m")
    if dtype == "f32":
        rc = dataclasses.replace(rc, dtype=jnp.float32)
        tc = dataclasses.replace(tc, dtype=torch.float32)
    return rc, tc


def jax_params(rc, seed=1):
    return r_lm.init_params(rc, jax.random.PRNGKey(seed))


def to_numpy(tree):
    return jax.tree.map(lambda a: np.asarray(a.astype(jnp.float32)), tree)


def tokens(rc, B, T, seed=2):
    return np.random.default_rng(seed).integers(
        0, rc.vocab_size, (B, T)).astype(np.int32)


def seq(name):
    return 32 if name == "smoke" else 16      # two / four chunks


def tol(dtype, want):
    if dtype == "f32":
        return 1e-4
    return 2e-2 * max(1.0, float(np.abs(want).max()))


def assert_near(got, want, dtype):
    t = tol(dtype, want)
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=t, atol=t)


# ---------------------------------------------------------------------------
# The SSD scan
# ---------------------------------------------------------------------------

def _ssd_np(B=2, T=32, H=3, P=8, N=16, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, T, H, P)).astype(np.float32),
            rng.uniform(0.01, 0.2, size=(B, T, H)).astype(np.float32),
            (-rng.uniform(0.5, 2, size=(H,))).astype(np.float32),
            rng.normal(size=(B, T, N)).astype(np.float32),
            rng.normal(size=(B, T, N)).astype(np.float32),
            rng.normal(size=(B, H, N, P)).astype(np.float32))


@pytest.mark.parametrize("chunk", [1, 4, 8, 32])
@pytest.mark.parametrize("with_h0", [False, True])
def test_ssd_chunked_matches_jax(chunk, with_h0):
    """y and the final state of the model's chunked scan, with and without
    a carried state, against repro.models.ssm.ssd_chunked (1e-4)."""
    *args, h0 = _ssd_np(seed=chunk)
    h0 = h0 if with_h0 else None
    wy, wh = r_ssm.ssd_chunked(*(jnp.asarray(a) for a in args), chunk,
                               h0=None if h0 is None else jnp.asarray(h0))
    targs = [torch.tensor(a) for a in args]
    th0 = None if h0 is None else torch.tensor(h0)
    y, hT = ssm.ssd_chunked(*targs, chunk, h0=th0)
    np.testing.assert_allclose(y.numpy(), np.asarray(wy), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(hT.numpy(), np.asarray(wh), rtol=1e-4,
                               atol=1e-4)


def test_ssd_chunked_matches_sequential_oracle():
    *args, _h0 = _ssd_np(seed=9)
    targs = [torch.tensor(a) for a in args]
    want = ref.ssd_chunk(*targs)
    for chunk in (1, 4, 8, 32):
        torch.testing.assert_close(ssm.ssd_chunked(*targs, chunk)[0], want,
                                   rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# The Mamba2 block and the LM stack
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", CONFIGS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_mamba_block_matches_jax(name, dtype):
    rc, tc = configs(name, dtype)
    rp = jax_params(rc)
    p0_np = to_numpy(jax.tree.map(lambda a: a[0], rp["layers"]["pos0"]["ssm"]))
    p0 = {k: torch.tensor(v).to(tc.dtype) for k, v in p0_np.items()}
    x = np.random.default_rng(4).normal(size=(2, seq(name), rc.d_model))
    xj = jnp.asarray(x, rc.dtype)
    want, wst = r_ssm.mamba_block(rc, jax.tree.map(lambda a: a[0],
                                                   rp["layers"]["pos0"]["ssm"]),
                                  xj)
    xt = torch.tensor(x).to(tc.dtype)
    got, st = ssm.mamba_block(tc, p0, xt)
    want = np.asarray(want.astype(jnp.float32))
    assert_near(got.float().numpy(), want, dtype)
    assert_near(st["ssm"].numpy(), np.asarray(wst["ssm"]), dtype)
    # the module form computes the same
    mod_out, _ = ssm.MambaBlock(tc, p0)(xt)
    assert torch.equal(mod_out, got)


@pytest.mark.parametrize("name", CONFIGS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_forward_and_prefill_match_jax(name, dtype):
    rc, tc = configs(name, dtype)
    rp = jax_params(rc)
    tp = lm.params_from_numpy(tc, to_numpy(rp))
    toks = tokens(rc, 2, seq(name))
    want, _ = jax.jit(lambda p, b: r_lm.forward(rc, p, b))(
        rp, {"tokens": jnp.asarray(toks)})
    want = np.asarray(want)
    got, aux = lm.forward(tc, tp, {"tokens": torch.tensor(toks)})
    assert got.dtype == torch.float32 and float(aux) == 0.0
    assert_near(got.numpy(), want, dtype)
    pre = steps.build_prefill_step(tc)(tp, {"tokens": torch.tensor(toks)})
    assert_near(pre.numpy(), want[:, -1], dtype)


@pytest.mark.parametrize("name", CONFIGS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_decode_matches_jax_and_forward(name, dtype):
    """Token-by-token decoding against the JAX decode loop, and against the
    port's own forward (2e-2, tests/test_models.py's bound)."""
    rc, tc = configs(name, dtype)
    rp = jax_params(rc)
    tp = lm.params_from_numpy(tc, to_numpy(rp))
    B, T = 2, seq(name)
    toks = tokens(rc, B, T)
    rstate = r_lm.init_decode_state(rc, B, T)
    rstep = jax.jit(lambda p, s, t: r_lm.decode_step(rc, p, s, t))
    state = lm.init_decode_state(tc, B, T)
    step = steps.build_serve_step(tc)
    got, want = [], []
    for t in range(T):
        lg, rstate = rstep(rp, rstate, jnp.asarray(toks[:, t:t + 1]))
        want.append(np.asarray(lg))
        lt, state = step(tp, state, torch.tensor(toks[:, t:t + 1]))
        got.append(lt)
    assert state["pos"] == T
    got = torch.cat(got, dim=1)
    assert_near(got.numpy(), np.concatenate(want, axis=1), dtype)
    fwd, _ = lm.forward(tc, tp, {"tokens": torch.tensor(toks)})
    assert float((fwd - got).abs().max()) < 2e-2


def test_serve_matches_jax_tokens():
    """The CLI's serve() on the CPU with the JAX package's parameters and
    seed gives the JAX package's serve() tokens (teacher-forced prompt, then greedy
    decoding, bf16 smoke config)."""
    want = r_serve.serve("mamba2_130m", smoke=True, batch=2, prompt_len=8,
                         gen_len=8, seed=0)
    rc = r_smoke("mamba2_130m")
    tc = get_smoke_config("mamba2_130m")
    tp = lm.params_from_numpy(
        tc, to_numpy(r_lm.init_params(rc, jax.random.PRNGKey(0))))
    got = t_serve.serve("mamba2_130m", smoke=True, batch=2, prompt_len=8,
                        gen_len=8, seed=0, device="cpu", params=tp)
    assert got.shape == (2, 16)
    np.testing.assert_array_equal(got, np.asarray(want))


def test_serve_cli_on_cpu(capsys):
    t_serve.main(["--arch", "mamba2_130m", "--smoke", "--device", "cpu",
                  "--batch", "2", "--prompt-len", "4", "--gen-len", "4"])
    assert "decoded 2x8 tokens" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# Configs, parameters, registry
# ---------------------------------------------------------------------------

def test_mamba2_130m_config_matches_reference():
    from repro.configs import get_config as r_get_config
    rc, tc = r_get_config("mamba2_130m"), get_config("mamba2_130m")
    for f in dataclasses.fields(ModelConfig):
        if f.name != "dtype":
            assert getattr(tc, f.name) == getattr(rc, f.name), f.name
    assert tc.dtype == torch.bfloat16
    assert lm.count_params(tc) == r_lm.count_params(rc) == 128_983_488
    assert (tc.d_inner, tc.ssm_heads) == (1536, 24)
    assert get_config("mamba2-130m") is tc


def test_registry_refuses_unported_archs():
    """Every arch of the reference resolves in the port now (ROADMAP.md
    A.17 items 2-3 are done): PORTED holds all ten, and only an unknown
    name is refused."""
    assert registry.ARCHS[0] == "mamba2_130m" and len(registry.ARCHS) == 10
    assert registry.SHAPES["prefill_32k"].seq_len == 32_768
    assert "mamba2_130m" in registry.LONG_OK
    assert set(registry.PORTED) == set(registry.ARCHS)
    for arch in registry.ARCHS:
        assert get_config(arch).name == arch
        assert get_smoke_config(arch).dtype == torch.bfloat16
        assert get_config(arch.replace("_", "-")) is get_config(arch)
    with pytest.raises(KeyError):
        get_config("gpt2")
    with pytest.raises(KeyError):
        get_smoke_config("gpt2")


@pytest.mark.parametrize("arch", ["mamba2_130m", "mamba2-130m",
                                  "jamba_v0_1_52b", "qwen3_14b",
                                  "whisper_large_v3"])
def test_shape_cells_match_reference(arch):
    """The shapes an arch runs, long_500k gated to the sub-quadratic archs
    (``repro.configs.registry.shape_cells``)."""
    from repro.configs import registry as r_registry
    want = [(c.name, c.kind, c.seq_len, c.global_batch)
            for c in r_registry.shape_cells(arch)]
    got = [(c.name, c.kind, c.seq_len, c.global_batch)
           for c in registry.shape_cells(arch)]
    assert got == want
    assert ("long_500k" in [c[0] for c in got]) == (
        arch.replace("-", "_") in registry.LONG_OK)


def test_all_cells_match_reference():
    from repro.configs import registry as r_registry
    want = [(a, c.name) for a, c in r_registry.all_cells()]
    got = [(a, c.name) for a, c in registry.all_cells()]
    assert got == want and len(got) == 3 * len(registry.ARCHS) + 3


@pytest.mark.parametrize("name", CONFIGS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_mamba_decode_step_matches_jax(name, dtype):
    """A prompt through the block, then one-token steps with the carried
    (conv, ssm) state, against ``repro.models.ssm.mamba_decode_step``."""
    rc, tc = configs(name, dtype)
    rp = jax.tree.map(lambda a: a[0], jax_params(rc)["layers"]["pos0"]["ssm"])
    p0 = {k: torch.tensor(v).to(tc.dtype) for k, v in to_numpy(rp).items()}
    x = np.random.default_rng(6).normal(size=(2, 8, rc.d_model))
    _, wst = r_ssm.mamba_block(rc, rp, jnp.asarray(x[:, :4], rc.dtype))
    _, st = ssm.mamba_block(tc, p0, torch.tensor(x[:, :4]).to(tc.dtype))
    for t in range(4, 8):
        want, wst = r_ssm.mamba_decode_step(
            rc, rp, jnp.asarray(x[:, t:t + 1], rc.dtype), wst)
        got, st = ssm.mamba_decode_step(
            tc, p0, torch.tensor(x[:, t:t + 1]).to(tc.dtype), st)
        assert got.shape == (2, 1, rc.d_model)
        assert_near(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
                    dtype)
        assert_near(st["ssm"].numpy(), np.asarray(wst["ssm"]), dtype)
        assert_near(st["conv"].float().numpy(),
                    np.asarray(wst["conv"].astype(jnp.float32)), dtype)


def test_unported_layer_kinds_raise():
    """The layer kinds that raised before A.17 item 2 (MoE after either
    layer kind, the hybrid MLP after a Mamba layer) now build, and their
    ParamDef trees match the reference's key for key and shape for
    shape; the encoder-decoder tree is ``models/whisper.py``'s."""
    from repro.models import common as r_common
    from repro.models import whisper as r_whisper
    from repro_torch.models import common, whisper
    cases = [dict(moe_experts=4, moe_top_k=2),
             dict(moe_experts=4, moe_top_k=1, moe_shared=True, moe_every=2),
             dict(family="hybrid", layer_pattern=("M", "A"), n_layers=4,
                  ssm_state=16, ssm_head_dim=16),
             dict(family="hybrid", layer_pattern=("M", "M", "A", "M"),
                  n_layers=4, ssm_state=16, ssm_head_dim=16, moe_experts=4,
                  moe_top_k=2, moe_every=2)]

    def flat(defs):
        return {"/".join(p): (d.shape, d.spec, d.init, d.scale, d.fan_in)
                for p, d in common.tree_leaves(defs)}

    for kw in cases:
        rc = RConfig(dtype=jnp.float32, **kw)
        tc = ModelConfig(dtype=torch.float32, **kw)
        want = flat(r_lm.model_defs(rc))
        assert all(isinstance(d, r_common.ParamDef) for _p, d in
                   common.tree_leaves(r_lm.model_defs(rc)))
        assert flat(lm.model_defs(tc)) == want, kw
        assert lm.count_params(tc) == r_lm.count_params(rc)
    kinds = lm.model_defs(ModelConfig(**cases[3]))["layers"]
    assert set(kinds["pos0"]) == {"norm1", "ssm", "norm2", "mlp"}
    assert set(kinds["pos1"]) == {"norm1", "ssm", "norm2", "moe"}
    assert set(kinds["pos2"]) == {"norm1", "attn", "norm2", "mlp"}
    assert set(kinds["pos3"]) == {"norm1", "ssm", "norm2", "moe"}
    enc = dict(encdec=True, n_layers=2, n_enc_layers=3)
    assert whisper.count_params(ModelConfig(**enc)) == \
        r_whisper.count_params(RConfig(**enc))


def test_params_from_numpy_checks_the_tree():
    rc, tc = configs("ssm", "f32")
    tree = to_numpy(jax_params(rc))
    tp = lm.params_from_numpy(tc, tree)
    assert tp["layers"]["pos0"]["ssm"]["in_proj"].shape == (2, 64, 2 * 128
                                                            + 2 * 16 + 8)
    del tree["final_norm"]
    with pytest.raises(ValueError, match="missing"):
        lm.params_from_numpy(tc, tree)


def test_init_params_is_seeded():
    _, tc = configs("smoke", "bf16")
    a, b = lm.init_params(tc, 3), lm.init_params(tc, 3)
    c = lm.init_params(tc, 4)
    assert torch.equal(a["embed"], b["embed"])
    assert not torch.equal(a["embed"], c["embed"])
    assert a["embed"].dtype == torch.bfloat16
    assert bool((a["layers"]["pos0"]["ssm"]["A_log"] == 1).all())
    # the embedding's std is 1/sqrt(d_model) (the reference's "embed" init)
    std = float(a["embed"].float().std())
    assert abs(std * np.sqrt(tc.d_model) - 1) < 0.05
