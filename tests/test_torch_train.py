"""Training in the port (``repro_torch/models/{lm,whisper}.py`` loss and
remat, ``launch/{steps,train}.py``, ``optim/adamw.py``) held against the
JAX package on the CPU.

Both sides run the smoke configs in float32 (``dataclasses.replace(cfg,
dtype=float32)``); the JAX parameters are carried across with
``params_from_numpy``, the batches are numpy arrays from a seed (a fifth
of the labels masked with -1).  The reference runs as its own tests run
it on the CPU (``jax.jit`` of ``jax.value_and_grad`` and of
``build_train_step``; attention is its plain jnp code, the SSD scan its
plain path).  In float32 the MoE archs' expert choices agree in both
frameworks, so the reference runs unpinned, as the float32 cells of
tests/test_torch_models.py do: a flipped choice would break the loss rule.
Tolerances:

  * the loss and its metrics: rtol 1e-4;
  * every gradient leaf: 1e-3 of that leaf's max |g| (the two frameworks
    sum in other orders);
  * one train step: loss and grad norm rtol 1e-4, the moments 1e-3 of
    their max; a parameter within 1e-5 * max(1, |p|) where its gradient
    is above 1e-3 of the leaf's max |g|, else within 2.5 * lr (AdamW's
    first step moves p by lr * g / |g|: where |g| is rounding noise its
    sign, and so the step's, may differ);
  * the port against itself (accum, remat): accum = 2 against accum = 1 at
    tests/test_models.py:141's rtol 2e-2 / atol 2e-4, remat on against off
    bit for bit (the same operations run again).
"""

import dataclasses
import functools
import shutil

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_smoke_config as r_smoke
from repro.configs.registry import ARCHS
from repro.launch import steps as r_steps
from repro.models import lm as r_lm
from repro.optim import AdamWConfig as RAdamWConfig
from repro.optim import adamw_init as r_adamw_init
from repro_torch.configs import get_smoke_config
from repro_torch.kernels import ops
from repro_torch.launch import steps
from repro_torch.launch import train as t_train
from repro_torch.models import lm
from repro_torch.models.common import tree_leaves
from repro_torch.models.config import ModelConfig
from repro_torch.optim import AdamWConfig, adamw_init

LR = 1e-3


def f32_pair(arch):
    rc = dataclasses.replace(r_smoke(arch), dtype=jnp.float32)
    tc = dataclasses.replace(get_smoke_config(arch), dtype=torch.float32)
    return rc, tc


def batch_for(cfg, B=2, T=16, seed=0):
    """numpy batch of the arch's kind (tests/test_arch_smoke.py's
    shapes), a fifth of the labels masked."""
    rng = np.random.default_rng(seed)
    if cfg.frontend == "audio_frames":
        Td = max(1, T // cfg.dec_ratio)
        b = {"frames": rng.normal(size=(B, T, cfg.d_model)).astype(
                 np.float32),
             "tokens": rng.integers(0, cfg.vocab_size, (B, Td)).astype(
                 np.int32),
             "labels": rng.integers(0, cfg.vocab_size, (B, Td)).astype(
                 np.int32)}
    else:
        b = {"tokens": rng.integers(0, cfg.vocab_size, (B, T)).astype(
                 np.int32),
             "labels": rng.integers(0, cfg.vocab_size, (B, T)).astype(
                 np.int32)}
        if cfg.frontend == "vision_patches":
            b["vision_embeds"] = rng.normal(
                size=(B, cfg.vis_tokens, cfg.d_model)).astype(np.float32)
    b["labels"][:, ::5] = -1
    return b


def to_numpy(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


def jbatch(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


@functools.lru_cache(maxsize=None)
def reference(arch):
    """(numpy parameters, batch, loss, metrics, grads) of the reference's
    jitted ``value_and_grad(loss_fn)``, once per arch and worker."""
    rc, tc = f32_pair(arch)
    rmod = r_steps.model_module(rc)
    rp = rmod.init_params(rc, jax.random.PRNGKey(1))
    b = batch_for(tc)
    (loss, metrics), grads = jax.jit(jax.value_and_grad(
        lambda p, bb: rmod.loss_fn(rc, p, bb), has_aux=True))(rp, jbatch(b))
    return (to_numpy(rp), b, float(loss),
            {k: float(v) for k, v in metrics.items()}, to_numpy(grads))


def port_params(tc, tree):
    return steps.model_module(tc).params_from_numpy(tc, tree)


def port_grads(tc, params, b):
    leaves = [p for _path, p in tree_leaves(params)]
    for p in leaves:
        p.requires_grad_(True)
    loss, metrics = steps.model_module(tc).loss_fn(
        tc, steps._unstacked(params), b)
    grads = torch.autograd.grad(loss, leaves)
    for p in leaves:
        p.requires_grad_(False)
    paths = [path for path, _ in tree_leaves(params)]
    return loss.detach(), metrics, dict(zip(paths, grads))


def near_leaf(got, want, rel, what):
    want = np.asarray(want, np.float32)
    t = rel * max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=0,
                               atol=t, err_msg=what)


# ---------------------------------------------------------------------------
# chunked cross-entropy
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("T", [1024, 16])
def test_chunked_ce_matches_jax(T):
    """(nll_sum, z_weight * z_sum, count) and the gradients of their sum
    against the reference's ``chunked_ce``: two 512-chunks at T = 1,024,
    one chunk of T at T = 16; masked labels."""
    rng = np.random.default_rng(T)
    x = rng.normal(size=(2, T, 16)).astype(np.float32)
    w = rng.normal(size=(16, 50)).astype(np.float32)
    labels = rng.integers(0, 50, (2, T)).astype(np.int32)
    labels[:, ::3] = -1
    want = r_lm.chunked_ce(jnp.asarray(x), jnp.asarray(w),
                           jnp.asarray(labels))
    wg = jax.grad(lambda a, b: sum(r_lm.chunked_ce(a, b, jnp.asarray(
        labels))), argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
    xt = torch.tensor(x, requires_grad=True)
    wt = torch.tensor(w, requires_grad=True)
    got = lm.chunked_ce(xt, wt, torch.tensor(labels))
    gg = torch.autograd.grad(sum(got), (xt, wt))
    for g, v in zip(got, want):
        np.testing.assert_allclose(float(g.detach()), float(v), rtol=1e-5)
    assert float(got[2]) == float((labels >= 0).sum())
    for g, v in zip(gg, wg):
        near_leaf(g.numpy(), v, 1e-5, "chunked_ce grad")
    if T > 512:
        with pytest.raises(ValueError, match="multiple of the chunk"):
            lm.chunked_ce(xt[:, :1000], wt, torch.tensor(labels[:, :1000]))


# ---------------------------------------------------------------------------
# loss, gradients and one train step per arch
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_jax(arch):
    """The family's ``loss_fn``: loss, metrics and every gradient leaf
    against ``jax.value_and_grad`` of the reference's."""
    rc, tc = f32_pair(arch)
    tree, b, w_loss, w_metrics, w_grads = reference(arch)
    params = port_params(tc, tree)
    loss, metrics, grads = port_grads(tc, params, b)
    np.testing.assert_allclose(float(loss), w_loss, rtol=1e-4)
    assert set(metrics) == set(w_metrics) == {"ce", "aux", "zloss"}
    for k, v in w_metrics.items():
        np.testing.assert_allclose(float(metrics[k]), v, rtol=1e-4,
                                   atol=1e-7, err_msg=k)
    want = dict(tree_leaves(w_grads))
    assert set(grads) == set(want)
    for path, g in grads.items():
        assert g.shape == want[path].shape, path
        near_leaf(g.numpy(), want[path], 1e-3, "/".join(path))


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_jax(arch):
    """One ``build_train_step`` step (accum 1) against the reference's,
    from the same parameters and batch."""
    rc, tc = f32_pair(arch)
    tree, b, _loss, _metrics, w_grads = reference(arch)
    ocfg = dict(lr=LR, warmup_steps=1, total_steps=5)
    rstep = jax.jit(r_steps.build_train_step(rc, RAdamWConfig(**ocfg)))
    rp = jax.tree.map(jnp.asarray, tree)
    rp2, ropt, rmet = rstep(rp, r_adamw_init(rp), jbatch(b))
    params = port_params(tc, tree)
    step = steps.build_train_step(tc, AdamWConfig(**ocfg))
    params2, opt, met = step(params, adamw_init(params), b)
    assert params2 is params                       # updated in place
    assert int(opt["count"]) == int(ropt["count"]) == 1
    for k in ("loss", "grad_norm", "ce", "aux", "zloss"):
        np.testing.assert_allclose(float(met[k]), float(rmet[k]), rtol=1e-4,
                                   atol=1e-7, err_msg=k)
    g_want = dict(tree_leaves(w_grads))
    for name, got_tree, want_tree in (("m", opt["m"], ropt["m"]),
                                      ("v", opt["v"], ropt["v"])):
        want = dict(tree_leaves(to_numpy(want_tree)))
        for path, t in tree_leaves(got_tree):
            near_leaf(t.numpy(), want[path], 1e-3, f"{name} {path}")
    want_p = dict(tree_leaves(to_numpy(rp2)))
    for path, p in tree_leaves(params2):
        g = np.abs(g_want[path])
        tol = np.where(g > 1e-3 * g.max(),
                       1e-5 * np.maximum(1.0, np.abs(want_p[path])),
                       2.5 * LR)
        assert (np.abs(p.numpy() - want_p[path]) <= tol).all(), path


# ---------------------------------------------------------------------------
# the port's own train step
# ---------------------------------------------------------------------------

TINY = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
            vocab_size=64, dtype=torch.float32)


def test_grad_accumulation_matches_full_batch():
    """accum = 2 gives the update of accum = 1 (the counterpart of
    tests/test_models.py:141, at its tolerance)."""
    cfg = ModelConfig(**TINY)
    ocfg = AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    toks = np.random.default_rng(1).integers(0, 64, (4, 16)).astype(np.int32)
    batch = {"tokens": toks, "labels": np.roll(toks, -1, axis=1)}
    outs = []
    for accum in (1, 2):
        p = lm.init_params(cfg, 0)
        p, opt, met = steps.build_train_step(cfg, ocfg, accum=accum)(
            p, adamw_init(p), batch)
        outs.append((p, met))
    (p1, m1), (p2, m2) = outs
    for (path, a), (_, b) in zip(tree_leaves(p1), tree_leaves(p2)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=2e-2,
                                   atol=2e-4, err_msg=str(path))
    np.testing.assert_allclose(float(m1["loss"]), float(m2["loss"]),
                               rtol=1e-5)


def test_loss_decreases_on_overfit():
    """30 Adam steps on one tiny batch cut the loss (the counterpart of
    tests/test_models.py:117)."""
    cfg = ModelConfig(**TINY)
    step = steps.build_train_step(
        cfg, AdamWConfig(lr=3e-3, warmup_steps=2, total_steps=30))
    params = lm.init_params(cfg, 0)
    opt = adamw_init(params)
    toks = np.random.default_rng(1).integers(0, 64, (4, 32)).astype(np.int32)
    batch = {"tokens": toks, "labels": np.roll(toks, -1, axis=1)}
    losses = []
    for _ in range(30):
        params, opt, met = step(params, opt, batch)
        losses.append(float(met["loss"]))
    assert losses[-1] < losses[0] * 0.7, (losses[0], losses[-1])


@pytest.mark.parametrize("arch", ["starcoder2_3b", "jamba_v0_1_52b",
                                  "whisper_large_v3"])
def test_remat_on_equals_remat_off(arch):
    """Recomputing activations in the backward pass (per superblock, per
    layer inside jamba's 8-layer superblock, per whisper layer) changes
    no gradient bit."""
    _rc, tc = f32_pair(arch)
    tree, b = reference(arch)[:2]
    out = []
    for remat in (True, False):
        cfg = dataclasses.replace(tc, remat=remat)
        loss, _m, grads = port_grads(cfg, port_params(cfg, tree), b)
        out.append((float(loss), grads))
    assert out[0][0] == out[1][0]
    for path, g in out[0][1].items():
        assert torch.equal(g, out[1][1][path]), path


def test_remat_only_under_grad(monkeypatch):
    """The forward recomputes nothing where no gradient is taken (serving,
    ``torch.no_grad``), and checkpoints each superblock, and each layer of
    a multi-layer pattern, under grad."""
    calls = []
    real = lm.checkpoint

    def counted(fn, *a, **kw):
        calls.append(fn.__name__)
        return real(fn, *a, **kw)

    monkeypatch.setattr(lm, "checkpoint", counted)
    _rc, tc = f32_pair("jamba_v0_1_52b")
    params = port_params(tc, reference("jamba_v0_1_52b")[0])
    b = batch_for(tc)
    with torch.no_grad():
        lm.loss_fn(tc, params, b)
    assert calls == []
    params["embed"].requires_grad_(True)
    lm.loss_fn(tc, params, b)
    n_sup, n_pat = tc.n_superblocks, len(tc.pattern())
    assert calls.count("_superblock") == n_sup
    assert calls.count("_layer_aux") == n_sup * n_pat
    assert calls.count("_ce_chunk") == 1
    calls.clear()
    lm.loss_fn(dataclasses.replace(tc, remat=False), params, b)
    assert calls == ["_ce_chunk"]


def test_train_cli_checkpoint_and_resume(tmp_path, capsys):
    """``python -m repro_torch.launch.train`` on the CPU: a run with a
    checkpoint every 3 steps, then a resume from step 3 (the later
    checkpoints removed) that regenerates batches 3..7 and repeats the
    uninterrupted run's losses exactly."""
    args = ["--arch", "starcoder2_3b", "--smoke", "--steps", "8",
            "--batch", "2", "--seq", "16", "--device", "cpu"]
    full = t_train.train("starcoder2_3b", steps=8, batch=2, seq=16,
                         device="cpu")
    ck = tmp_path / "ck"
    t_train.main(args + ["--ckpt-dir", str(ck), "--ckpt-every", "3"])
    assert sorted(d.name for d in ck.iterdir()) == ["step_3", "step_6",
                                                    "step_8"]
    for s in ("step_6", "step_8"):
        shutil.rmtree(ck / s)
    resumed = t_train.train("starcoder2_3b", steps=8, batch=2, seq=16,
                            device="cpu", ckpt_dir=str(ck), ckpt_every=3)
    assert "resumed from step 3" in capsys.readouterr().out
    assert len(full) == 8 and len(resumed) == 5
    assert resumed == full[3:]
    assert full[-1] < full[0]


def test_train_refuses_encdec_and_meshes():
    """Enc-dec training is refused, as the reference refuses it; a mesh of
    more than one device needs a torchrun rank (``dist``) or a comm."""
    with pytest.raises(SystemExit):
        t_train.train("whisper_large_v3", steps=1, device="cpu")
    with pytest.raises(ValueError, match="DistributedComm"):
        t_train.train("starcoder2_3b", steps=1, device="cpu",
                      mesh_spec="data=2,model=2")


# ---------------------------------------------------------------------------
# B10's gradient: autograd of the plain version on the CPU, the kernel pair
# (ops.SsdIntraChunk) on the card
# ---------------------------------------------------------------------------

def _ssd_inputs(device="cpu", grad=True):
    g = torch.Generator().manual_seed(0)
    x = torch.randn(1, 8, 2, 4, generator=g)
    dt = torch.rand(1, 8, 2, generator=g)
    A = -torch.rand(2, generator=g)
    Bm, Cm = torch.randn(1, 8, 3, generator=g), torch.randn(1, 8, 3,
                                                             generator=g)
    out = [t.to(device) for t in (x, dt, A, Bm, Cm)]
    if grad:
        for t in out:
            t.requires_grad_(True)
    return out


def test_ssd_intra_chunk_grad_on_cpu_and_through_the_kernel_pair_off_it(
        monkeypatch):
    """On the CPU autograd differentiates B10's plain version; on a CUDA
    tensor that needs a gradient ``ops.ssd_intra_chunk`` goes through
    ``ops.SsdIntraChunk`` (modelled here by taking the CUDA branch on CPU
    tensors with the kernel wrappers replaced by their plain versions),
    whose backward launches B10's backward with the outputs' gradients and
    gives the plain version's; without one it goes to the forward wrapper
    alone (the real one refuses CPU tensors)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import ssd_chunk as ssd_mod
    args = _ssd_inputs()
    y, S, cd = ops.ssd_intra_chunk(*args, chunk=4)
    want = torch.autograd.grad(y.sum() + S.sum(), args)
    assert all(bool(torch.isfinite(g).all()) for g in want)
    with torch.no_grad():
        monkeypatch.setattr(ops, "_on_cpu", lambda t: False)
        with pytest.raises(ValueError, match="CUDA"):
            ops.ssd_intra_chunk(*args, chunk=4)
    calls = []

    def fwd(*a, chunk):
        calls.append("fwd")
        return ref.ssd_intra_chunk(*a, chunk=chunk)

    def bwd(*a, chunk):
        calls.append(("bwd", tuple(t is None for t in a[5:])))
        return ref.ssd_intra_chunk_bwd(*a, chunk=chunk)

    monkeypatch.setattr(ssd_mod, "ssd_chunk_cuda", fwd)
    monkeypatch.setattr(ssd_mod, "ssd_chunk_bwd_cuda", bwd)
    y, S, cd = ops.ssd_intra_chunk(*args, chunk=4)
    assert "SsdIntraChunk" in type(y.grad_fn).__name__
    got = torch.autograd.grad(y.sum() + S.sum(), args)
    assert calls == ["fwd", ("bwd", (False, False, True))]
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=2e-5 * max(
            1.0, float(w.abs().max())))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
def test_ssd_intra_chunk_grad_on_cuda_equals_plain(cuda):
    """A CUDA gradient through B10 and its backward kernel equals the plain
    version's autograd (1e-4 max(1, max |g|), B10's kernel tolerance)."""
    from repro_torch.kernels import ref
    args = _ssd_inputs(cuda)
    ops.reset_launch_counts()
    y, S, cd = ops.ssd_intra_chunk(*args, chunk=4)
    got = torch.autograd.grad(y.sum() + S.sum() + cd.sum(), args)
    counts = ops.launch_counts()
    assert counts["ssd_chunk"] == 1 and counts["ssd_chunk_bwd"] == 1
    y, S, cd = ref.ssd_intra_chunk(*args, chunk=4)
    want = torch.autograd.grad(y.sum() + S.sum() + cd.sum(), args)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=1e-4 * max(
            1.0, float(w.abs().max())))
