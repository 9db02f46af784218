"""The LM train and prefill steps on a mesh of ranks (``launch/steps.py``
with ``mesh=``, ``launch/mesh.py``, ``core.comm.DistributedComm``'s
groups) held against the reference's sharded program and against the
port's single-process step.

The reference side is the program the reference's dry run lowers:
``repro.launch.dryrun._jit_for_cell`` of ``steps.prepare_config(cfg,
mesh)`` on a ``repro.launch.mesh.make_mesh`` mesh of fake CPU devices,
its ``in_shardings`` the resolved parameter, ZeRO-1 moment and batch
specs, executed on real arrays in three JAX subprocesses with 8
devices each (the cells dealt among them).  The port runs as gloo ranks on the
CPU, one process per device, one spawn per mesh started beside the JAX
subprocesses (``file://`` stores, one intra-op thread a rank): each rank
takes its shards of the same parameters (the reference's
``init_params`` at key 1, carried across with ``params_from_numpy``) and
batch, runs one step and writes its metrics and shards.  The configs are
the float32 smoke configs with the full config's ``fsdp``
(tests/test_torch_train.py's ``f32_pair``); llama4-scout's
``capacity_factor`` is lowered to 0.5, so choices drop at the global
capacity (asserted).  The meshes: ``data=4`` (written ``(data=4,
model=1)``: the reference's spec arithmetic needs a "model" axis),
``(data=2, model=2)`` and ``(pod=2, data=2, model=2)``.  On the meshes
with "model" = 2 the ranks compute on "model" (tensor-parallel: each its
heads, MLP columns, experts and vocabulary slice; the residual stream
between blocks its half of the sequence), which every rank records: the
shapes of each layer's residual input, of the q / k / v that reach
``ops.flash_attention`` and of the x that reaches ``ssd_chunked``.  In
the same spawns each rank holds the autograd collectives of
``launch.mesh.TensorParallel`` and the vocabulary-parallel
cross-entropy, value and gradient, against one process's functions on
the same inputs (``lm.chunked_ce``).  jamba-v0.1's smoke superblock
(Mamba2, attention and MoE layers, all split over "model") runs on
``(data=2, model=2)``.

Tolerances are tests/test_torch_train.py's for one step: metrics rtol
1e-4 (atol 1e-7); the moments 1e-3 of the leaf's max; a parameter within
1e-5 max(1, |p|) where its first moment (the clipped gradient's tenth) is
above 1e-3 of the leaf's max, else within 2.5 lr; prefill logits 1e-4 of
their max.  Against the port's single-process step on the whole batch the
same tolerances hold; the two are not bit-equal, since the dp sum and the
sum over ranks of the squared norms add in another order.  Every
reference cell runs on jax 0.9 here, so none is held to the
single-process step instead.

Also: each rank's resident parameter and moment bytes equal
``dryrun.argument_bytes``' per-device figures and every shard has the dry
run's shard shape; a checkpoint written on ``(data=2, model=2)`` resumes
on ``(data=4)`` and in one process with the uninterrupted run's losses
(rtol 1e-3: the resumed runs' AdamW steps differ in rounding); a mesh
whose size differs from the comm's raises; a rank whose peer exits fails
within its timeout; the data pipeline keeps each rank's shard of the
global (seed, step) draw.
"""

import dataclasses
import datetime
import json
import os
import shutil
import subprocess
import sys
import time
import types
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

import jax
import jax.numpy as jnp

from _torch_mesh_ranks import deal, flat, join as _join, spawn as _spawn, \
    unflat
from repro.configs import get_config as r_config
from repro.configs import get_smoke_config as r_smoke
from repro.launch import steps as r_steps
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core.comm import DistributedComm
from repro_torch.launch import dryrun, meta_trace, mesh as t_mesh, steps
from repro_torch.launch import train as t_train
from repro_torch.kernels import ops
from repro_torch.models import lm, moe, ssm, whisper
from repro_torch.models.common import tree_leaves
from repro_torch.optim import AdamWConfig, adamw_init

SRC = Path(__file__).resolve().parents[1] / "src"
LR = 1e-3
OCFG = dict(lr=LR, warmup_steps=1, total_steps=5)
B, T = 4, 16
MESHES = {"data4": ((4, 1), ("data", "model")),
          "data2_model2": ((2, 2), ("data", "model")),
          "pod2_data2_model2": ((2, 2, 2), ("pod", "data", "model"))}
OVERRIDES = {"llama4_scout_17b_a16e": dict(capacity_factor=0.5)}
ARCHS = ("starcoder2_3b", "qwen3_14b", "mamba2_130m",
         "llama4_scout_17b_a16e", "qwen2_vl_72b", "whisper_large_v3",
         "jamba_v0_1_52b")
MOE = "llama4_scout_17b_a16e"
# (arch, mesh, kind, accum)
CELLS = ([(a, "data2_model2", "train", 1) for a in ARCHS]
         + [(a, m, "train", 1) for a in ("qwen3_14b", MOE)
            for m in ("data4", "pod2_data2_model2")]
         + [(MOE, "data2_model2", "train", 2),
            ("qwen3_14b", "data2_model2", "prefill", 1),
            ("whisper_large_v3", "data2_model2", "prefill", 1)])
CKPT_ARCH = "starcoder2_3b"
RANK_TIMEOUT = datetime.timedelta(seconds=60)
SPAWN_SECONDS = 300
REF_PROCS = 3            # JAX subprocesses, the cells dealt among them
#: a reference cell's compile and run time in units of a 2-layer cell's
#: (jamba's superblock is 8 layers)
REF_WEIGHT = {"jamba_v0_1_52b": 4}


def cell_id(cell):
    arch, mesh, kind, accum = cell
    return f"{arch}-{mesh}-{kind}" + (f"-accum{accum}" if accum > 1 else "")


def t_cfg(arch):
    return dataclasses.replace(get_smoke_config(arch), dtype=torch.float32,
                               fsdp=get_config(arch).fsdp,
                               **OVERRIDES.get(arch, {}))


def r_cfg(arch):
    return dataclasses.replace(r_smoke(arch), dtype=jnp.float32,
                               fsdp=r_config(arch).fsdp,
                               **OVERRIDES.get(arch, {}))


def batch_np(cfg, kind):
    """tests/test_torch_train.py's batch at B = 4, T = 16 (a fifth of the
    labels masked); a prefill batch has no labels."""
    rng = np.random.default_rng(0)
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
    if kind == "prefill":
        del b["labels"]
    return b


def seq_len(cfg, b):
    """The cell shape's seq_len, as ``steps.shard_batch`` derives it."""
    if cfg.frontend == "audio_frames":
        return b["frames"].shape[1]
    return b["tokens"].shape[1] + (b["vision_embeds"].shape[1]
                                   if "vision_embeds" in b else 0)


REFERENCE = r"""
import dataclasses, json, sys
import numpy as np
import repro.launch.steps as steps
import jax, jax.numpy as jnp
from repro.configs import get_config, get_smoke_config
from repro.configs.registry import Shape
from repro.launch.dryrun import _jit_for_cell
from repro.launch.mesh import make_mesh
from repro.optim import AdamWConfig, adamw_init

cells, meshes, overrides, ocfg = (json.loads(a) for a in sys.argv[3:7])
d = np.load(sys.argv[2])
out = {}
for arch, mesh_name, kind, accum, cid in cells:
    cfg = dataclasses.replace(get_smoke_config(arch), dtype=jnp.float32,
                              fsdp=get_config(arch).fsdp,
                              **overrides.get(arch, {}))
    shape, axes = meshes[mesh_name]
    n = int(np.prod(shape))
    mesh = make_mesh(tuple(shape), tuple(axes), devices=jax.devices()[:n])
    cfg = steps.prepare_config(cfg, mesh)
    pre = f"in/{arch}/params/"
    params = {}
    for k in d.files:
        if k.startswith(pre):
            node = params
            parts = k[len(pre):].split("/")
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = jnp.asarray(d[k])
    bpre = f"in/{arch}/{kind}/batch/"
    batch = {k[len(bpre):]: jnp.asarray(d[k]) for k in d.files
             if k.startswith(bpre)}
    shp = Shape(cid, kind, int(d[f"in/{arch}/{kind}/seq_len"]),
                int(batch["tokens"].shape[0]))
    with mesh:
        jfn, _ = _jit_for_cell(cfg, shp, mesh, AdamWConfig(**ocfg),
                               accum=accum)
        if kind == "train":
            p2, o2, met = jfn(params, adamw_init(params), batch)
            for name, tree in (("p", p2), ("m", o2["m"]), ("v", o2["v"])):
                for path, leaf in jax.tree_util.tree_leaves_with_path(tree):
                    key = "/".join(str(e.key) for e in path)
                    out[f"{cid}/{name}/{key}"] = np.asarray(leaf)
            for k, v in met.items():
                out[f"{cid}/met/{k}"] = np.asarray(v)
        else:
            out[f"{cid}/logits"] = np.asarray(jfn(params, batch))
np.savez(sys.argv[1], **out)
"""


# ---------------------------------------------------------------------------
# The ranks
# ---------------------------------------------------------------------------

def _inputs(d, arch, kind):
    params = unflat(d, f"in/{arch}/params/")
    batch = {k: d[f"in/{arch}/{kind}/batch/{k}"] for k in
             unflat(d, f"in/{arch}/{kind}/batch/")}
    return params, batch


#: what each rank records where "model" computes in parallel: (module,
#: function, the positional arguments whose shapes are kept)
RECORDED = ((lm, "_apply_layer", (4,)), (whisper, "_enc_block", (2,)),
            (whisper, "_dec_block", (2,)), (ops, "flash_attention", (0, 1)),
            (ssm, "ssd_chunked", (0,)))


def _recorded(cid, out, fn):
    """``fn()`` with the calls of :data:`RECORDED` noting their argument
    shapes in ``out[cid/rec/<function>]`` (distinct shapes, in order)."""
    saved = []
    for mod, name, args in RECORDED:
        real = getattr(mod, name)
        seen = []

        def wrap(*a, _real=real, _seen=seen, _args=args, **kw):
            shapes = tuple(tuple(a[i].shape) for i in _args)
            if shapes not in _seen:
                _seen.append(shapes)
            return _real(*a, **kw)
        setattr(mod, name, wrap)
        saved.append((mod, name, real, seen))
    try:
        return fn()
    finally:
        for mod, name, real, seen in saved:
            setattr(mod, name, real)
            if seen:
                out[f"{cid}/rec/{name}"] = np.array(seen)


def comm_figures(comm):
    """A comm's calls by kind, then its gathered and reduced bytes."""
    return np.array([comm.calls[k] for k in COMM_KINDS]
                    + [comm.bytes["gathered"], comm.bytes["reduced"]])


def counted_comm(cfg, kind, seq, accum, mesh_name, rank):
    """``comm_figures`` of the dry run's trace of the cell's step on
    ``rank`` (``meta_trace.CountingComm``), its batch in the config's
    dtype as the ranks' is."""
    tmpl = t_mesh.Mesh(MESHES[mesh_name][1], MESHES[mesh_name][0])
    mesh, comm = dryrun.rank_mesh(tmpl, rank)
    step, args = dryrun.step_and_args(
        cfg, types.SimpleNamespace(kind=kind, global_batch=B, seq_len=seq),
        mesh, accum=accum)
    batch = args[-1]
    for k, v in batch.items():
        if isinstance(v, steps.StoredLeaf):
            v.shard = v.shard.to(cfg.dtype)
        elif v.is_floating_point():
            batch[k] = v.to(cfg.dtype)
    meta_trace.trace(step, args, cost=False)
    return comm_figures(comm)


def _run_cell(cell, d, comm, out):
    arch, mesh_name, kind, accum = cell
    out[f"{cell_id(cell)}/comm_counted"] = counted_comm(
        t_cfg(arch), kind, int(d[f"in/{arch}/{kind}/seq_len"]), accum,
        mesh_name, comm.rank)
    if MESHES[cell[1]][0][-1] > 1:
        return _recorded(cell_id(cell), out,
                         lambda: _run_cell_inner(cell, d, comm, out))
    return _run_cell_inner(cell, d, comm, out)


def _run_cell_inner(cell, d, comm, out):
    arch, mesh_name, kind, accum = cell
    cid = cell_id(cell)
    cfg = t_cfg(arch)
    mesh = t_mesh.make_mesh(*MESHES[mesh_name], comm=comm)
    tree, batch = _inputs(d, arch, kind)
    full = steps.model_module(cfg).params_from_numpy(cfg, tree)
    b = steps.shard_batch(cfg, batch, mesh)
    before = comm_figures(comm)
    if kind == "prefill":
        params = t_mesh.shard_tree(full, steps.param_and_opt_specs(
            cfg, mesh)[0], mesh)
        out[f"{cid}/logits"] = steps.build_prefill_step(cfg, mesh=mesh)(
            params, b).numpy()
        out[f"{cid}/comm_real"] = comm_figures(comm) - before
        return
    params, opt = steps.shard_state(cfg, full, mesh)
    del full
    step = steps.build_train_step(cfg, AdamWConfig(**OCFG), accum=accum,
                                  mesh=mesh)
    params, opt, met = step(params, opt, b)
    out[f"{cid}/comm_real"] = comm_figures(comm) - before
    for k, v in met.items():
        out[f"{cid}/met/{k}"] = v.numpy()
    for name, t in (("p", params), ("m", opt["m"]), ("v", opt["v"])):
        out.update(flat(t, f"{cid}/{name}/"))
    out[f"{cid}/bytes_params"] = np.array(sum(
        t.nbytes for _p, t in tree_leaves(params)))
    out[f"{cid}/bytes_opt"] = np.array(
        sum(t.nbytes for name in ("m", "v")
            for _p, t in tree_leaves(opt[name])) + opt["count"].nbytes)


def _collective_checks(mesh, out):
    """Value and gradient of each autograd collective of ``mesh.tp`` and
    of the vocabulary-parallel cross-entropy against one process's
    functions on the same inputs (every rank draws all ranks' inputs from
    one seed).  The largest absolute error of each goes to
    ``out["coll/<name>"]``, beside ``out["coll/<name>/scale"]``."""
    tp = mesh.tp
    m, j = tp.size, tp.index
    g = torch.Generator().manual_seed(7)

    def rnd(*shape):
        return torch.randn(shape, generator=g, dtype=torch.float64).float()

    def note(name, got, want):
        out[f"coll/{name}"] = np.array(float((got - want).abs().max()))
        out[f"coll/{name}/scale"] = np.array(float(want.abs().max()))

    b, T, d = 2, 8, 6
    xs = [rnd(b, T // m, d) for _ in range(m)]          # the ranks' parts
    ws = [rnd(b, T, d) for _ in range(m)]               # their upstream
    x = xs[j].clone().requires_grad_(True)
    calls = dict(mesh.comm.calls)
    y = tp.gather_seq(x)
    (y * ws[j]).sum().backward()
    out["calls/gather_seq"] = np.array(
        [mesh.comm.calls[k] - calls[k] for k in COMM_KINDS])
    note("gather_seq", y, torch.cat(xs, 1))
    note("gather_seq/grad", x.grad, tp.own(sum(ws)))

    ps = [rnd(b, T, d) for _ in range(m)]               # partial sums
    vs = [rnd(b, T // m, d) for _ in range(m)]
    x = ps[j].clone().requires_grad_(True)
    calls = dict(mesh.comm.calls)
    y = tp.scatter_seq(x)
    (y * vs[j]).sum().backward()
    out["calls/scatter_seq"] = np.array(
        [mesh.comm.calls[k] - calls[k] for k in COMM_KINDS])
    note("scatter_seq", y, tp.own(sum(ps)))
    note("scatter_seq/grad", x.grad, torch.cat(vs, 1))

    w = rnd(b, d)
    x = ps[j][:, 0].clone().requires_grad_(True)
    y = tp.reduce(x)
    (y * w).sum().backward()
    note("reduce", y, sum(p[:, 0] for p in ps))
    note("reduce/grad", x.grad, w)

    x = ps[0][:, 0].clone().requires_grad_(True)
    y = tp.copy(x)
    (y * vs[j][:, 0]).sum().backward()
    note("copy", y, ps[0][:, 0])
    note("copy/grad", x.grad, sum(v[:, 0] for v in vs))

    note("max", tp.max(ps[j]), torch.stack(ps).amax(0))

    # the vocabulary-parallel cross-entropy (4 chunks), from the ranks'
    # parts of the sequence, against one process's chunked_ce
    V = 12
    cfg = types.SimpleNamespace(vocab_size=V)
    xf, u = rnd(b, T, d), rnd(d, V)
    labels = torch.randint(V, (b, T), generator=g)
    labels[:, ::3] = -1
    xw = xf.clone().requires_grad_(True)
    uw = u.clone().requires_grad_(True)
    want = lm.chunked_ce(xw, uw, labels, chunk=2)
    (want[0] + want[1]).backward()
    for kind, unembed in (("split", tp.own(u, 1)), ("whole", u)):
        x = tp.own(xf).clone().requires_grad_(True)
        uu = unembed.clone().requires_grad_(True)
        got = lm.sequence_ce(cfg, x, uu, labels, tp, chunk=2)
        (got[0] + got[1]).backward()
        note(f"ce_{kind}", torch.stack(got), torch.stack(want).detach())
        note(f"ce_{kind}/grad_x", x.grad, tp.own(xw.grad))
        want_u = tp.own(uw.grad, 1) if kind == "split" else uw.grad
        # a whole unembedding's gradient is the rank's rows' part
        got_u = uu.grad if kind == "split" else tp.reduce(uu.grad)
        note(f"ce_{kind}/grad_unembed", got_u, want_u)


#: (layer, arch whose smoke config it takes, T) of :func:`_layer_checks`
LAYERS = (("attention", "qwen3_14b", 8), ("mlp_gelu", "starcoder2_3b", 8),
          ("mlp_swiglu", "qwen3_14b", 8), ("mamba", "mamba2_130m", 32),
          ("moe", "llama4_scout_17b_a16e", 8))


def _rank_part(name, p, m, j):
    """The rank's "model" shard of a layer's parameters where the plan
    splits them (heads, MLP columns / rows, experts, SSD heads' rows of
    ``out_proj``)."""
    def cut(t, dim):
        n = t.shape[dim] // m
        return t.narrow(dim, j * n, n)
    if name == "attention":
        return dict(p, **{w: cut(p[w], 1) for w in ("wq", "wk", "wv")},
                    wo=cut(p["wo"], 0))
    if name.startswith("mlp"):
        return dict(p, **{w: cut(p[w], 1) for w in ("wi", "wg") if w in p},
                    wo=cut(p["wo"], 0))
    if name == "mamba":
        return dict(p, out_proj=cut(p["out_proj"], 0))
    return dict(p, **{w: cut(p[w], 0) for w in ("wi", "wg", "wo")},
                shared=_rank_part("mlp", p["shared"], m, j))


def _layer_checks(mesh, out):
    """Each block under ``mesh.tp`` on the rank's part of the sequence,
    with the rank's split parameters and with whole ones, against one
    process's block on the whole sequence: the rank's rows of the output,
    its part of the input's gradient, a split parameter's gradient slice
    and the sum over "model" of a whole parameter's.  The largest
    absolute error of each goes to ``out["layer/<layer>/<split|whole>/
    <what>"]`` beside its ``/scale``."""
    from repro_torch.models import attention as attn_mod, common
    tp = mesh.tp
    m, j = tp.size, tp.index

    def note(key, got, want):
        out[key] = np.array(float((got - want).abs().max()))
        out[f"{key}/scale"] = np.array(float(want.abs().max()))

    for name, arch, T in LAYERS:
        cfg = dataclasses.replace(get_smoke_config(arch),
                                  dtype=torch.float32)
        g = torch.Generator().manual_seed(11)
        layer = lm.init_params(cfg, seed=3)["layers"]["pos0"]
        p = {"attention": layer.get("attn"), "moe": layer.get("moe"),
             "mamba": layer.get("ssm")}.get(name, layer.get("mlp"))
        p = {k: (v[0] if not isinstance(v, dict) else
                 {kk: vv[0] for kk, vv in v.items()}) for k, v in p.items()}
        if name == "mlp_gelu":
            cfg = dataclasses.replace(cfg, mlp="gelu")
        x = torch.randn(2, T, cfg.d_model, generator=g)
        w = torch.randn(2, T, cfg.d_model, generator=g)
        pos = torch.arange(T).expand(2, T)

        def run(params, xx, tpp):
            if name == "attention":
                return attn_mod.attention(cfg, params, xx, pos, tp=tpp), 0
            if name.startswith("mlp"):
                return common.apply_mlp(cfg, params, xx, tp=tpp), 0
            if name == "mamba":
                return ssm.mamba_block(cfg, params, xx, tp=tpp)[0], 0
            return moe.apply_moe(cfg, params, xx, tp=tpp)

        def leaves(params):
            return dict(tree_leaves(params))

        full = {k: v.clone().requires_grad_(True)
                for k, v in leaves(p).items()}
        xf = x.clone().requires_grad_(True)
        y, aux = run(_unflat_tree(full), xf, None)
        ((y * w).sum() + 0.5 * aux).backward()
        for mode in ("split", "whole"):
            mine = {k: v.detach().clone().requires_grad_(True)
                    for k, v in leaves(_rank_part(name, p, m, j)
                                       if mode == "split" else p).items()}
            xr = tp.own(x).clone().requires_grad_(True)
            yr, aux_r = run(_unflat_tree(mine), xr, tp)
            ((yr * tp.own(w)).sum() + 0.5 * aux_r / m).backward()
            key = f"layer/{name}/{mode}"
            note(f"{key}/out", yr, tp.own(y).detach())
            note(f"{key}/grad_x", xr.grad, tp.own(xf.grad))
            for k, t in mine.items():
                want = full[k].grad
                if t.shape == want.shape:
                    got = tp.reduce(t.grad)
                else:
                    got = t.grad
                    dim = next(d for d, (a, b) in enumerate(
                        zip(t.shape, want.shape)) if a != b)
                    want = want.narrow(dim, j * got.shape[dim],
                                       got.shape[dim])
                note(f"{key}/grad/{'/'.join(k)}", got, want)


def _unflat_tree(flat):
    out = {}
    for path, v in flat.items():
        node = out
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = v
    return out


def _checkpoint_runs(comm, root, out):
    """Two steps on (data=2, model=2) with a checkpoint every 2, then a
    resume of step 2 on (data=4); rank 0 keeps a copy of step 2 for the
    single process's resume."""
    kw = dict(steps=4, batch=B, seq=T, device="cpu", comm=comm)
    first = root / "ckpt"
    out["ckpt_a"] = np.array(t_train.train(
        CKPT_ARCH, mesh_spec="data=2,model=2", ckpt_dir=str(first),
        ckpt_every=2, **kw))
    if comm.rank == 0:
        shutil.rmtree(first / "step_4")
        shutil.copytree(first, root / "ckpt_step2")
    comm.barrier()
    out["ckpt_b"] = np.array(t_train.train(
        CKPT_ARCH, mesh_spec="data=4,model=1", ckpt_dir=str(first),
        ckpt_every=2, **kw))


def _rank_main(rank, mesh_name, store, inputs, out_dir):
    torch.set_num_threads(1)
    n = int(np.prod(MESHES[mesh_name][0]))
    comm = DistributedComm("gloo", rank=rank, world_size=n,
                           init_method=f"file://{store}", device="cpu",
                           timeout=RANK_TIMEOUT)
    out = {}
    try:
        d = dict(np.load(inputs))
        for cell in CELLS:
            if cell[1] == mesh_name:
                _run_cell(cell, d, comm, out)
        if MESHES[mesh_name][0][-1] > 1:
            mesh = t_mesh.make_mesh(*MESHES[mesh_name], comm=comm)
            _collective_checks(mesh, out)
            _layer_checks(mesh, out)
        if mesh_name == "data4":
            try:
                t_mesh.make_mesh((2, 2, 2), ("pod", "data", "model"),
                                 comm=comm)
                out["size_error"] = np.array("")
            except ValueError as e:
                out["size_error"] = np.array(str(e))
        if mesh_name == "data4":      # the lighter 4-rank spawn
            _checkpoint_runs(comm, Path(out_dir), out)
        np.savez(Path(out_dir) / f"{mesh_name}_rank{rank}.npz", **out)
    finally:
        comm.close()


def _rank_peer_exits(rank, store, timeout_s):
    torch.set_num_threads(1)
    comm = DistributedComm(
        "gloo", rank=rank, world_size=2, init_method=f"file://{store}",
        device="cpu", timeout=datetime.timedelta(seconds=timeout_s))
    if rank == 1:
        return                  # exits without a step
    try:
        cfg = t_cfg("qwen3_14b")
        mesh = t_mesh.make_mesh((2, 1), ("data", "model"), comm=comm)
        full = steps.model_module(cfg).init_params(cfg, 0)
        params, opt = steps.shard_state(cfg, full, mesh)
        b = steps.shard_batch(cfg, batch_np(cfg, "train"), mesh)
        steps.build_train_step(cfg, AdamWConfig(**OCFG), mesh=mesh)(
            params, opt, b)
    finally:
        comm.close()


# ---------------------------------------------------------------------------
# Fixtures
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Write the inputs, start the JAX subprocesses and the three
    spawns together and run the single-process steps meanwhile; return
    (reference outputs, inputs, {mesh: [rank outputs]}, the run's
    directory, single-process outputs)."""
    d = tmp_path_factory.mktemp("torch_dist_train")
    inputs = {}
    for arch in ARCHS:
        rc = r_cfg(arch)
        rp = r_steps.model_module(rc).init_params(rc, jax.random.PRNGKey(1))
        inputs.update(flat(jax.tree.map(lambda a: np.asarray(a, np.float32),
                                        rp), f"in/{arch}/params/"))
        for kind in ("train", "prefill"):
            b = batch_np(t_cfg(arch), kind)
            inputs.update({f"in/{arch}/{kind}/batch/{k}": v
                           for k, v in b.items()})
            inputs[f"in/{arch}/{kind}/seq_len"] = np.array(
                seq_len(t_cfg(arch), b))
    np.savez(d / "inputs.npz", **inputs)
    env = dict(os.environ, PYTHONPATH=str(SRC), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    cells = [list(c) + [cell_id(c)] for c in CELLS]
    refs = []
    for i, part in enumerate(_deal(cells, REF_PROCS)):
        refs.append(subprocess.Popen(
            [sys.executable, "-c", REFERENCE, str(d / f"ref{i}.npz"),
             str(d / "inputs.npz"), json.dumps(part), json.dumps(MESHES),
             json.dumps(OVERRIDES), json.dumps(OCFG)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True))
    try:
        ctxs = [_spawn(_rank_main, int(np.prod(shape)),
                       (name, str(d / f"store_{name}"),
                        str(d / "inputs.npz"), str(d)))
                for name, (shape, _axes) in MESHES.items()]
        single = single_process(inputs)
        _join(ctxs, SPAWN_SECONDS)
        outs = [r.communicate(timeout=600) for r in refs]
    finally:
        for r in refs:
            if r.poll() is None:
                r.kill()
                r.communicate()
    for r, (o, e) in zip(refs, outs):
        assert r.returncode == 0, f"stdout:\n{o}\nstderr:\n{e[-4000:]}"
    ref = {}
    for i in range(REF_PROCS):
        ref.update(dict(np.load(d / f"ref{i}.npz")))
    ranks = {name: [dict(np.load(d / f"{name}_rank{r}.npz"))
                    for r in range(int(np.prod(shape)))]
             for name, (shape, _axes) in MESHES.items()}
    return ref, dict(np.load(d / "inputs.npz")), ranks, d, single


def _deal(cells, n):
    """``cells`` in ``n`` parts of about equal :data:`REF_WEIGHT`."""
    return deal(cells, n, REF_WEIGHT)


def single_process(inputs):
    """The port's single-process step on the whole batch, per cell, and
    the choices each MoE cell dropped (one intra-op thread, as a rank:
    the ranks and the JAX subprocesses run meanwhile)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return _single_process(inputs)
    finally:
        torch.set_num_threads(threads)


def _single_process(inputs):
    out = {}
    for cell in CELLS:
        arch, _mesh, kind, accum = cell
        cid = cell_id(cell)
        cfg = t_cfg(arch)
        tree, batch = _inputs(inputs, arch, kind)
        params = steps.model_module(cfg).params_from_numpy(cfg, tree)
        if kind == "prefill":
            out[f"{cid}/logits"] = steps.build_prefill_step(cfg)(
                params, batch).numpy()
            continue
        dropped = []
        real = moe.dispatch

        def counted(*a, **kw):
            res = real(*a, **kw)
            dropped.append(int((~res[1]).sum()))
            return res
        moe.dispatch = counted
        try:
            p2, opt, met = steps.build_train_step(
                cfg, AdamWConfig(**OCFG), accum=accum)(
                    params, adamw_init(params), batch)
        finally:
            moe.dispatch = real
        out[f"{cid}/dropped"] = sum(dropped)
        for k, v in met.items():
            out[f"{cid}/met/{k}"] = v.numpy()
        for name, t in (("p", p2), ("m", opt["m"]), ("v", opt["v"])):
            out.update(flat(t, f"{cid}/{name}/"))
    return out


@pytest.fixture(scope="module")
def single(runs):
    return runs[4]


def rank_mesh(mesh_name, rank):
    """The mesh record at ``rank``'s coordinates (no process group), to
    cut a full reference array to that rank's shard."""
    shape, axes = MESHES[mesh_name]
    return t_mesh.Mesh(axes, shape,
                       comm=types.SimpleNamespace(rank=rank))


TRAIN = [c for c in CELLS if c[2] == "train"]


def check_train(got, want, cell, rank, what):
    """One rank's metrics and shards against a full-tree result ``want``
    (the reference's or the single process's)."""
    arch, mesh_name, _kind, _accum = cell
    cid = cell_id(cell)
    cfg = t_cfg(arch)
    m = rank_mesh(mesh_name, rank)
    p_specs, o_specs = steps.param_and_opt_specs(cfg, m)
    for k in ("loss", "grad_norm", "ce", "aux", "zloss"):
        np.testing.assert_allclose(
            float(got[f"{cid}/met/{k}"]), float(want[f"{cid}/met/{k}"]),
            rtol=1e-4, atol=1e-7, err_msg=f"{what} {cid} rank {rank} {k}")
    for name, specs in (("m", o_specs["m"]), ("v", o_specs["v"])):
        for path, spec in tree_leaves(specs):
            key = f"{cid}/{name}/" + "/".join(path)
            full = np.asarray(want[key], np.float32)
            t = 1e-3 * max(float(np.abs(full).max()), 1e-30)
            np.testing.assert_allclose(
                got[key], m.cut(full, spec), rtol=0, atol=t,
                err_msg=f"{what} {key} rank {rank}")
    for path, spec in tree_leaves(p_specs):
        rest = "/".join(path)
        key = f"{cid}/p/{rest}"
        wp = m.cut(np.asarray(want[key], np.float32), spec)
        mfull = np.abs(np.asarray(want[f"{cid}/m/{rest}"], np.float32))
        g = m.cut(mfull, spec)
        tol = np.where(g > 1e-3 * mfull.max(),
                       1e-5 * np.maximum(1.0, np.abs(wp)), 2.5 * LR)
        assert (np.abs(got[key] - wp) <= tol).all(), \
            (what, key, rank, float(np.abs(got[key] - wp).max()))


# ---------------------------------------------------------------------------
# The train and prefill steps
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cell", TRAIN, ids=cell_id)
def test_train_step_matches_reference_sharded_step(runs, cell):
    """Every rank's metrics and updated parameter and moment shards equal
    the matching slices of the reference's ``_jit_for_cell`` step on the
    same mesh."""
    ref, _inputs_, ranks, _d, _s = runs
    for rank, got in enumerate(ranks[cell[1]]):
        check_train(got, ref, cell, rank, "reference")


@pytest.mark.parametrize("cell", TRAIN, ids=cell_id)
def test_train_step_matches_single_process(runs, single, cell,
                                           record_property):
    ref, _inputs_, ranks, _d, _s = runs
    cid = cell_id(cell)
    got0 = ranks[cell[1]][0]
    record_property("bit_equal_loss", bool(
        float(got0[f"{cid}/met/loss"]) == float(single[f"{cid}/met/loss"])))
    for rank, got in enumerate(ranks[cell[1]]):
        check_train(got, single, cell, rank, "single process")


@pytest.mark.parametrize("cell", [c for c in TRAIN if c[0] == MOE],
                         ids=cell_id)
def test_moe_cells_drop_choices(single, cell):
    """llama4-scout at capacity factor 0.5 drops choices at the global
    capacity, so the global slots and counts are exercised."""
    assert single[f"{cell_id(cell)}/dropped"] > 0


@pytest.mark.parametrize("cell", [c for c in CELLS if c[2] == "prefill"],
                         ids=cell_id)
def test_prefill_returns_global_logits(runs, single, cell):
    """Every rank returns the reference's (and the single process's)
    [B, V] last-position logits."""
    ref, _inputs_, ranks, _d, _s = runs
    cid = cell_id(cell)
    for want in (ref[f"{cid}/logits"], single[f"{cid}/logits"]):
        t = 1e-4 * float(np.abs(want).max())
        for rank, got in enumerate(ranks[cell[1]]):
            assert got[f"{cid}/logits"].shape == want.shape
            np.testing.assert_allclose(got[f"{cid}/logits"], want, rtol=0,
                                       atol=t, err_msg=f"rank {rank}")


@pytest.mark.parametrize("cell", TRAIN, ids=cell_id)
def test_resident_bytes_equal_dry_run(runs, cell):
    """Each rank's parameter and moment bytes are the dry run's
    per-device figures for the mesh, and every shard has the dry run's
    shard shape (no full-size copy of a sharded leaf remains)."""
    _ref, inputs, ranks, _d, _s = runs
    arch, mesh_name, kind, _accum = cell
    cid = cell_id(cell)
    cfg = t_cfg(arch)
    shape = types.SimpleNamespace(
        kind="train", global_batch=B,
        seq_len=int(inputs[f"in/{arch}/{kind}/seq_len"]))
    m = t_mesh.Mesh(MESHES[mesh_name][1], MESHES[mesh_name][0])
    want = dryrun.argument_bytes(cfg, shape, m)
    leaves = {leaf.path: leaf.shard_shape(m)
              for leaf in dryrun.cell_leaves(cfg, shape, m)}
    for rank, got in enumerate(ranks[mesh_name]):
        assert int(got[f"{cid}/bytes_params"]) == want["params"], rank
        assert int(got[f"{cid}/bytes_opt"]) == want["opt"], rank
        for key, v in got.items():
            if key.startswith(f"{cid}/p/"):
                path = "params/" + key[len(f"{cid}/p/"):]
            elif key.startswith((f"{cid}/m/", f"{cid}/v/")):
                path = "opt/" + key[len(cid) + 1:]
            else:
                continue
            assert tuple(v.shape) == leaves[path], (rank, path)


@pytest.mark.parametrize("cell", CELLS, ids=cell_id)
def test_counting_comm_equals_the_ranks_counters(runs, cell):
    """The dry run's trace of the cell's step on each rank
    (``meta_trace.CountingComm``, no process group) counts the collectives
    by kind and the gathered and reduced bytes that the rank's
    ``DistributedComm`` counted over the same step."""
    cid = cell_id(cell)
    for rank, got in enumerate(runs[2][cell[1]]):
        assert got[f"{cid}/comm_real"].sum() > 0, rank
        assert list(got[f"{cid}/comm_counted"]) == list(
            got[f"{cid}/comm_real"]), (rank, COMM_KINDS)


TP_CELLS = [c for c in CELLS if MESHES[c[1]][0][-1] > 1]


def expected_records(cell, inputs):
    """What a rank of a tensor-parallel cell records (see
    :data:`RECORDED`): {function: set of argument shape tuples}."""
    arch, mesh_name, kind, accum = cell
    cfg = t_cfg(arch)
    shape, axes = MESHES[mesh_name]
    m = shape[-1]
    rows = B // int(np.prod(shape[:-1])) // accum
    T = int(inputs[f"in/{arch}/{kind}/seq_len"])
    d = cfg.d_model
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim

    def flash(t):
        return ((rows, t, H // m, hd), (rows, t, KV // m, hd))
    if cfg.encdec:
        Td = T // cfg.dec_ratio
        return {"_enc_block": {((rows, T // m, d),)},
                "_dec_block": {((rows, Td // m, d),)},
                "flash_attention": {flash(T), flash(Td)}}
    want = {"_apply_layer": {((rows, T // m, d),)}}
    if "A" in cfg.pattern():
        want["flash_attention"] = {flash(T)}
    if "M" in cfg.pattern():
        want["ssd_chunked"] = {((rows, T, cfg.ssm_heads // m,
                                 cfg.ssm_head_dim),)}
    return want


@pytest.mark.parametrize("cell", TP_CELLS, ids=cell_id)
def test_ranks_compute_on_model_shards(runs, cell):
    """Where "model" has 2 ranks every rank's residual stream between
    blocks is [B / dp, T / model, d], B9 (``ops.flash_attention``) gets
    H / model query and KV / model key / value heads of the whole
    sequence, and ``ssd_chunked`` (B10) H / model SSD heads."""
    _ref, inputs, ranks, _d, _s = runs
    cid = cell_id(cell)
    want = expected_records(cell, inputs)
    for rank, got in enumerate(ranks[cell[1]]):
        rec = {k.split("/")[-1]: {tuple(tuple(int(n) for n in a)
                                        for a in shapes)
                                  for shapes in v}
               for k, v in got.items() if k.startswith(f"{cid}/rec/")}
        assert rec == want, (rank, rec, want)


COLLECTIVES = ("gather_seq", "scatter_seq", "reduce", "copy", "max",
               "ce_split", "ce_whole")
COMM_KINDS = ("all_gather_group", "reduce_scatter", "all_reduce")


@pytest.mark.parametrize("mesh_name",
                         [m for m, (s, _a) in MESHES.items() if s[-1] > 1])
@pytest.mark.parametrize("name", COLLECTIVES)
def test_tensor_parallel_collectives_value_and_gradient(runs, mesh_name,
                                                        name):
    """Each autograd collective of ``TensorParallel`` and the
    vocabulary-parallel cross-entropy (the rank's vocabulary slice, or a
    whole unembedding on the rank's tokens) give one process's value and
    gradient on every rank, within 1e-5 of max(1, max |want|)."""
    for rank, got in enumerate(runs[2][mesh_name]):
        keys = [k for k in got if k == f"coll/{name}"
                or (k.startswith(f"coll/{name}/")
                    and not k.endswith("/scale"))]
        assert len(keys) == (1 if name == "max" else
                             2 if not name.startswith("ce") else 3), keys
        for k in keys:
            err, scale = float(got[k]), float(got[f"{k}/scale"])
            assert err <= 1e-5 * max(1.0, scale), (rank, k, err, scale)


@pytest.mark.parametrize("mesh_name",
                         [m for m, (s, _a) in MESHES.items() if s[-1] > 1])
@pytest.mark.parametrize("name,want", [("gather_seq", (1, 1, 0)),
                                       ("scatter_seq", (1, 1, 0))])
def test_comm_counts_each_collective_once(runs, mesh_name, name, want):
    """``DistributedComm.calls`` counts one gather and one reduce-scatter
    on every rank for a sequence gather and its backward, and for a
    sequence reduce-scatter and its backward."""
    for rank, got in enumerate(runs[2][mesh_name]):
        assert tuple(got[f"calls/{name}"]) == want, (rank, COMM_KINDS,
                                                     got[f"calls/{name}"])


@pytest.mark.parametrize("mesh_name",
                         [m for m, (s, _a) in MESHES.items() if s[-1] > 1])
@pytest.mark.parametrize("mode", ("split", "whole"))
@pytest.mark.parametrize("layer", [name for name, _a, _t in LAYERS])
def test_blocks_on_model_shards_match_one_process(runs, mesh_name, mode,
                                                  layer):
    """Attention, both MLP flavours, the Mamba2 block and the MoE layer
    under ``tp``, with the rank's split parameters and with whole ones
    (the plan's "gathered" leaves: counts "model" does not divide), give
    one process's output rows and gradients on every rank, within 1e-5
    of max(1, max |want|)."""
    for rank, got in enumerate(runs[2][mesh_name]):
        keys = [k for k in got if k.startswith(f"layer/{layer}/{mode}/")
                and not k.endswith("/scale")]
        assert len(keys) >= 3, keys
        for k in keys:
            err, scale = float(got[k]), float(got[f"{k}/scale"])
            assert err <= 1e-5 * max(1.0, scale), (rank, k, err, scale)


@pytest.mark.parametrize("rank", range(4))
def test_pipeline_keeps_the_ranks_shard_of_the_global_draw(rank):
    """Under a mesh every rank draws the global batch from (seed, step),
    as one process does, and keeps the shard its batch specs name: its dp
    rows, and whisper's frames also cut along time over "model"."""
    from repro_torch.data import DataConfig, make_batch, make_pipeline
    cfg = t_cfg("whisper_large_v3")
    m = rank_mesh("data2_model2", rank)
    dcfg = DataConfig(seed=3, vocab_size=cfg.vocab_size, batch=B, seq_len=T,
                      frontend=cfg.frontend, d_model=cfg.d_model,
                      dec_ratio=cfg.dec_ratio)
    pipe = make_pipeline(dcfg, device="cpu", start_step=5,
                         shard=lambda b: steps.shard_batch(cfg, b, m))
    try:
        got = next(pipe)
    finally:
        pipe.close()
    want = make_batch(dcfg, 5)
    data, model = m.coords["data"], m.coords["model"]
    rows = slice(data * B // 2, (data + 1) * B // 2)
    for k in ("tokens", "labels"):
        assert torch.equal(got[k], torch.from_numpy(want[k][rows]))
    frames = got["frames"]
    assert isinstance(frames, steps.StoredLeaf)
    assert torch.equal(frames.shard, torch.from_numpy(
        want["frames"][rows, model * T // 2:(model + 1) * T // 2]))


# ---------------------------------------------------------------------------
# Checkpoints and failures
# ---------------------------------------------------------------------------

def test_checkpoint_resumes_on_another_mesh_and_in_one_process(runs):
    """A checkpoint written at step 2 on (data=2, model=2) resumes on
    (data=4) and in one process; the later losses equal the
    uninterrupted run's."""
    _ref, _inputs_, ranks, d, _s = runs
    kw = dict(steps=4, batch=B, seq=T, device="cpu")
    full = t_train.train(CKPT_ARCH, **kw)
    one = t_train.train(CKPT_ARCH, ckpt_dir=str(d / "ckpt_step2"),
                        ckpt_every=2, **kw)
    for got in ranks["data4"]:
        np.testing.assert_allclose(got["ckpt_a"], full, rtol=1e-3)
        np.testing.assert_allclose(got["ckpt_b"], full[2:], rtol=1e-3)
    np.testing.assert_allclose(one, full[2:], rtol=1e-3)
    assert len(one) == 2 and full[-1] < full[0]


def test_mesh_size_must_match_the_comm(runs):
    for got in runs[2]["data4"]:
        assert "a comm of 4 ranks" in str(got["size_error"])
    with pytest.raises(ValueError, match="DistributedComm"):
        t_mesh.make_mesh((2, 2), ("data", "model"), device="cpu")


def test_rank_whose_peer_exits_fails_within_its_timeout(tmp_path):
    """Rank 1 exits after joining; rank 0's train step fails at its first
    collective instead of waiting for ever (timeout 5 s)."""
    t0 = time.monotonic()
    ctx = _spawn(_rank_peer_exits, 2, (str(tmp_path / "store"), 5))
    with pytest.raises(mp.ProcessRaisedException):
        _join([ctx], 120)
    assert time.monotonic() - t0 < 60
