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
``(data=2, model=2)`` and ``(pod=2, data=2, model=2)``.

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

from repro.configs import get_config as r_config
from repro.configs import get_smoke_config as r_smoke
from repro.launch import steps as r_steps
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core.comm import DistributedComm
from repro_torch.launch import dryrun, mesh as t_mesh, steps
from repro_torch.launch import train as t_train
from repro_torch.models import moe
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
         "llama4_scout_17b_a16e", "qwen2_vl_72b", "whisper_large_v3")
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


def flat(tree, prefix=""):
    return {prefix + "/".join(p): np.asarray(v) for p, v in tree_leaves(tree)}


def unflat(d, prefix):
    out = {}
    for k, v in d.items():
        if not k.startswith(prefix):
            continue
        node = out
        parts = k[len(prefix):].split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return out


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


def _run_cell(cell, d, comm, out):
    arch, mesh_name, kind, accum = cell
    cid = cell_id(cell)
    cfg = t_cfg(arch)
    mesh = t_mesh.make_mesh(*MESHES[mesh_name], comm=comm)
    tree, batch = _inputs(d, arch, kind)
    full = steps.model_module(cfg).params_from_numpy(cfg, tree)
    b = steps.shard_batch(cfg, batch, mesh)
    if kind == "prefill":
        params = t_mesh.shard_tree(full, steps.param_and_opt_specs(
            cfg, mesh)[0], mesh)
        out[f"{cid}/logits"] = steps.build_prefill_step(cfg, mesh=mesh)(
            params, b).numpy()
        return
    params, opt = steps.shard_state(cfg, full, mesh)
    del full
    step = steps.build_train_step(cfg, AdamWConfig(**OCFG), accum=accum,
                                  mesh=mesh)
    params, opt, met = step(params, opt, b)
    for k, v in met.items():
        out[f"{cid}/met/{k}"] = v.numpy()
    for name, t in (("p", params), ("m", opt["m"]), ("v", opt["v"])):
        out.update(flat(t, f"{cid}/{name}/"))
    out[f"{cid}/bytes_params"] = np.array(sum(
        t.nbytes for _p, t in tree_leaves(params)))
    out[f"{cid}/bytes_opt"] = np.array(
        sum(t.nbytes for name in ("m", "v")
            for _p, t in tree_leaves(opt[name])) + opt["count"].nbytes)


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


def _join(ctxs, seconds):
    deadline = time.monotonic() + seconds
    pending = list(ctxs)
    while pending:
        pending = [c for c in pending if not c.join(timeout=0.2)]
        if pending and time.monotonic() > deadline:
            for c in pending:
                for p in c.processes:
                    p.kill()
            pytest.fail(f"ranks still running after {seconds} s")


def _spawn(fn, nprocs, args):
    return mp.start_processes(fn, args=args, nprocs=nprocs, join=False,
                              start_method="spawn")


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
    for i in range(REF_PROCS):
        part = cells[i::REF_PROCS]
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
