"""The decode step and the serve entry point on a mesh of ranks
(``launch/steps.py``'s ``build_serve_step(cfg, mesh=)``,
``shard_decode_state``, ``launch/serve.py`` with a mesh) held against
the reference's sharded decode program and against the port's single
process.

The reference side is the program the reference's dry run lowers for a
decode cell: ``repro.launch.dryrun._jit_for_cell`` of
``steps.prepare_config(cfg, mesh)`` at the cell's batch and length on a
``repro.launch.mesh.make_mesh`` mesh of fake CPU devices, its
``in_shardings`` the resolved parameter specs, ``decode_state_specs``
and the tokens' ``PS(dp, None)``, run in two JAX subprocesses of 8
devices (the cells dealt among them) on real arrays and chained over 4-6
steps, the state donated.  The port runs as gloo ranks on the CPU, one
process per device (a spawn of 4 ranks for ``(data=2, model=2)`` and one
of 8 for ``(pod=2, data=2, model=2)`` and ``(data=2, model=4)``), each
rank with its shards of the same parameters (the reference's
``init_params`` at key 1, carried across with ``params_from_numpy``),
of the same state and its rows of the same tokens.  The state starts at
``pos0`` with the caches below it (and the Mamba2 carries) drawn from a
seed; whisper's cross K / V come from the whole parameters and a seeded
encoder memory, then are cut.  The configs are the float32 smoke configs
with the full config's ``fsdp``.

The cells cover the three layouts of the KV cache (``_cache_spec``):
B over the dp axes with the K / V heads over "model" (a), the slots over
one and over two dp axes where B does not divide them (b; the steps
cross the boundary between two ranks' slots), and head_dim over "model"
where the smoke config's 2 K / V heads do not divide 4 (c); the Mamba2
conv carry's channel layout, a state cut over "model" alone, the
expert-parallel MoE with the global capacity (llama4-scout at its
configured capacity factor, as the single-process decode tests keep it:
ROADMAP C.3), jamba's hybrid superblock, h2o-danube's sliding-window
ring buffer past its wrap, and whisper's cross K / V over the encoder
positions.

Tolerances (PERF.md §2's float32 decode rule): each step's logits within
1e-4 max(1, max |logit|) of the reference's and of one process's; the
state's shards after the last step within 1e-5 max(1, max |want|) of the
matching slices of the reference's state.  Also: every rank's parameter
and state shard shapes and resident bytes equal ``dryrun``'s per-device
figures; under (b) the attention's collectives move fewer bytes a layer
than one rank's shard of that layer's cache; Mamba2's B10
(``ops.ssd_intra_chunk``, its plain version here) runs at chunk 1 on the
rank's heads; ``serve`` on 4 ranks (through torchrun's environment, and
with a comm on the default ``(data=4, model=1)`` mesh) returns one
process's tokens on every rank, or differs first where one process's
top-two logit margin lies within the bf16 decode rule; a mesh whose size
differs from the comm's raises.
"""

import dataclasses
import datetime
import json
import os
import socket
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _torch_mesh_ranks import deal, flat, join, spawn, unflat
from repro.configs import get_config as r_config
from repro.configs import get_smoke_config as r_smoke
from repro.launch import steps as r_steps
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core.comm import DistributedComm
from repro_torch.kernels import ops
from repro_torch.launch import dryrun, meta_trace, mesh as t_mesh, \
    serve as t_serve, steps
from repro_torch.models import attention, lm, whisper
from repro_torch.models.common import tree_leaves, tree_map

SRC = Path(__file__).resolve().parents[1] / "src"
MESHES = {"data2_model2": ((2, 2), ("data", "model")),
          "pod2_data2_model2": ((2, 2, 2), ("pod", "data", "model")),
          "data2_model4": ((2, 4), ("data", "model"))}
#: the spawns: ranks -> the meshes they run
SPAWNS = {4: ("data2_model2",), 8: ("pod2_data2_model2", "data2_model4")}
# (arch, mesh, B, S, pos0, steps): S the cell's length (the encoder
# memory's for whisper), pos0 the first step's position
CELLS = [("qwen3_14b", "data2_model2", 4, 32, 13, 4),
         ("qwen3_14b", "data2_model2", 1, 64, 30, 5),
         ("qwen3_14b", "pod2_data2_model2", 2, 64, 14, 5),
         ("qwen3_14b", "data2_model4", 4, 32, 13, 4),
         ("mamba2_130m", "data2_model2", 4, 32, 9, 4),
         ("mamba2_130m", "data2_model2", 1, 32, 9, 4),
         ("llama4_scout_17b_a16e", "data2_model2", 4, 32, 13, 4),
         ("jamba_v0_1_52b", "data2_model2", 1, 32, 14, 4),
         ("h2o_danube_1_8b", "data2_model2", 1, 32, 13, 6),
         ("whisper_large_v3", "data2_model2", 1, 16, 6, 4)]
ARCHS = sorted({c[0] for c in CELLS})
SERVE = dict(arch="qwen3_14b", batch=4, prompt_len=4, gen_len=5, seed=3)
RANK_TIMEOUT = datetime.timedelta(seconds=60)
SPAWN_SECONDS = 300
REF_PROCS = 2
REF_WEIGHT = {"jamba_v0_1_52b": 4}


@pytest.fixture(autouse=True)
def one_thread():
    """Many small products: one intra-op thread a test process keeps the
    ranks and the parallel test workers from thrashing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def cell_id(cell):
    arch, mesh, B, S, _pos0, _n = cell
    return f"{arch}-{mesh}-B{B}-S{S}"


def t_cfg(arch):
    return dataclasses.replace(get_smoke_config(arch), dtype=torch.float32,
                               fsdp=get_config(arch).fsdp)


def r_cfg(arch):
    return dataclasses.replace(r_smoke(arch), dtype=jnp.float32,
                               fsdp=r_config(arch).fsdp)


def shape_of(cell):
    return steps.decode_shape(cell[2], cell[3])


def layout(cell):
    """The cache layout the cell exercises: (a) KV over "model", (b) the
    slots over the dp axes, (c) head_dim over "model"."""
    arch, mesh_name, B, *_ = cell
    cfg = t_cfg(arch)
    m = t_mesh.Mesh(MESHES[mesh_name][1], MESHES[mesh_name][0])
    out = set()
    if "A" in cfg.pattern() or cfg.encdec:
        spec = steps._cache_spec(cfg, shape_of(cell), m)
        out.add("a" if spec[3] is not None else "c")
        if spec[2] is not None:
            out.add("b")
    return out


@torch.inference_mode()
def initial_state(cell, params):
    """The cell's whole state at ``pos0`` (float32 tensors): the caches
    below ``pos0`` and the Mamba2 carries drawn from a seed; whisper's
    cross K / V from the whole parameters and a seeded memory."""
    arch, _mesh, B, S, pos0, _n = cell
    cfg = t_cfg(arch)
    g = torch.Generator().manual_seed(5)
    if cfg.encdec:
        memory = torch.randn(B, S, cfg.d_model, generator=g)
        state = whisper.init_decode_state(cfg, params, B,
                                          steps.WHISPER_MAX_DEC, memory)
        caches = [state["k"], state["v"]]
    else:
        state = lm.init_decode_state(cfg, B, S)
        caches = []
        for path, t in tree_leaves(state["layers"]):
            if path[-1] in ("k", "v"):
                caches.append(t)
            else:
                t.copy_(0.5 * torch.randn(t.shape, generator=g))
    for t in caches:
        n = min(pos0, t.shape[2])
        t[:, :, :n] = torch.randn(t[:, :, :n].shape, generator=g)
    state["pos"] = pos0
    return {k: v for k, v in state.items()}


def cell_tokens(cell):
    arch, _mesh, B, _S, _pos0, n = cell
    rng = np.random.default_rng(11)
    return rng.integers(0, t_cfg(arch).vocab_size, (n, B, 1)).astype(
        np.int32)


REFERENCE = r"""
import dataclasses, json, sys
import numpy as np
import repro.launch.steps as steps
import jax, jax.numpy as jnp
from repro.configs import get_config, get_smoke_config
from repro.configs.registry import Shape
from repro.launch.dryrun import _jit_for_cell
from repro.launch.mesh import make_mesh
from repro.optim import AdamWConfig

cells, meshes = (json.loads(a) for a in sys.argv[3:5])
d = np.load(sys.argv[2])


def tree(prefix):
    out = {}
    for k in d.files:
        if k.startswith(prefix):
            node = out
            parts = k[len(prefix):].split("/")
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = jnp.asarray(d[k])
    return out


out = {}
for arch, mesh_name, B, S, pos0, n, cid in cells:
    cfg = dataclasses.replace(get_smoke_config(arch), dtype=jnp.float32,
                              fsdp=get_config(arch).fsdp)
    shape, axes = meshes[mesh_name]
    mesh = make_mesh(tuple(shape), tuple(axes),
                     devices=jax.devices()[:int(np.prod(shape))])
    cfg = steps.prepare_config(cfg, mesh)
    params = tree(f"in/{arch}/params/")
    state = tree(f"in/{cid}/state/")
    state["pos"] = jnp.int32(pos0)
    toks = d[f"in/{cid}/tokens"]
    with mesh:
        jfn, _ = _jit_for_cell(cfg, Shape(cid, "decode", S, B), mesh,
                               AdamWConfig())
        for t in range(n):
            logits, state = jfn(params, state, jnp.asarray(toks[t]))
            out[f"{cid}/logits{t}"] = np.asarray(logits)
    state.pop("pos")
    for path, leaf in jax.tree_util.tree_leaves_with_path(state):
        key = "/".join(str(e.key) for e in path)
        out[f"{cid}/state/{key}"] = np.asarray(leaf)
np.savez(sys.argv[1], **out)
"""


# ---------------------------------------------------------------------------
# The ranks
# ---------------------------------------------------------------------------

def _state_tensors(state):
    return {k: v for k, v in state.items() if k not in ("pos", "cell")}


#: ``DistributedComm.calls``' kinds, in the order ``comm_figures`` keeps
COMM_KINDS = ("all_gather_group", "reduce_scatter", "all_reduce")


def comm_figures(comm):
    """A comm's calls by kind, then its gathered and reduced bytes."""
    return np.array([comm.calls[k] for k in COMM_KINDS]
                    + [comm.bytes["gathered"], comm.bytes["reduced"]])


def counted_comm(cell, rank):
    """``comm_figures`` of the dry run's trace of one decode step of the
    cell on ``rank`` (``meta_trace.CountingComm``, no process group)."""
    arch, mesh_name, *_ = cell
    tmpl = t_mesh.Mesh(MESHES[mesh_name][1], MESHES[mesh_name][0])
    mesh, comm = dryrun.rank_mesh(tmpl, rank)
    step, args = dryrun.step_and_args(t_cfg(arch), shape_of(cell), mesh)
    meta_trace.trace(step, args, cost=False)
    return comm_figures(comm)


def _run_cell(cell, d, comm, out):
    arch, mesh_name, B, S, pos0, n = cell
    cid = cell_id(cell)
    cfg = t_cfg(arch)
    mod = steps.model_module(cfg)
    mesh = t_mesh.make_mesh(*MESHES[mesh_name], comm=comm)
    shape = shape_of(cell)
    full = mod.params_from_numpy(cfg, unflat(d, f"in/{arch}/params/"))
    params = t_mesh.shard_tree(full, steps.param_and_opt_specs(cfg, mesh)[0],
                               mesh)
    whole = tree_map(lambda a: torch.from_numpy(np.array(a)),
                     unflat(d, f"in/{cid}/state/"))
    whole["pos"] = pos0
    state = steps.shard_decode_state(cfg, whole, shape, mesh)
    del full, whole
    out[f"{cid}/bytes_params"] = np.array(sum(
        t.nbytes for _p, t in tree_leaves(params)))
    # pos is the step's int32 scalar argument in the reference
    out[f"{cid}/bytes_state"] = np.array(4 + sum(
        t.nbytes for _p, t in tree_leaves(_state_tensors(state))))
    for path, t in tree_leaves(params):
        out[f"{cid}/shape/params/" + "/".join(path)] = np.array(t.shape)
    for path, t in tree_leaves(_state_tensors(state)):
        out[f"{cid}/shape/state/" + "/".join(path)] = np.array(t.shape)
    step = steps.build_serve_step(cfg, mesh=mesh)
    toks = d[f"in/{cid}/tokens"]
    out[f"{cid}/comm_counted"] = counted_comm(cell, comm.rank)
    attn_bytes, kernel_shapes = [], []
    real_attn, real_ssd = attention.decode_attention, ops.ssd_intra_chunk

    def counted_attn(*a, **kw):
        before = sum(comm.bytes.values())
        res = real_attn(*a, **kw)
        cache = a[3].nbytes + a[4].nbytes
        attn_bytes.append((sum(comm.bytes.values()) - before, cache))
        return res

    def counted_ssd(x, *a, **kw):
        kernel_shapes.append(tuple(x.shape) + (kw["chunk"],))
        return real_ssd(x, *a, **kw)
    attention.decode_attention, ops.ssd_intra_chunk = counted_attn, \
        counted_ssd
    try:
        for t in range(n):
            before = sum(comm.bytes.values())
            figures = comm_figures(comm)
            logits, state = step(params, state, torch.from_numpy(
                steps.decode_rows(cfg, toks[t], shape, mesh)))
            out[f"{cid}/comm_real{t}"] = comm_figures(comm) - figures
            out[f"{cid}/logits{t}"] = logits.numpy()
            out[f"{cid}/token_bytes{t}"] = np.array(
                sum(comm.bytes.values()) - before)
    finally:
        attention.decode_attention, ops.ssd_intra_chunk = real_attn, \
            real_ssd
    out[f"{cid}/pos"] = np.array(state["pos"])
    if attn_bytes:
        out[f"{cid}/attn_bytes"] = np.array(attn_bytes)
    if kernel_shapes:
        out[f"{cid}/ssd_shapes"] = np.array(sorted(set(kernel_shapes)))
    out.update(flat(_state_tensors(state), f"{cid}/state/"))


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _serve_runs(rank, n, port, comm_factory, out):
    """``serve`` on 4 ranks: through torchrun's environment on (data=2,
    model=2), then with a comm on the default mesh."""
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                      RANK=str(rank), WORLD_SIZE=str(n),
                      LOCAL_RANK=str(rank))
    kw = {k: v for k, v in SERVE.items() if k != "arch"}
    out["serve/mesh"] = t_serve.serve(SERVE["arch"], mesh_spec="data=2,model=2",
                                      dist="gloo", device="cpu", **kw)
    comm = comm_factory()
    out["serve/default"] = t_serve.serve(SERVE["arch"], comm=comm,
                                         device="cpu", **kw)
    return comm


def _rank_main(rank, n, store, inputs, out_dir, port):
    torch.set_num_threads(1)

    def make_comm():
        return DistributedComm("gloo", rank=rank, world_size=n,
                               init_method=f"file://{store}", device="cpu",
                               timeout=RANK_TIMEOUT)
    out = {}
    if n == 4:
        comm = _serve_runs(rank, n, port, make_comm, out)
    else:
        comm = make_comm()
    try:
        d = dict(np.load(inputs))
        for cell in CELLS:
            if cell[1] in SPAWNS[n]:
                _run_cell(cell, d, comm, out)
        if n == 4:
            try:
                t_mesh.make_mesh((2, 4), ("data", "model"), comm=comm)
                out["size_error"] = np.array("")
            except ValueError as e:
                out["size_error"] = np.array(str(e))
        np.savez(Path(out_dir) / f"ranks{n}_rank{rank}.npz", **out)
    finally:
        comm.close()


# ---------------------------------------------------------------------------
# Fixtures
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Write the inputs, start the JAX subprocesses and both spawns
    together and run the single-process decode meanwhile; return
    (reference outputs, {cell id: [rank outputs]}, {ranks: [outputs]},
    single-process outputs)."""
    d = tmp_path_factory.mktemp("torch_dist_decode")
    inputs = {}
    for arch in ARCHS:
        rc = r_cfg(arch)
        rp = r_steps.model_module(rc).init_params(rc, jax.random.PRNGKey(1))
        inputs.update(flat(jax.tree.map(lambda a: np.asarray(a, np.float32),
                                        rp), f"in/{arch}/params/"))
    for cell in CELLS:
        cfg = t_cfg(cell[0])
        params = steps.model_module(cfg).params_from_numpy(
            cfg, unflat(inputs, f"in/{cell[0]}/params/"))
        state = initial_state(cell, params)
        inputs.update(flat(_state_tensors(state),
                           f"in/{cell_id(cell)}/state/"))
        inputs[f"in/{cell_id(cell)}/tokens"] = cell_tokens(cell)
    np.savez(d / "inputs.npz", **inputs)
    env = dict(os.environ, PYTHONPATH=str(SRC), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    cells = [list(c) + [cell_id(c)] for c in CELLS]
    refs = [subprocess.Popen(
        [sys.executable, "-c", REFERENCE, str(d / f"ref{i}.npz"),
         str(d / "inputs.npz"), json.dumps(part), json.dumps(MESHES)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for i, part in enumerate(deal(cells, REF_PROCS, REF_WEIGHT))]
    try:
        port = _free_port()
        ctxs = [spawn(_rank_main, n, (n, str(d / f"store{n}"),
                                      str(d / "inputs.npz"), str(d), port))
                for n in SPAWNS]
        single = single_process(inputs)
        join(ctxs, SPAWN_SECONDS)
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
    spawns = {n: [dict(np.load(d / f"ranks{n}_rank{r}.npz"))
                  for r in range(n)] for n in SPAWNS}
    ranks = {cell_id(c): spawns[next(n for n, ms in SPAWNS.items()
                                     if c[1] in ms)] for c in CELLS}
    return ref, ranks, spawns, single


def single_process(inputs):
    """One process's decode of every cell on the whole state and batch,
    and one process's ``serve``."""
    out = {}
    for cell in CELLS:
        arch, _mesh, _B, _S, _pos0, n = cell
        cid = cell_id(cell)
        cfg = t_cfg(arch)
        mod = steps.model_module(cfg)
        params = mod.params_from_numpy(cfg, unflat(inputs,
                                                   f"in/{arch}/params/"))
        state = initial_state(cell, params)
        step = steps.build_serve_step(cfg)
        for t in range(n):
            logits, state = step(params, state, torch.from_numpy(
                inputs[f"in/{cid}/tokens"][t]))
            out[f"{cid}/logits{t}"] = logits.numpy()
    kw = {k: v for k, v in SERVE.items() if k != "arch"}
    out["serve"] = t_serve.serve(SERVE["arch"], device="cpu", **kw)
    return out


def rank_mesh(mesh_name, rank):
    """The mesh record at ``rank``'s coordinates (no process group)."""
    shape, axes = MESHES[mesh_name]
    return t_mesh.Mesh(axes, shape, comm=types.SimpleNamespace(rank=rank))


def rows_of(cell, full, rank):
    """A rank's rows of a whole ``[B, ...]`` array."""
    m = rank_mesh(cell[1], rank)
    return m.cut(full, steps.decode_state_specs(t_cfg(cell[0]),
                                                shape_of(cell), m)[3])


# ---------------------------------------------------------------------------
# The decode step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cell", CELLS, ids=cell_id)
def test_decode_logits_match_reference_sharded_step(runs, cell):
    """Every rank's logits at every step are its rows of the reference's
    sharded decode step's, over the whole vocabulary."""
    ref, ranks, _s, _single = runs
    cid = cell_id(cell)
    for t in range(cell[5]):
        want = ref[f"{cid}/logits{t}"]
        tol = 1e-4 * max(1.0, float(np.abs(want).max()))
        for rank, got in enumerate(ranks[cid]):
            w = rows_of(cell, want, rank)
            g = got[f"{cid}/logits{t}"]
            assert g.shape == w.shape == (w.shape[0], 1, t_cfg(
                cell[0]).vocab_size), (rank, g.shape)
            np.testing.assert_allclose(g, w, rtol=0, atol=tol,
                                       err_msg=f"rank {rank} step {t}")


@pytest.mark.parametrize("cell", CELLS, ids=cell_id)
def test_decode_logits_match_single_process(runs, cell):
    _ref, ranks, _s, single = runs
    cid = cell_id(cell)
    for t in range(cell[5]):
        want = single[f"{cid}/logits{t}"]
        tol = 1e-4 * max(1.0, float(np.abs(want).max()))
        for rank, got in enumerate(ranks[cid]):
            np.testing.assert_allclose(got[f"{cid}/logits{t}"],
                                       rows_of(cell, want, rank), rtol=0,
                                       atol=tol, err_msg=f"rank {rank}")


@pytest.mark.parametrize("cell", CELLS, ids=cell_id)
def test_decode_state_shards_match_reference(runs, cell):
    """After the last step every rank's state shards equal the matching
    slices of the reference's carried state, and ``pos`` advanced once a
    step."""
    ref, ranks, _s, _single = runs
    arch, mesh_name, _B, _S, pos0, n = cell
    cid = cell_id(cell)
    cfg = t_cfg(arch)
    for rank, got in enumerate(ranks[cid]):
        m = rank_mesh(mesh_name, rank)
        _meta, specs, _t, _ts = steps.decode_state_specs(cfg, shape_of(cell),
                                                         m)
        assert int(got[f"{cid}/pos"]) == pos0 + n
        keys = [k for k in got if k.startswith(f"{cid}/state/")]
        assert len(keys) == len([p for p, _s in tree_leaves(specs)
                                 if p != ("pos",)])
        for key in keys:
            path = key[len(f"{cid}/state/"):].split("/")
            spec = specs
            for p in path:
                spec = spec[p]
            want = m.cut(np.asarray(ref[key], np.float32), spec)
            tol = 1e-5 * max(1.0, float(np.abs(want).max()))
            np.testing.assert_allclose(got[key], want, rtol=0, atol=tol,
                                       err_msg=f"rank {rank} {key}")


@pytest.mark.parametrize("cell", CELLS, ids=cell_id)
def test_decode_resident_bytes_equal_dry_run(runs, cell):
    """Each rank's parameter and state bytes are the dry run's per-device
    figures for the cell, and every shard has the dry run's shard
    shape."""
    _ref, ranks, _s, _single = runs
    arch, mesh_name, *_ = cell
    cid = cell_id(cell)
    cfg = t_cfg(arch)
    m = t_mesh.Mesh(MESHES[mesh_name][1], MESHES[mesh_name][0])
    shape = shape_of(cell)
    want = dryrun.argument_bytes(cfg, shape, m)
    leaves = {leaf.path: leaf.shard_shape(m)
              for leaf in dryrun.cell_leaves(cfg, shape, m)}
    for rank, got in enumerate(ranks[cid]):
        assert int(got[f"{cid}/bytes_params"]) == want["params"], rank
        assert int(got[f"{cid}/bytes_state"]) == want["state"], rank
        shapes = {k[len(f"{cid}/shape/"):]: tuple(v) for k, v in got.items()
                  if k.startswith(f"{cid}/shape/")}
        assert len(shapes) == len(leaves) - 2      # pos and the tokens
        for path, s in shapes.items():
            assert s == leaves[path], (rank, path, s, leaves[path])


@pytest.mark.parametrize("cell", CELLS, ids=cell_id)
def test_counting_comm_equals_the_ranks_counters(runs, cell):
    """The dry run's trace of a decode step on each rank counts the
    collectives by kind and the gathered and reduced bytes that the
    rank's ``DistributedComm`` counted over every decode step of the
    cell (no shape depends on the position)."""
    _ref, ranks, _s, _single = runs
    cid = cell_id(cell)
    for rank, got in enumerate(ranks[cid]):
        want = list(got[f"{cid}/comm_counted"])
        for t in range(cell[5]):
            assert list(got[f"{cid}/comm_real{t}"]) == want, (rank, t)


LAYOUTS = {"a": [c for c in CELLS if "a" in layout(c)],
           "b": [c for c in CELLS if "b" in layout(c)],
           "c": [c for c in CELLS if "c" in layout(c)]}


def test_cells_cover_the_three_cache_layouts():
    assert all(LAYOUTS.values()), {k: len(v) for k, v in LAYOUTS.items()}
    two_dp = [c for c in LAYOUTS["b"] if c[1] == "pod2_data2_model2"]
    assert two_dp


@pytest.mark.parametrize("cell", LAYOUTS["b"], ids=cell_id)
def test_sequence_split_moves_less_than_a_cache_shard(runs, cell):
    """Where the slots are cut over the dp axes, each attention layer's
    collectives move fewer bytes a token than one rank's shard of that
    layer's cache: the cache is never gathered."""
    _ref, ranks, _s, _single = runs
    cid = cell_id(cell)
    for rank, got in enumerate(ranks[cid]):
        moved = got[f"{cid}/attn_bytes"]
        assert len(moved) > 0
        for b, cache in moved:
            assert 0 < b < cache, (rank, b, cache)


@pytest.mark.parametrize("cell", [c for c in CELLS
                                  if "M" in t_cfg(c[0]).pattern()],
                         ids=cell_id)
def test_mamba_decode_runs_b10_on_the_ranks_heads(runs, cell):
    """B10 (``ops.ssd_intra_chunk``) runs at chunk 1 on the rank's rows
    and its ``H / model`` SSD heads."""
    _ref, ranks, _s, _single = runs
    arch, mesh_name, B, *_ = cell
    cid = cell_id(cell)
    cfg = t_cfg(arch)
    sizes = MESHES[mesh_name][0]
    dp = int(np.prod(sizes[:-1]))
    rows = B // dp if B % dp == 0 else B
    want = (rows, 1, cfg.ssm_heads // sizes[-1], cfg.ssm_head_dim, 1)
    for rank, got in enumerate(ranks[cid]):
        assert [tuple(s) for s in got[f"{cid}/ssd_shapes"]] == [want], rank


def test_mamba_conv_carry_is_cut_by_channels():
    """mamba2-130m's smoke conv carry is cut over "model" by channels, so
    a rank's heads read B / C channels another rank stores: the
    relayout is exercised."""
    cfg = t_cfg("mamba2_130m")
    m = t_mesh.Mesh(("data", "model"), (2, 2))
    _meta, specs, _t, _ts = steps.decode_state_specs(
        cfg, steps.decode_shape(4, 32), m)
    assert specs["layers"]["pos0"]["conv"][3] == "model"
    assert specs["layers"]["pos0"]["ssm"][2] == "model"


# ---------------------------------------------------------------------------
# The serve entry point
# ---------------------------------------------------------------------------

@torch.inference_mode()
def _margin_at(seqs, row, t):
    """One process's top-two logit margin at step ``t`` of ``row`` (its own
    tokens teacher-forced), beside the bf16 decode rule's limit there."""
    cfg = get_smoke_config(SERVE["arch"])
    params = lm.init_params(cfg, SERVE["seed"], device="cpu")
    max_len = SERVE["prompt_len"] + SERVE["gen_len"]
    state = lm.init_decode_state(cfg, SERVE["batch"], max_len, device="cpu")
    for s in range(t):
        logits, state = lm.decode_step(
            cfg, params, state, torch.from_numpy(seqs[:, s:s + 1]).int())
    top = torch.topk(logits[row, -1].float(), 2).values
    return float(top[0] - top[1]), \
        2e-2 * max(1.0, float(logits[row].abs().max()))


@pytest.mark.parametrize("which", ("mesh", "default"))
def test_serve_on_ranks_returns_one_process_tokens(runs, which):
    """``serve`` on 4 ranks (torchrun's environment with ``--mesh
    data=2,model=2``, or a comm on the default ``(data=4, model=1)``
    mesh) returns the same ``[batch, prompt_len + gen_len]`` tokens on
    every rank: one process's, or equal to them up to a first difference
    where one process's top-two margin lies within the decode rule."""
    _ref, _ranks, spawns, single = runs
    want = single["serve"]
    got = [r[f"serve/{which}"] for r in spawns[4]]
    for g in got:
        assert g.shape == want.shape == (
            SERVE["batch"], SERVE["prompt_len"] + SERVE["gen_len"])
        np.testing.assert_array_equal(g, got[0])
    diff = np.argwhere(got[0] != want)
    if len(diff):
        row, t = (int(v) for v in diff[np.argmin(diff[:, 1])])
        assert t >= SERVE["prompt_len"]
        margin, limit = _margin_at(want, row, t)
        assert margin <= limit, (row, t, margin, limit)


def test_mesh_size_must_match_the_comm(runs):
    for got in runs[2][4]:
        assert "a comm of 4 ranks" in str(got["size_error"])


def test_serve_step_refuses_a_state_of_another_layout():
    """The mesh step checks each state shard against its layout."""
    cfg = t_cfg("qwen3_14b")
    m = rank_mesh("data2_model2", 0)
    state = lm.init_decode_state(cfg, 4, 32)
    sharded = steps.shard_decode_state(cfg, state, steps.decode_shape(4, 32),
                                       m)
    sharded["layers"]["pos0"]["k"] = sharded["layers"]["pos0"]["k"][:, :1]
    with pytest.raises(ValueError, match="its layout gives"):
        steps._check_state(cfg, sharded, m)
    del sharded["cell"]
    with pytest.raises(ValueError, match="shard_decode_state"):
        steps._check_state(cfg, sharded, m)
