"""Shared by ``test_torch_dryrun_xla_{a,b}.py`` (mesh data=2 x model=2)
and ``test_torch_dryrun_xla_pod_{a,b}.py`` (pod=2 x data=2 x model=2):
the port's per-device argument bytes (``repro_torch.launch.dryrun``)
against XLA's own layout of the reference's step for every smoke-config
cell, the archs in two groups (``GROUPS``) so that each file's
compiles take under a minute alone (jamba's train cell alone ~25 s).

One JAX subprocess a file, with the mesh's count of host devices,
compiles the reference's ``_jit_for_cell`` for each cell of its group
(the smoke config of every arch x its ``shape_cells``, at seq_len 64 and
a batch of min(4, the cell's global batch), so long_500k keeps its batch
of one and with it the cache's sequence sharding) and writes, for every
argument XLA keeps, its shard shape (``sharding.shard_shape``) and the
executable's ``memory_analysis().argument_size_in_bytes``.

XLA prunes an argument the step never reads (``jit``'s default
``keep_unused=False``): the encoder-decoder's decode step reads neither
the encoder's weights nor the cross-attention's k / v projections, so
XLA's figure for whisper's decode cell leaves them out, while the
caller holds them all the same.  For such a cell the subprocess also
compiles the step with ``keep_unused=True`` (``jax.jit`` patched in the
subprocess only), and the port's total is held against that figure,
its sum over the kept arguments against the default one.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

from repro_torch.configs import get_smoke_config, shape_cells
from repro_torch.configs.registry import ARCHS, Shape
from repro_torch.launch import dryrun, mesh as t_mesh

ROOT = Path(__file__).resolve().parents[1]

#: jamba's cells alone take about a third of the compiles
GROUPS = {"a": ("jamba_v0_1_52b", "mamba2_130m", "starcoder2_3b")}
GROUPS["b"] = tuple(a for a in ARCHS if a not in GROUPS["a"])


def cells(group: str):
    """(arch, shape name) of every cell of the group's archs."""
    return [(arch, s.name) for arch in GROUPS[group]
            for s in shape_cells(arch)]

SCRIPT = r"""
import functools, json, sys
from unittest import mock
import jax
from repro.configs import SHAPES, get_smoke_config, shape_cells
from repro.configs.registry import ARCHS, Shape
from repro.launch import dryrun, steps
from repro.launch.mesh import make_mesh
from repro.optim import AdamWConfig

sizes, names, archs = json.loads(sys.argv[1])
mesh = make_mesh(tuple(sizes), tuple(names))
ARGS = {"train": ("params", "opt", "batch"), "prefill": ("params", "batch"),
        "decode": ("params", "state", "tokens")}


def compile_cell(cfg, shape):
    with mesh:
        jfn, args = dryrun._jit_for_cell(cfg, shape, mesh, AdamWConfig())
        return jfn.lower(*args).compile(), args


def path_of(kind, path):
    return "/".join((ARGS[kind][path[0].idx],)
                    + tuple(str(k.key) for k in path[1:]))


out = {}
for arch in archs:
    for s in shape_cells(arch):
        shape = Shape(s.name, s.kind, 64, min(4, s.global_batch))
        cfg = steps.prepare_config(get_smoke_config(arch), mesh)
        comp, args = compile_cell(cfg, shape)
        flat = jax.tree_util.tree_flatten_with_path(args)[0]
        kept = sorted(comp._executable._kept_var_idx)
        shardings = jax.tree_util.tree_leaves(comp.input_shardings[0])
        assert len(kept) == len(shardings), (arch, s.name)
        rec = {"args": {path_of(s.kind, p): [list(a.shape), str(a.dtype)]
                        for p, a in flat},
               "bytes": int(comp.memory_analysis().argument_size_in_bytes),
               "kept": {path_of(s.kind, flat[i][0]):
                        list(sh.shard_shape(flat[i][1].shape))
                        for i, sh in zip(kept, shardings)}}
        if len(kept) < len(flat):
            with mock.patch.object(jax, "jit",
                                   functools.partial(jax.jit,
                                                     keep_unused=True)):
                comp_all, _ = compile_cell(cfg, shape)
            rec["bytes_all"] = int(
                comp_all.memory_analysis().argument_size_in_bytes)
        out[f"{arch}/{s.name}"] = rec
        print(arch, s.name, rec["bytes"], flush=True)
print("XLA-JSON " + json.dumps(out))
"""

DTYPES = {"bfloat16": "torch.bfloat16", "float32": "torch.float32",
          "int32": "torch.int32"}


def xla_layouts(sizes, names, group: str) -> dict:
    """Run the JAX subprocess for the mesh (``sizes``, ``names``) and the
    group's archs."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count="
                         f"{t_mesh.Mesh(tuple(names), tuple(sizes)).size}")
    r = subprocess.run(
        [sys.executable, "-c", SCRIPT,
         json.dumps([sizes, names, GROUPS[group]])], env=env,
        capture_output=True, text=True, timeout=900)
    assert r.returncode == 0, \
        f"stdout:\n{r.stdout}\nstderr:\n{r.stderr[-4000:]}"
    line = next(ln for ln in r.stdout.splitlines()
                if ln.startswith("XLA-JSON "))
    return json.loads(line[len("XLA-JSON "):])


def check_cell(xla: dict, arch: str, shape_name: str, sizes, names) -> None:
    """The port's leaves, shard shapes and bytes for the cell against
    XLA's record of it."""
    rec = xla[f"{arch}/{shape_name}"]
    mesh = t_mesh.Mesh(tuple(names), tuple(sizes))
    s = next(c for c in shape_cells(arch) if c.name == shape_name)
    shape = Shape(s.name, s.kind, 64, min(4, s.global_batch))
    cfg = get_smoke_config(arch)
    leaves = {leaf.path: leaf for leaf in dryrun.cell_leaves(cfg, shape, mesh)}
    # the same arguments, shapes and dtypes as the reference's step
    assert {p: [list(leaf.shape), str(leaf.dtype)]
            for p, leaf in leaves.items()} == {
        p: [shp, DTYPES[dt]] for p, (shp, dt) in rec["args"].items()}
    # every argument XLA lays out: the same shard shape
    assert {p: list(leaves[p].shard_shape(mesh)) for p in rec["kept"]} \
        == rec["kept"]
    kept_bytes = sum(leaves[p].nbytes(mesh) for p in rec["kept"])
    assert kept_bytes == rec["bytes"]
    total = dryrun.argument_bytes(cfg, shape, mesh)
    if "bytes_all" in rec:
        assert total["total"] == rec["bytes_all"] > rec["bytes"]
    else:
        assert len(rec["kept"]) == len(rec["args"])
        assert total["total"] == rec["bytes"]
    assert total["uneven"] == [p for p, leaf in leaves.items()
                               if not leaf.even(mesh)]
