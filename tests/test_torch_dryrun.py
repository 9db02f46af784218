"""The port's dry run (``repro_torch/launch/dryrun.py`` and the shape
helpers of ``launch/steps.py``) against the JAX package's, on the CPU.

(i) For every arch x ``shape_cells`` cell on both production meshes, the
port's batch, decode-state, parameter and AdamW shapes, dtypes and specs
equal the reference's, which runs on a ``jax.sharding.AbstractMesh`` (no
devices) as ``tests/test_torch_mesh.py`` does.  (iii) ``model_flops``
and ``tokens`` equal the reference's formula on the reference's own
parameter counts.  (iv) ``main``: a cell's record, ``--all`` resuming
from it, ``--override`` parsed as the reference's ``main`` parses it.
The bytes against XLA's are ``test_torch_dryrun_xla*.py``."""

import functools
import json
from unittest import mock

import jax
import pytest
import torch
from jax.sharding import AbstractMesh

from repro.configs import get_config as r_get_config
from repro.configs import get_smoke_config as r_get_smoke_config
from repro.configs.registry import ARCHS
from repro.launch import dryrun as r_dryrun
from repro.launch import mesh as r_mesh
from repro.launch import steps as r_steps
from repro.models import lm as r_lm, whisper as r_whisper
from repro_torch.configs import SHAPES, all_cells, get_config, \
    get_smoke_config, shape_cells
from repro_torch.launch import dryrun, mesh, steps
from repro_torch.models.common import tree_leaves

MESHES = {"pod1": ((16, 16), ("data", "model")),
          "pod2": ((2, 16, 16), ("pod", "data", "model"))}
CELLS = [(arch, s.name, m) for arch in ARCHS for s in shape_cells(arch)
         for m in MESHES]


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread a test process keeps parallel test workers
    from thrashing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def r_param_shapes(arch):
    return r_steps.param_shapes(r_get_config(arch))


def ref_tree(tree):
    """path -> (shape, dtype name) of a tree of ShapeDtypeStructs."""
    return {tuple(str(k.key) for k in path): (tuple(a.shape), str(a.dtype))
            for path, a in jax.tree_util.tree_flatten_with_path(tree)[0]}


def ref_specs(tree):
    """path -> spec tuple of a tree of PartitionSpecs."""
    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
    return {tuple(str(k.key) for k in path): tuple(s) for path, s in flat}


def port_tree(tree):
    return {path: (tuple(t.shape), str(t.dtype).replace("torch.", ""))
            for path, t in tree_leaves(tree)}


def port_specs(tree):
    return dict(tree_leaves(tree))


@pytest.mark.parametrize("arch", ARCHS)
def test_fsdp_equals_reference(arch):
    assert get_config(arch).fsdp == r_get_config(arch).fsdp
    assert get_smoke_config(arch).fsdp == r_get_smoke_config(arch).fsdp
    rc, tc = r_get_config(arch), get_config(arch)
    tm = mesh.make_production_mesh()
    rm = AbstractMesh(tm.axis_sizes, tm.axis_names)
    # param_and_opt_specs defaults to the config's flag
    assert port_specs(steps.param_and_opt_specs(tc, tm)[0]) == \
        ref_specs(r_steps.param_and_opt_specs(rc, rm)[0])


@pytest.mark.parametrize("multi_pod", [False, True])
def test_production_mesh_equals_reference(multi_pod):
    with mock.patch.object(jax, "make_mesh",
                           lambda shape, axes, **kw: (shape, axes)):
        shape, axes = r_mesh.make_production_mesh(multi_pod=multi_pod)
    got = mesh.make_production_mesh(multi_pod=multi_pod)
    assert (got.axis_sizes, got.axis_names) == (tuple(shape), tuple(axes))
    assert got.device is None and got.size == (512 if multi_pod else 256)


@pytest.mark.parametrize("arch,shape_name,mesh_name", CELLS,
                         ids=[f"{a}-{s}-{m}" for a, s, m in CELLS])
def test_cell_shapes_and_specs_equal_reference(arch, shape_name, mesh_name):
    sizes, names = MESHES[mesh_name]
    rm, tm = AbstractMesh(sizes, names), mesh.Mesh(names, sizes)
    rc, tc = r_get_config(arch), get_config(arch)
    shape = SHAPES[shape_name]
    params = steps.param_shapes(tc)
    assert port_tree(params) == ref_tree(r_param_shapes(arch))
    assert all(t.device.type == "meta" for _p, t in tree_leaves(params))
    if shape.kind == "decode":
        want = r_steps.decode_state_specs(rc, shape, rm)
        state, specs, tok, tok_spec = steps.decode_state_specs(tc, shape, tm)
        assert port_tree(state) == ref_tree(want[0])
        assert port_specs(specs) == ref_specs(want[1])
        assert port_tree({"t": tok}) == ref_tree({"t": want[2]})
        assert tok_spec == tuple(want[3])
        assert all(t.device.type == "meta" for _p, t in tree_leaves(state))
    else:
        labels = shape.kind == "train"
        want = r_steps.batch_specs(rc, shape, rm, with_labels=labels)
        batch, specs = steps.batch_specs(tc, shape, tm, with_labels=labels)
        assert port_tree(batch) == ref_tree(want[0])
        assert port_specs(specs) == ref_specs(want[1])
    if shape.kind == "train":
        opt = steps.opt_shapes(params)
        assert port_tree(opt) == ref_tree(
            r_steps.opt_shapes(r_param_shapes(arch)))
        _p, o_specs = steps.param_and_opt_specs(tc, tm)
        _rp, ro_specs = r_steps.param_and_opt_specs(rc, rm)
        assert port_specs(o_specs) == ref_specs(ro_specs)


@pytest.mark.parametrize("arch,shape", all_cells(),
                         ids=[f"{a}-{s.name}" for a, s in all_cells()])
def test_model_flops_equal_reference(arch, shape):
    rc = r_get_config(arch)
    n_active = (r_whisper.count_params(rc) if rc.encdec
                else r_lm.count_active_params(rc))
    tokens = shape.global_batch * (1 if shape.kind == "decode"
                                   else shape.seq_len)
    mult = 6 if shape.kind == "train" else 2
    got = dryrun.run_cell(arch, shape.name, verbose=False)
    assert got["tokens"] == tokens
    assert got["model_flops"] == float(mult * n_active * tokens)
    assert got["mesh"] == {"data": 16, "model": 16}
    assert got["memory"]["argument_bytes"] == got["argument_bytes"]["total"]
    groups = {"train": {"params", "opt", "batch"},
              "prefill": {"params", "batch"},
              "decode": {"params", "state", "tokens"}}[shape.kind]
    assert set(got["argument_bytes"]) == groups | {"total", "uneven"}
    assert got["argument_bytes"]["total"] == sum(
        got["argument_bytes"][g] for g in groups)


def test_argument_bytes_by_hand():
    """qwen3-14b's decode_32k cell on one pod: the KV cache [40, 128,
    32768, 8, 128] bf16 over data (batch) and model (8 kv heads do not
    divide by 16, so head_dim), a scalar int32 pos, [128, 1] int32
    tokens over data."""
    cfg = get_config("qwen3_14b")
    got = dryrun.argument_bytes(cfg, SHAPES["decode_32k"],
                                mesh.make_production_mesh())
    cache = 40 * (128 // 16) * 32768 * 8 * (128 // 16) * 2
    assert got["state"] == 2 * cache + 4
    assert got["tokens"] == (128 // 16) * 4
    assert got["uneven"] == []


def untimed(record):
    return {k: v for k, v in record.items() if k != "compile_s"}


def test_main_writes_a_cell_and_all_resumes(tmp_path, capsys):
    out = tmp_path / "dryrun.json"
    dryrun.main(["--arch", "mamba2_130m", "--shape", "train_4k",
                 "--out", str(out)])
    first = json.loads(out.read_text())
    again = json.loads(json.dumps(
        dryrun.run_cell("mamba2_130m", "train_4k", verbose=False)))
    # every figure but the seconds the traces took
    assert len(first) == 1 and untimed(first[0]) == untimed(again)
    records = dryrun.main(["--all", "--out", str(out)])
    assert "resuming: 1 cells already recorded" in capsys.readouterr().out
    written = json.loads(out.read_text())
    assert written == json.loads(json.dumps(records))
    assert len(written) == 66 and written[0] == first[0]
    assert not [r for r in written if "error" in r]
    assert {(r["arch"], r["shape"], r["multi_pod"]) for r in written} == {
        (a, s.name, mp) for a, s in all_cells() for mp in (False, True)}
    # two pods hold at most what one does, a device
    by = {(r["arch"], r["shape"], r["multi_pod"]): r for r in written}
    for a, s in all_cells():
        assert by[a, s.name, True]["memory"]["argument_bytes"] <= \
            by[a, s.name, False]["memory"]["argument_bytes"]


OVERRIDES = ["ssm_chunk=64", "fsdp=false", "remat=True", "n_layers=-3",
             "name=abc"]


def test_override_parses_as_reference():
    seen = {}

    def fake_run_cell(arch, shape, **kw):
        seen.update(kw["overrides"])
        return {}

    argv = ["--arch", "mamba2_130m", "--shape", "train_4k"]
    for ov in OVERRIDES:
        argv += ["--override", ov]
    with mock.patch.object(r_dryrun, "run_cell", fake_run_cell):
        r_dryrun.main(argv)
    got = dryrun.parse_overrides(OVERRIDES)
    assert got == seen
    assert [type(v) for v in got.values()] == \
        [type(v) for v in seen.values()]
    assert got == {"ssm_chunk": 64, "fsdp": False, "remat": True,
                   "n_layers": -3, "name": "abc"}


def test_override_applies_and_unknown_field_raises(tmp_path):
    out = tmp_path / "o.json"
    dryrun.main(["--arch", "qwen3_14b", "--shape", "train_4k", "--override",
                 "fsdp=false", "--out", str(out)])
    unsharded = json.loads(out.read_text())[0]["argument_bytes"]
    sharded = dryrun.run_cell("qwen3_14b", "train_4k",
                              verbose=False)["argument_bytes"]
    assert unsharded["params"] > sharded["params"]
    assert unsharded["opt"] == sharded["opt"]       # ZeRO-1 either way
    assert unsharded == dryrun.run_cell(
        "qwen3_14b", "train_4k", verbose=False,
        overrides={"fsdp": False})["argument_bytes"]
    for field in ("scan_layers", "no_such_field"):
        with pytest.raises(ValueError, match=field):
            dryrun.main(["--arch", "qwen3_14b", "--shape", "train_4k",
                         "--override", f"{field}=true"])
        with pytest.raises(ValueError, match=field):
            dryrun.main(["--all", "--override", f"{field}=1"])
