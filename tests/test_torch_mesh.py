"""The port's spec arithmetic (``repro_torch/launch/mesh.py``,
``launch/steps.py:param_and_opt_specs``) against the JAX package's, for
every arch's full config on the production meshes (data=16, model=16) and
(pod=2, data=16, model=16): the reference side runs on a
``jax.sharding.AbstractMesh``, which needs no devices.  Specs compare as
tuples (a ``PartitionSpec`` is one).  The port's ``ModelConfig`` carries
no sharding fields, so the reference config's ``fsdp`` is passed."""

import types

import pytest
import torch

from jax.sharding import AbstractMesh

from repro.configs import get_config as r_get_config
from repro.configs.registry import ARCHS
from repro.launch import mesh as r_mesh
from repro.launch import steps as r_steps
from repro_torch.configs import get_config
from repro_torch.launch import mesh, steps
from repro_torch.models.common import tree_leaves

MESHES = {"pod1": ((16, 16), ("data", "model")),
          "pod2": ((2, 16, 16), ("pod", "data", "model"))}


def pair(name):
    sizes, names = MESHES[name]
    return AbstractMesh(sizes, names), mesh.Mesh(names, sizes)


def flat(tree):
    return {path: tuple(spec) for path, spec in tree_leaves(tree)}


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_resolved_specs_equal_reference(arch, mesh_name):
    rc, tc = r_get_config(arch), get_config(arch)
    rm, tm = pair(mesh_name)
    r_mod, t_mod = r_steps.model_module(rc), steps.model_module(tc)
    placeholders = t_mod.param_specs(tc)
    assert flat(placeholders) == flat(r_mod.param_specs(rc))
    defs = t_mod.model_defs(tc)
    for zero1 in (False, True):
        want = r_mesh.resolve_spec_tree(r_mod.param_specs(rc), rc, rm,
                                        zero1=zero1)
        got = mesh.resolve_spec_tree(placeholders, tm, fsdp=rc.fsdp,
                                     zero1=zero1)
        assert flat(got) == flat(want), zero1
        shapes = r_steps.param_shapes(rc)
        fixed_want = r_mesh.fix_spec_tree(shapes, want, rm)
        fixed = mesh.fix_spec_tree(defs, got, tm)
        assert flat(fixed) == flat(fixed_want), zero1
    p_want, o_want = r_steps.param_and_opt_specs(rc, rm)
    p_got, o_got = steps.param_and_opt_specs(tc, tm, fsdp=rc.fsdp)
    assert flat(p_got) == flat(p_want)
    assert flat(o_got["m"]) == flat(o_want["m"]) == flat(o_got["v"])
    assert o_got["count"] == tuple(o_want["count"]) == ()


def test_fix_spec_moves_or_drops_axes():
    m = mesh.Mesh(("data", "model"), (4, 16))
    # 24 heads do not divide by 16: the axis moves to head_dim (128)
    assert mesh.fix_spec_for_shape((3072, 24, 128), ("data", "model"), m) \
        == ("data", None, "model")
    # nothing divides: replicated
    assert mesh.fix_spec_for_shape((6, 5), ("model",), m) == (None, None)
    pods = mesh.Mesh(*reversed(MESHES["pod2"]))
    assert mesh.dp_axes(pods) == ("pod", "data")
    assert mesh.resolve_spec(("F", "T", "D", None), pods, fsdp=True) == \
        (("pod", "data"), "model", ("pod", "data"), None)


def test_make_mesh_takes_one_device():
    """One device binds as it is; a larger mesh binds only to a comm of as
    many ranks (``core.comm.DistributedComm``), rank r at the row-major
    coordinate of r, and raises ``ValueError`` without one or where the
    sizes disagree."""
    m = mesh.make_mesh((1,), ("data",), device="cpu")
    assert m.shape == {"data": 1} and m.device == torch.device("cpu")
    with pytest.raises(ValueError, match="DistributedComm"):
        mesh.make_mesh((2, 2), ("data", "model"), device="cpu")
    made = []
    fake = types.SimpleNamespace(rank=3, P=4, device=torch.device("cpu"),
                                 group=lambda part: made.append(part))
    with pytest.raises(ValueError, match="a comm of 4 ranks"):
        mesh.make_mesh((2, 2, 2), ("pod", "data", "model"), comm=fake)
    bound = mesh.make_mesh((2, 2), ("data", "model"), comm=fake)
    assert bound.comm is fake and bound.device == torch.device("cpu")
    assert bound.coords == {"data": 1, "model": 1}
    assert made == [[[0, 2], [1, 3]], [[0, 1], [2, 3]],
                    [[0, 1, 2, 3]]]      # data, model, both: made at once
    with pytest.raises(ValueError, match="axis names"):
        mesh.Mesh(("data",), (1, 2))
