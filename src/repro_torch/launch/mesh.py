"""Meshes and ParamDef placeholder-spec resolution (port of
``repro/launch/mesh.py``).

The spec arithmetic is the reference's: a parameter's placeholder spec
("T" the tensor axis, "F" the fsdp axis, "D" the data axes, None
replicated) resolves against a mesh to a spec, a tuple with one entry a
dimension (an axis name, a tuple of axis names, or None); a dimension
that does not divide by its axes' extent hands them to another dimension
of the tensor that does, else drops them.  The port's mesh is a record of
axis names and sizes: the arithmetic needs nothing else, so the
production meshes (:func:`make_production_mesh`: ``(data=16,
model=16)``, ``(pod=2, data=16, model=16)``) resolve here without
devices.  ``fsdp`` comes as an argument (the caller passes the config's
``fsdp``), and "T" is the reference config's default tensor axis.

:func:`make_mesh` binds a mesh to devices and takes only a mesh of one
device: the engine path has its ``torch.distributed`` backend
(``core.comm.DistributedComm``, ROADMAP.md A.15a), and the LM steps get a
``DeviceMesh`` in A.15c.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional, Tuple

from ..core.comm import resolve_device
from ..models.common import Tree, tree_map

#: the reference config's tensor-parallel axis
TP_AXIS = "model"

Spec = Tuple[Any, ...]


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Axis names and sizes of a device mesh (``device`` set where
    :func:`make_mesh` bound it)."""
    axis_names: Tuple[str, ...]
    axis_sizes: Tuple[int, ...]
    device: Optional[Any] = None

    def __post_init__(self):
        if len(self.axis_names) != len(self.axis_sizes):
            raise ValueError(f"{len(self.axis_names)} axis names for "
                             f"{len(self.axis_sizes)} sizes")

    @property
    def shape(self) -> dict:
        """Axis name -> size (``jax.sharding.Mesh.shape``)."""
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        """Devices in the mesh."""
        return math.prod(self.axis_sizes)


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The production dry-run mesh as a record with no device: 256
    devices ``(data=16, model=16)``, or 512 over two pods ``(pod=2,
    data=16, model=16)``, "pod" extending data parallelism across the
    pods."""
    if multi_pod:
        return Mesh(("pod", "data", "model"), (2, 16, 16))
    return Mesh(("data", "model"), (16, 16))


def make_mesh(shape: Tuple[int, ...], axes: Tuple[str, ...],
              device=None) -> Mesh:
    """A mesh of ``shape`` over ``axes`` on ``device`` (the CUDA device
    unless the caller says otherwise).  Only one device: a larger mesh
    raises.  The engine path has its multi-device backend
    (``core.comm.DistributedComm``, ROADMAP.md A.15a); the LM steps do not
    yet (no ``DeviceMesh``, A.15c)."""
    mesh = Mesh(tuple(axes), tuple(int(s) for s in shape))
    if mesh.size != 1:
        raise NotImplementedError(
            f"a mesh of {mesh.size} devices {mesh.shape}: the LM steps run "
            f"on one device until they get a DeviceMesh (ROADMAP.md A.15c; "
            f"the engine path has core.comm.DistributedComm, A.15a)")
    return dataclasses.replace(mesh, device=resolve_device(device))


def dp_axes(mesh: Mesh) -> Tuple[str, ...]:
    """Axes carrying the batch: ("pod", "data") on multi-pod meshes."""
    return tuple(a for a in mesh.axis_names if a in ("pod", "data"))


def resolve_spec(placeholder, mesh: Mesh, *, fsdp: bool = False,
                 zero1: bool = False) -> Spec:
    """Map a ParamDef placeholder tuple to a spec: "T" -> ``TP_AXIS``;
    "F" -> the dp axes if ``fsdp`` or ``zero1`` (one axis as its name),
    else replicated; "D" -> the dp axes; None -> replicated."""
    fsdp_axes: Any = dp_axes(mesh)   # a 400B model's params + optimizer
    # exceed one pod's memory, so FSDP spans pods on a multi-pod mesh
    if len(fsdp_axes) == 1:
        fsdp_axes = fsdp_axes[0]
    out = []
    for dim in placeholder:
        if dim == "T":
            out.append(TP_AXIS)
        elif dim == "F":
            out.append(fsdp_axes if (fsdp or zero1) else None)
        elif dim == "D":
            out.append(dp_axes(mesh))
        else:
            out.append(None)
    return tuple(out)


def resolve_spec_tree(placeholders: Tree, mesh: Mesh, *, fsdp: bool = False,
                      zero1: bool = False) -> Tree:
    """Map :func:`resolve_spec` over a placeholder tree."""
    return tree_map(lambda ph: resolve_spec(ph, mesh, fsdp=fsdp, zero1=zero1),
                    placeholders)


def axis_size(mesh: Mesh, axis) -> int:
    """Devices along a spec entry: an axis name, a tuple of names (their
    product), or None (1)."""
    if axis is None:
        return 1
    if isinstance(axis, tuple):
        return math.prod(mesh.shape[a] for a in axis)
    return mesh.shape[axis]


def fix_spec_for_shape(shape: Tuple[int, ...], spec: Spec,
                       mesh: Mesh) -> Spec:
    """Every sharded dimension must divide by its axes' extent; where a
    config dimension (24 heads, a 51,866 vocab, ...) does not, move the
    axes to the last still-unsharded dimension of the tensor that divides
    and is at least as large (e.g. heads -> head_dim), else drop them
    (replicate).  The result has one entry a dimension."""
    entries = list(spec) + [None] * (len(shape) - len(spec))
    out = list(entries)
    for i, ax in enumerate(entries):
        if ax is None:
            continue
        size = axis_size(mesh, ax)
        if shape[i] % size == 0:
            continue
        out[i] = None
        for j in range(len(shape) - 1, -1, -1):
            if out[j] is None and j != i and shape[j] % size == 0 \
                    and shape[j] >= size:
                out[j] = ax
                break
    return tuple(out)


def fix_spec_tree(shape_tree: Tree, spec_tree: Tree, mesh: Mesh) -> Tree:
    """Map :func:`fix_spec_for_shape` over matching trees of shapes (or
    of anything with a ``.shape``: tensors, ParamDefs) and specs."""
    def fix(node, spec):
        if isinstance(node, dict):
            return {k: fix(node[k], spec[k]) for k in node}
        return fix_spec_for_shape(tuple(getattr(node, "shape", node)), spec,
                                  mesh)
    return fix(shape_tree, spec_tree)
