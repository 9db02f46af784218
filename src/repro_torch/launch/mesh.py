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

:func:`make_mesh` binds a mesh to devices: one device as it is, or a
mesh of more devices to a ``core.comm.DistributedComm`` of as many ranks
(ROADMAP.md A.15c), rank r at the row-major coordinate of r in the mesh
shape (the order ``jax.make_mesh`` gives devices).  A bound mesh moves a
tensor laid out by a spec: :func:`shard_tree` cuts full tensors to the
rank's shards, :func:`gather_leaf` puts a shard back together, and
:meth:`Mesh.reduce_grad` sums a gradient over the ranks that computed
parts of it and keeps the rank's shard; an axis tuple shards in the
tuple's row-major order, as XLA's does.  :attr:`Mesh.dp` is the
data-parallel group the models' ``comm=`` arguments take.

Tensor-parallel compute (ROADMAP A.15d(1)): :func:`leaf_plan` says, from
a leaf's path and resolved spec alone, whether a layer computes with the
rank's own "model" shard of it (``"split"``: the shard falls on the
dimension the layer splits, heads, MLP columns or rows, experts or the
vocabulary), with the whole leaf gathered over "model" of which it takes
its own part (``"gathered"``), or with a leaf the spec does not shard
over "model" at all (``"replicated"``).  :attr:`Mesh.tp` is the rank's
"model" group, whose autograd collectives (:class:`TensorParallel`) the
models call: a gather along the sequence whose backward reduce-scatters,
a reduce-scatter whose backward gathers, an all-reduce whose backward is
the identity and the identity whose backward all-reduces.  At decode
(ROADMAP A.15d(2)) a step carries one token a row, so the residual stream
is whole on every "model" rank: :attr:`Mesh.tp_decode` is the same group
in its decode mode, where the sequence gather is the identity and the
sequence reduce-scatter a sum over "model".
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional, Tuple

import torch

from ..core.comm import resolve_device
from ..models.common import Tree, tree_leaves, tree_map

#: the reference config's tensor-parallel axis
TP_AXIS = "model"

Spec = Tuple[Any, ...]


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Axis names and sizes of a device mesh (``device`` set where
    :func:`make_mesh` bound it; ``comm`` the ranks of a bound mesh of more
    than one device)."""
    axis_names: Tuple[str, ...]
    axis_sizes: Tuple[int, ...]
    device: Optional[Any] = None
    comm: Optional[Any] = dataclasses.field(default=None, compare=False,
                                            repr=False)

    def __post_init__(self):
        if len(self.axis_names) != len(self.axis_sizes):
            raise ValueError(f"{len(self.axis_names)} axis names for "
                             f"{len(self.axis_sizes)} sizes")
        # :meth:`group`'s answers, by axes (a bound mesh's never change)
        object.__setattr__(self, "_groups", {})

    @property
    def shape(self) -> dict:
        """Axis name -> size (``jax.sharding.Mesh.shape``)."""
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        """Devices in the mesh."""
        return math.prod(self.axis_sizes)

    @property
    def coords(self) -> dict:
        """Axis name -> this rank's coordinate (row-major: the last axis
        varies fastest); all 0 on a mesh without ranks."""
        r = self.comm.rank if self.comm is not None else 0
        out = {}
        for name, size in reversed(list(zip(self.axis_names,
                                            self.axis_sizes))):
            out[name] = r % size
            r //= size
        return {a: out[a] for a in self.axis_names}

    def _axes(self, entry) -> Tuple[str, ...]:
        axes = () if entry is None else \
            (entry if isinstance(entry, tuple) else (entry,))
        order = [self.axis_names.index(a) for a in axes]
        if order != sorted(order):
            raise ValueError(f"axes {axes} are not in the mesh's order "
                             f"{self.axis_names}")
        return axes

    def index(self, entry) -> Tuple[int, int]:
        """(devices along a spec entry, this rank's index among them:
        row-major over the entry's axes in their order)."""
        axes = self._axes(entry)
        c = self.coords
        index = 0
        for a in axes:
            index = index * self.shape[a] + c[a]
        return axis_size(self, axes), index

    def group(self, entry):
        """(process group, size, this rank's index) of a spec entry: the
        ranks that share this rank's coordinates off the entry's axes,
        indexed as :meth:`index` does.  The group is None where the entry
        spans one device."""
        axes = self._axes(entry)
        known = self._groups.get(axes)
        if known is not None:
            return known
        size, index = self.index(entry)
        if size == 1 or self.comm is None:
            return None, size, index
        parts: dict = {}
        for rank in range(self.size):
            rest, r = [], rank
            for name, sz in reversed(list(zip(self.axis_names,
                                              self.axis_sizes))):
                if name not in axes:
                    rest.append(r % sz)
                r //= sz
            parts.setdefault(tuple(rest), []).append(rank)
        known = self.comm.group(list(parts.values())), size, index
        self._groups[axes] = known
        return known

    def is_dp(self, entry) -> bool:
        """True where a spec entry's axes are all data-parallel ones;
        an entry mixing them with others raises."""
        axes = self._axes(entry)
        dp = [a in dp_axes(self) for a in axes]
        if any(dp) and not all(dp):
            raise ValueError(f"spec entry {entry} mixes data-parallel and "
                             f"other axes")
        return bool(axes) and all(dp)

    def cut(self, t, spec: Spec):
        """This rank's block of a full ``t`` (tensor or numpy array) laid
        out by ``spec``: a view, on the host where ``t`` is."""
        shard = self.shard_shape(tuple(t.shape), spec)
        idx = []
        for n, entry in zip(shard, _entries(spec, len(shard))):
            i = self.index(entry)[1]
            idx.append(slice(i * n, (i + 1) * n))
        return t[tuple(idx)]

    def shard_shape(self, shape: Tuple[int, ...], spec: Spec
                    ) -> Tuple[int, ...]:
        """The shape of a rank's block of a full tensor of ``shape`` laid
        out by ``spec`` (:meth:`cut`'s); a dimension that does not divide
        by its entry's devices raises ``ValueError``."""
        out = []
        for d, entry in enumerate(_entries(spec, len(shape))):
            size = axis_size(self, self._axes(entry))
            if shape[d] % size:
                raise ValueError(f"dimension {d} of {tuple(shape)} does "
                                 f"not divide by {entry}'s {size}")
            out.append(shape[d] // size)
        return tuple(out)

    def gather(self, t: torch.Tensor, spec: Spec) -> torch.Tensor:
        """The inverse of :meth:`cut`: ``t`` put back together along every
        dimension ``spec`` shards, a group all-gather per dimension."""
        for d, entry in enumerate(_entries(spec, t.dim())):
            g, size, _i = self.group(entry)
            if g is None:
                continue
            parts = self.comm.all_gather_group(t, g, size)
            t = torch.cat(list(parts.unbind(0)), dim=d)
        return t

    def reduce_grad(self, g: torch.Tensor, spec: Spec,
                    plan: str) -> torch.Tensor:
        """The rank's float32 shard, laid out by ``spec``, of the sum over
        the ranks of their gradients ``g`` of a leaf the layers used as
        ``plan`` (:func:`leaf_plan`) says.  A ``"split"`` leaf's ``g`` is
        already the rank's "model" shard; a ``"gathered"`` leaf's is
        full-size and partial over "model" (each rank used its own part),
        so it is reduce-scattered over "model" first.  Then a dimension
        the dp axes shard is reduce-scattered over them, and dp axes that
        shard no dimension are all-reduced.  A ``"replicated"`` leaf's
        "model" sum is left to the caller (:meth:`sum_flat`, many leaves
        in one buffer)."""
        entries = _entries(spec, g.dim())
        g = g.float()
        if plan == "gathered":
            for d, entry in enumerate(entries):
                if entry is None or self.is_dp(entry):
                    continue
                grp, size, _i = self.group(entry)
                if grp is not None:
                    g = self.comm.reduce_scatter(
                        g.movedim(d, 0).contiguous(), grp, size
                    ).movedim(0, d)
        used = set()
        for d, entry in enumerate(entries):
            if not self.is_dp(entry):
                continue
            used.update(self._axes(entry))
            grp, size, _i = self.group(entry)
            if grp is not None:
                g = self.comm.reduce_scatter(g.movedim(d, 0).contiguous(),
                                             grp, size).movedim(0, d)
        rest = tuple(a for a in dp_axes(self) if a not in used)
        grp, _size, _i = self.group(rest)
        if grp is not None:
            g = self.comm.all_reduce(g.contiguous(), grp)
        return g.contiguous()

    def sum_flat(self, tensors, axes: Tuple[str, ...]) -> None:
        """Sum float32 ``tensors`` over the ranks along ``axes``, in place,
        through one buffer and one all-reduce."""
        grp, _size, _i = self.group(tuple(a for a in self.axis_names
                                          if a in axes))
        tensors = list(tensors)
        if grp is None or not tensors:
            return
        flat = self.comm.all_reduce(
            torch.cat([t.reshape(-1) for t in tensors]), grp)
        for t, part in zip(tensors, flat.split([t.numel()
                                                for t in tensors])):
            t.copy_(part.view(t.shape))

    @property
    def dp(self) -> "DataParallel":
        """The data-parallel group of this rank (``comm=`` of the
        models' loss and MoE layer)."""
        return DataParallel(self)

    @property
    def tp(self) -> Optional["TensorParallel"]:
        """The rank's "model" group (``tp=`` of the models), or None where
        the mesh has no ranks or "model" spans one device."""
        if self.comm is None or self.shape.get(TP_AXIS, 1) == 1:
            return None
        return TensorParallel(self)

    @property
    def tp_decode(self) -> Optional["TensorParallel"]:
        """:attr:`tp` in its decode mode (``seq=False``): the residual
        stream whole on every rank along "model"."""
        if self.comm is None or self.shape.get(TP_AXIS, 1) == 1:
            return None
        return TensorParallel(self, seq=False)

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of ``t`` over every rank of the mesh."""
        return t if self.comm is None else self.comm.all_reduce(t)


class DataParallel:
    """The ranks that hold other rows of the batch (the dp axes): their
    number ``size``, this rank's ``index`` (its rows' place in the global
    batch), ``sum`` (all-reduce), ``max`` and ``gather`` (all-gather onto
    a new leading axis in index order).  At decode with a batch the dp
    extent does not divide, the same ranks hold other slots of the KV
    cache instead (``models.attention.decode_attention``'s ``seq``)."""

    def __init__(self, mesh: Mesh):
        self._group, self.size, self.index = mesh.group(dp_axes(mesh))
        self._comm = mesh.comm

    def sum(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` summed over the group's ranks."""
        if self._group is None:
            return t
        return self._comm.all_reduce(t, self._group)

    def max(self, t: torch.Tensor) -> torch.Tensor:
        """The elementwise maximum of ``t`` over the group's ranks."""
        if self._group is None:
            return t
        return self._comm.all_reduce(t, self._group, op="max")

    def gather(self, t: torch.Tensor) -> torch.Tensor:
        """The ranks' ``t`` on a new leading axis, in index order."""
        if self._group is None:
            return t.unsqueeze(0)
        return self._comm.all_gather_group(t, self._group, self.size)


class TensorParallel:
    """The ranks along "model" that share this rank's other coordinates:
    their number ``size`` and this rank's ``index``.  Between blocks each
    holds its ``1/size`` of the sequence (rows ``index * T / size`` on);
    inside a block each computes its own heads, columns, experts or
    vocabulary slice.  The collectives are autograd-aware: where a
    block's replicated input feeds the rank's own part, its gradient
    there is partial, and the conjugate collective sums it.  Partial sums
    travel in their own dtype: a bf16 block's in bf16, which with two
    ranks rounds the sum once, as a float32 sum cast back would.

    With ``seq=False`` (decode, :attr:`Mesh.tp_decode`) every rank holds
    the whole residual stream: :meth:`gather_seq` and :meth:`own` return
    ``x`` as it is and :meth:`scatter_seq` is :meth:`reduce`, so a block
    computes its own heads, columns or experts of the whole input and
    sums its partial output over "model"."""

    def __init__(self, mesh: Mesh, seq: bool = True):
        self._group, self.size, self.index = mesh.group(TP_AXIS)
        self._comm = mesh.comm
        self.seq = seq

    def gather_seq(self, x: torch.Tensor, dim: int = 1) -> torch.Tensor:
        """The ranks' ``x`` concatenated along ``dim`` in index order;
        backward: the reduce-scatter of the gradient along ``dim``.  At
        decode: ``x``."""
        if not self.seq:
            return x
        return _GatherSeq.apply(x, self, dim)

    def scatter_seq(self, x: torch.Tensor, dim: int = 1) -> torch.Tensor:
        """The rank's ``1/size`` along ``dim`` of the sum of the ranks'
        ``x`` (partial sums); backward: the gather along ``dim``.  At
        decode: the sum of the ranks' ``x``."""
        if not self.seq:
            return self.reduce(x)
        return _ScatterSeq.apply(x, self, dim)

    def reduce(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of the ranks' ``x``; backward: the identity (what
        follows is computed whole on every rank)."""
        return _Reduce.apply(x, self)

    def copy(self, x: torch.Tensor) -> torch.Tensor:
        """``x``; backward: the sum of the ranks' gradients (what follows
        is each rank's own part)."""
        return _Copy.apply(x, self)

    def max(self, x: torch.Tensor) -> torch.Tensor:
        """The elementwise maximum of the ranks' ``x`` (no gradient)."""
        return self._comm.all_reduce(x.detach(), self._group, op="max")

    def own(self, x: torch.Tensor, dim: int = 1) -> torch.Tensor:
        """The rank's ``1/size`` of ``x`` along ``dim`` (a view); at
        decode ``x`` itself."""
        if not self.seq:
            return x
        n = x.shape[dim] // self.size
        if n * self.size != x.shape[dim]:
            raise ValueError(f"{x.shape[dim]} rows along dimension {dim} do "
                             f"not divide by the {self.size} ranks along "
                             f"'{TP_AXIS}'")
        return x.narrow(dim, self.index * n, n)

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """The ranks' ``x`` on a new leading axis in index order (no
        gradient)."""
        return self._comm.all_gather_group(x.detach(), self._group,
                                           self.size)

    def _cat(self, x, dim):
        parts = self._comm.all_gather_group(x.contiguous(), self._group,
                                            self.size)
        return torch.cat(list(parts.unbind(0)), dim=dim)

    def _sum_scatter(self, x, dim):
        if x.shape[dim] % self.size:
            raise ValueError(f"{x.shape[dim]} rows along dimension {dim} do "
                             f"not divide by the {self.size} ranks along "
                             f"'{TP_AXIS}'")
        out = self._comm.reduce_scatter(x.movedim(dim, 0).contiguous(),
                                        self._group, self.size)
        return out.movedim(0, dim).contiguous()

    def _sum(self, x):
        return self._comm.all_reduce(x.contiguous(), self._group)


class _GatherSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp, dim):
        ctx.tp, ctx.dim = tp, dim
        return tp._cat(x, dim)

    @staticmethod
    def backward(ctx, g):
        return ctx.tp._sum_scatter(g, ctx.dim), None, None


class _ScatterSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp, dim):
        ctx.tp, ctx.dim = tp, dim
        return tp._sum_scatter(x, dim)

    @staticmethod
    def backward(ctx, g):
        return ctx.tp._cat(g, ctx.dim), None, None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        return tp._sum(x)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.tp._sum(g), None


def _entries(spec: Spec, ndim: int):
    return tuple(spec) + (None,) * (ndim - len(spec))


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The production dry-run mesh as a record with no device: 256
    devices ``(data=16, model=16)``, or 512 over two pods ``(pod=2,
    data=16, model=16)``, "pod" extending data parallelism across the
    pods."""
    if multi_pod:
        return Mesh(("pod", "data", "model"), (2, 16, 16))
    return Mesh(("data", "model"), (16, 16))


def make_mesh(shape: Tuple[int, ...], axes: Tuple[str, ...],
              device=None, comm=None) -> Mesh:
    """A mesh of ``shape`` over ``axes``.  One device: on ``device`` (the
    CUDA device unless the caller says otherwise), with or without a
    comm.  More: bound to ``comm``, a ``core.comm.DistributedComm`` with
    as many ranks, on the rank's device (rank r at the row-major
    coordinate of r).  A larger mesh without a comm, or sizes that
    disagree, raise ``ValueError``."""
    mesh = Mesh(tuple(axes), tuple(int(s) for s in shape))
    if mesh.size == 1:
        return dataclasses.replace(mesh, device=resolve_device(
            device if comm is None or device is not None else comm.device))
    if comm is None or not hasattr(comm, "rank"):
        raise ValueError(
            f"a mesh of {mesh.size} devices {mesh.shape} runs one process "
            f"per device: pass a core.comm.DistributedComm of "
            f"{mesh.size} ranks")
    if comm.P != mesh.size:
        raise ValueError(f"a mesh of {mesh.size} devices {mesh.shape} on "
                         f"a comm of {comm.P} ranks")
    mesh = dataclasses.replace(mesh, device=comm.device, comm=comm)
    # every group of every set of axes, made here in one order on every
    # rank (``dist.new_group`` needs all ranks; a step's first use may be
    # on the autograd or the data pipeline's thread)
    names = mesh.axis_names
    for bits in range(1, 1 << len(names)):
        mesh.group(tuple(a for i, a in enumerate(names) if bits >> i & 1))
    return mesh


def parse_mesh(spec: str) -> Tuple[Tuple[int, ...], Tuple[str, ...]]:
    """``"data=2,model=2"`` -> ((2, 2), ("data", "model"))."""
    names, sizes = zip(*(kv.split("=") for kv in spec.split(",")))
    return tuple(int(s) for s in sizes), tuple(n.strip() for n in names)


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


#: the dimension of a leaf a layer splits over "model", by the leaf's
#: name and the name of the block that holds it; the fused Mamba2 leaves
#: (``in_proj``'s [z | x | B | C | dt] columns, ``conv_w`` / ``conv_b``'s
#: [x | B | C] channels) have none: a contiguous cut of them is no
#: rank's heads
_ATTN_SPLIT = {"wq": 1, "wk": 1, "wv": 1, "wo": 0}
_MLP_SPLIT = {"wi": 1, "wg": 1, "wo": 0}
SPLIT_DIMS = {
    "": {"embed": 0, "unembed": 1},
    "attn": _ATTN_SPLIT, "self_attn": _ATTN_SPLIT, "cross_attn": _ATTN_SPLIT,
    "mlp": _MLP_SPLIT, "shared": _MLP_SPLIT,
    "moe": {"wi": 0, "wg": 0, "wo": 0},
    "ssm": {"out_proj": 0},
}


def split_dim(path: Tuple[str, ...]) -> Optional[int]:
    """The dimension a layer splits over "model" of the leaf at ``path``
    (a layer's view, without the stacked layer axis), or None."""
    block = path[-2] if len(path) > 1 else ""
    return SPLIT_DIMS.get(block, {}).get(path[-1])


def leaf_plan(path: Tuple[str, ...], spec: Spec, mesh: Mesh, *,
              ssm_heads: int = 0) -> str:
    """How the layers use the leaf at ``path`` laid out by ``spec`` (its
    resolved, shape-fitted spec as one layer sees it): ``"split"`` where
    "model" shards exactly the dimension the layer splits (a Mamba2
    ``out_proj`` also needs whole heads a rank: ``ssm_heads`` divisible by
    the extent), ``"gathered"`` where "model" shards another dimension
    (:func:`fix_spec_for_shape` moved it, or the leaf is a fused one), and
    ``"replicated"`` where "model" shards none.  Decided from the spec
    alone, on any mesh."""
    dims = [d for d, entry in enumerate(spec)
            if entry is not None and TP_AXIS in mesh._axes(entry)]
    if not dims:
        return "replicated"
    want = split_dim(path)
    if dims != [want]:
        return "gathered"
    if path[-1] == "out_proj" and ssm_heads % mesh.shape[TP_AXIS]:
        return "gathered"
    return "split"


def shard_tree(tree: Tree, spec_tree: Tree, mesh: Mesh) -> Tree:
    """The rank's shard of every leaf of a tree of full tensors, laid out
    by the matching spec: cut where the leaf is, then a contiguous copy on
    the mesh's device (never a view, which would keep the full leaf)."""
    specs = dict(tree_leaves(spec_tree))
    out: Tree = {}
    for path, t in tree_leaves(tree):
        node = out
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = mesh.cut(torch.as_tensor(t), specs[path]).to(
            mesh.device, copy=True, memory_format=torch.contiguous_format)
    return out


def gather_leaf(shard: torch.Tensor, spec: Spec, mesh: Mesh) -> torch.Tensor:
    """A full tensor from the ranks' shards laid out by ``spec``."""
    return mesh.gather(shard, spec)
