"""What one step of a cell needs on a device, traced on ``meta`` tensors
(``launch/dryrun.py``'s memory, cost and collectives; ROADMAP A.17 item
6).  The step runs as it runs on the card, on tensors with shapes and no
storage: nothing is computed, nothing is allocated, CUDA is not touched.

* :class:`StepTrace`, a dispatch mode, sees every aten operation of the
  step.  Each new ``meta`` storage adds its bytes to the live
  sum; a finalizer on the storage takes them off when it dies.  The
  maximum of that sum is the step's peak, in requested bytes as the
  caching allocator's ``requested_bytes`` counts them, and in the
  allocator's 512-byte blocks.  What a CUDA kernel allocates inside an
  operation (a reduction's staging, a sort's scratch) is not seen; the
  backward formulas that a dispatch mode turns functional run in place,
  as the step runs them without it (:data:`_IN_PLACE`).  With
  ``cost=True`` it also sums the operations of the matmul family
  (``torch.utils.flop_counter``'s formulas), the operations the
  hand-written kernels' meta routes report (``kernels/_build.meta_call``),
  and the bytes every non-view operation reads and writes.  A
  functional call seen before on arguments of the same shapes gets
  outputs of its kept shapes and its kept cost without running its meta
  kernel, which cuts a sweep's time by about two thirds; a call whose
  output lies on an argument's storage is a view, and is not kept.
* :class:`CountingComm` stands for one rank of a mesh of any size in one
  process: it has the rank and the world size and no process group, and
  its group collectives return results of the shapes
  ``core.comm.DistributedComm`` returns, on ``meta``, one new tensor a
  call as the host-staged transport allocates them, while it keeps
  ``DistributedComm``'s ``calls`` and ``bytes`` counters and the
  reference's wire bytes by kind (:meth:`CountingComm.collective_bytes`).
"""

from __future__ import annotations

import collections
import time
import weakref
from typing import Any, Dict, Iterable, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from ..kernels import _build

#: the caching allocator's block size: every request is rounded up to it
BLOCK = 512

#: the reference's collective kinds (``repro/launch/dryrun.py``); the
#: LM steps' ``all_gather_group``, ``all_reduce`` and ``reduce_scatter``
#: are the first three
KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
         "collective-permute")

#: operations that allocate and touch no memory
_NO_BYTES = {torch.ops.aten.empty.memory_format,
             torch.ops.aten.empty_strided.default,
             torch.ops.aten.empty_like.default}

#: autograd's formulas for the backward of ``gather``, indexing,
#: ``index_select`` and the value-selecting reductions make a zero tensor
#: and write the gradient into it in place; while a dispatch mode is on
#: (``at::areAnyTensorSubclassLike``) they call the functional overload
#: instead, which holds a second buffer of the zeros' size.  Under
#: :class:`StepTrace` that call runs as the in-place overload the step
#: runs without the mode.
_IN_PLACE = {
    torch.ops.aten.scatter_add.default: torch.ops.aten.scatter_add_.default,
    torch.ops.aten.scatter.src: torch.ops.aten.scatter_.src,
    torch.ops.aten.index_add.default: torch.ops.aten.index_add_.default,
    torch.ops.aten.index_put.default: torch.ops.aten.index_put_.default}
_ZEROS = {torch.ops.aten.new_zeros.default, torch.ops.aten.zeros.default,
          torch.ops.aten.zeros_like.default}


def blocks(nbytes: int) -> int:
    """``nbytes`` rounded up to the allocator's :data:`BLOCK`."""
    return -(-nbytes // BLOCK) * BLOCK


def tensors_of(tree) -> Iterable[torch.Tensor]:
    """Every tensor in a tree of dicts, lists and tuples (a
    ``StoredLeaf``'s shard included)."""
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from tensors_of(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from tensors_of(v)
    elif hasattr(tree, "shard"):
        yield from tensors_of(tree.shard)


def _flat(args) -> Iterable[torch.Tensor]:
    for a in args:
        if isinstance(a, torch.Tensor):
            yield a
        elif isinstance(a, (list, tuple)):
            yield from (t for t in a if isinstance(t, torch.Tensor))


_FUNCTIONAL: Dict[Any, bool] = {}


def _functional(func) -> bool:
    """An operation that writes none of its arguments and returns new
    tensors (no view, no alias of an input)."""
    known = _FUNCTIONAL.get(func)
    if known is None:
        schema = func._schema
        known = not (func.is_view or schema.is_mutable or any(
            r.alias_info is not None for r in schema.returns)) and all(
            str(r.type) in ("Tensor", "Tensor[]", "Tensor?")
            for r in schema.returns)
        _FUNCTIONAL[func] = known
    return known


_COMPOSITE: Dict[Any, bool] = {}


def _composite(func) -> bool:
    """An operation whose kernel is its decomposition into others."""
    known = _COMPOSITE.get(func)
    if known is None:
        known = torch._C._dispatch_has_kernel_for_dispatch_key(
            func.name(), "CompositeImplicitAutograd")
        _COMPOSITE[func] = known
    return known


def _describe(args):
    """A hashable account of arguments: a tensor by its shape, strides,
    dtype and device, a list by its items, anything else as it is."""
    out = []
    for a in args:
        if isinstance(a, torch.Tensor):
            out.append((tuple(a.shape), a.stride(), a.dtype,
                        a.device.type))
        elif isinstance(a, (list, tuple)):
            out.append(tuple(_describe(a)))
        else:
            out.append(a)
    return tuple(out)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _outputs(out) -> list:
    return [out] if isinstance(out, torch.Tensor) else list(_flat(
        out if isinstance(out, (list, tuple)) else ()))


def _aliases(args, kwargs, out) -> bool:
    """Whether an output shares an argument's storage, which some
    operations whose schema declares no alias do (``_unsafe_view``)."""
    ins = {t.untyped_storage()._cdata
           for t in _flat(list(args) + list(kwargs.values()))}
    return any(t.untyped_storage()._cdata in ins for t in _outputs(out))


def _exact(t: torch.Tensor) -> bool:
    """Whether ``t``'s storage is the one ``empty_strided`` makes for its
    shape and strides (no offset, no spare bytes)."""
    span = 0 if t.numel() == 0 else 1 + sum(
        (n - 1) * st for n, st in zip(t.shape, t.stride()))
    return t.storage_offset() == 0 and \
        t.untyped_storage().nbytes() == span * t.element_size()


class StepTrace(TorchDispatchMode):
    """Live ``meta`` storages while the mode is on.

    ``hold(tree)`` counts tensors that exist before the step (its
    arguments).  After the step: ``peak`` / ``peak_blocks`` the most bytes
    live at once (requested; in 512-byte blocks), ``live`` /
    ``live_blocks`` what is live now, ``written`` the held storages an
    operation wrote in place, and with ``cost`` ``flops``, ``bytes`` and
    ``kernels`` (name -> (calls, operations)).  ``cache=False`` runs
    every operation's meta kernel, none from the kept shapes."""

    def __init__(self, cost: bool = True, cache: bool = True):
        super().__init__()
        self.cost = cost
        self.cache = cache
        self._live: Dict[int, int] = {}
        self._held: Dict[int, int] = {}
        self.written: Dict[int, int] = {}
        self.live = self.peak = self.live_blocks = self.peak_blocks = 0
        self.flops = 0.0
        self.bytes = 0.0
        self.kernels: Dict[str, list] = collections.defaultdict(
            lambda: [0, 0.0])
        self._depth = 0
        # functional calls seen: key -> (output shapes, flops, bytes)
        self._kept: Dict[Any, tuple] = {}
        # the zeros the operation just before made (a weak reference)
        self._zeros = None

    # -- storages ---------------------------------------------------------

    def _key(self, t: torch.Tensor) -> Optional[int]:
        if t.device.type != "meta":
            return None
        st = t.untyped_storage()
        key = st._cdata
        if key not in self._live:
            n = st.nbytes()
            self._live[key] = n
            self.live += n
            self.live_blocks += blocks(n)
            self.peak = max(self.peak, self.live)
            self.peak_blocks = max(self.peak_blocks, self.live_blocks)
            weakref.finalize(st, self._free, key)
        return key

    def _free(self, key: int) -> None:
        n = self._live.pop(key)
        self.live -= n
        self.live_blocks -= blocks(n)
        self._held.pop(key, None)

    def hold(self, tree) -> int:
        """Count every tensor of ``tree`` as live (the step's arguments);
        returns their storages' bytes, each counted once."""
        total = 0
        for t in tensors_of(tree):
            key = self._key(t)
            if key is not None and key not in self._held:
                self._held[key] = self._live[key]
                total += self._live[key]
        return total

    def new_bytes(self, tree) -> int:
        """Bytes of the distinct ``meta`` storages of ``tree`` that were
        not held (what a step returns anew)."""
        seen = set()
        total = 0
        for t in tensors_of(tree):
            if t.device.type != "meta":
                continue
            key = t.untyped_storage()._cdata
            if key in seen or key in self._held:
                continue
            seen.add(key)
            total += t.untyped_storage().nbytes()
        return total

    # -- the dispatch ----------------------------------------------------

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if _composite(func):
            # under inference_mode a composite operation (matmul, einsum,
            # softmax) comes here whole: run its decomposition under the
            # mode, so its own operations and their storages are seen
            with self:
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
        zeros, self._zeros = self._zeros, None
        if func in _IN_PLACE and zeros is not None and zeros() is args[0] \
                and torch._C._current_graph_task_id() != -1:
            # a backward formula's write into the zeros it just made
            func = _IN_PLACE[func]
        key = self._cache_key(func, args, kwargs)
        kept = None if key is None else self._kept.get(key)
        if kept is not None:
            # a functional operation seen before on arguments of the same
            # shapes: fresh outputs of its kept shapes, and its kept cost
            (single, kind, metas), flops, nbytes = kept
            outs = [None if m is None else torch.empty_strided(
                m[0], m[1], dtype=m[2], device="meta") for m in metas]
            out = outs[0] if single else kind(outs)
            self.flops += flops
            self.bytes += nbytes
        else:
            out = func(*args, **kwargs)
            if self._held and func._schema.is_mutable:
                self._note_writes(func, args, kwargs)
            # an output on an argument's storage makes the call a view
            view = _functional(func) and _aliases(args, kwargs, out)
            flops, nbytes = self._cost(func, args, kwargs, out, view) \
                if self.cost else (0, 0)
            self.flops += flops
            self.bytes += nbytes
            if key is not None and not view:
                self._keep(key, out, flops, nbytes)
        if isinstance(out, torch.Tensor):
            self._key(out)
            if func in _ZEROS:
                self._zeros = weakref.ref(out)
        elif isinstance(out, (list, tuple)):
            for t in _flat(out):
                self._key(t)
        return out

    def _cache_key(self, func, args, kwargs):
        """The key of a functional operation's call by its arguments'
        shapes, strides, dtypes and devices and its other arguments (a
        meta kernel reads nothing else; many run in Python), or None
        where the call is not kept (``cache=False``, an operation that
        writes or aliases, an argument that does not hash)."""
        if not (self.cache and _functional(func)):
            return None
        try:
            key = (func, _describe(args), _describe(tuple(kwargs.items())))
            hash(key)
        except TypeError:
            return None
        return key

    def _keep(self, key, out, flops: float, nbytes: float) -> None:
        """Keep a call's output shapes and cost where every output is a
        ``meta`` tensor on a storage of its own extent (or None)."""
        outs = [out] if isinstance(out, torch.Tensor) else out
        if not (isinstance(outs, (list, tuple)) and all(
                t is None or (isinstance(t, torch.Tensor)
                              and t.device.type == "meta" and _exact(t))
                for t in outs)):
            return
        metas = tuple(None if t is None else
                      (tuple(t.shape), t.stride(), t.dtype) for t in outs)
        single = isinstance(out, torch.Tensor)
        self._kept[key] = ((single, None if single else type(out), metas),
                           flops, nbytes)

    def _note_writes(self, func, args, kwargs) -> None:
        for i, a in enumerate(func._schema.arguments):
            info = a.alias_info
            if info is None or not info.is_write:
                continue
            val = args[i] if i < len(args) else kwargs.get(a.name)
            for t in _flat([val]):
                if t.device.type != "meta":
                    continue
                key = t.untyped_storage()._cdata
                if key in self._held:
                    self.written[key] = self._held[key]

    def _cost(self, func, args, kwargs, out,
              view: bool = False) -> Tuple[float, float]:
        """(flops, bytes) of one operation: the matmul family's by
        ``torch.utils.flop_counter``'s formulas, and every operand and
        ``meta`` result (none for a view or a bare allocation)."""
        formula = flop_registry.get(func.overloadpacket)
        flops = formula(*args, **kwargs, out_val=out) \
            if formula is not None else 0
        if view or func.is_view or func in _NO_BYTES:
            return flops, 0
        touched = [t for t in _flat(list(args) + list(kwargs.values()))
                   if t.device.type == "meta"]
        return flops, sum(_nbytes(t) for t in touched) + sum(
            _nbytes(t) for t in _outputs(out) if t.device.type == "meta")

    def kernel(self, name: str, operations: float, inputs, outputs) -> None:
        """A hand-written kernel's meta route (``_build.meta_observers``):
        its operations and the bytes it reads and writes."""
        self.kernels[name][0] += 1
        self.kernels[name][1] += operations
        self.flops += operations
        self.bytes += sum(_nbytes(t) for t in inputs) + sum(
            _nbytes(t) for t in outputs)

    def __enter__(self):
        if self.cost and not self._depth:
            _build.meta_observers.append(self.kernel)
        self._depth += 1
        return super().__enter__()

    def __exit__(self, *exc):
        self._depth -= 1
        if self.cost and not self._depth:
            _build.meta_observers.remove(self.kernel)
        return super().__exit__(*exc)


def _stage(x: torch.Tensor) -> None:
    """The device side of staging ``x`` to the host: a non-contiguous
    ``x`` is first copied whole on its device (a temporary, freed before
    the result comes back)."""
    if not x.is_contiguous():
        x.contiguous()


class _Group:
    """A process group of :class:`CountingComm`: its ranks, ascending."""

    def __init__(self, ranks):
        self.ranks = tuple(ranks)
        self.size = len(self.ranks)


class CountingComm:
    """One rank (``rank`` of ``world_size``) of a mesh, traced in one
    process: the collectives of ``core.comm.DistributedComm`` that the LM
    steps call, returning ``meta`` tensors of their results' shapes (as the host-staged transport brings them back: one new tensor a
    call), counted in ``calls`` and ``bytes`` as ``DistributedComm``
    counts them and, by the reference's kinds, in wire bytes
    (:meth:`collective_bytes`)."""

    def __init__(self, rank: int, world_size: int):
        if not 0 <= int(rank) < int(world_size):
            raise ValueError(f"rank {rank} is not in [0, {world_size})")
        self.rank = int(rank)
        self.P = int(world_size)
        self.local = range(self.rank, self.rank + 1)
        self.device = torch.device("meta")
        self.transport = "counted"
        self._groups: dict = {}
        self.bytes = {"gathered": 0, "reduced": 0}
        self.calls = {"all_gather_group": 0, "reduce_scatter": 0,
                      "all_reduce": 0}
        self.seconds = 0.0
        self.wire = {kind: 0 for kind in KINDS}

    def group(self, partition):
        """This rank's group of ``partition`` (``DistributedComm.group``):
        ``None`` for a group of one rank."""
        key = tuple(tuple(sorted(int(r) for r in g)) for g in partition)
        if key not in self._groups:
            mine = next(g for g in key if self.rank in g)
            self._groups[key] = None if len(mine) == 1 else _Group(mine)
        return self._groups[key]

    def _wire(self, kind: str, result: torch.Tensor, g: int) -> None:
        rbytes = _nbytes(result)
        if kind == "all-gather":
            wire = rbytes * (g - 1) // g
        elif kind == "all-reduce":
            wire = 2 * rbytes * (g - 1) // g
        else:                                   # reduce-scatter
            wire = rbytes * (g - 1)
        self.wire[kind] += wire

    def all_gather_group(self, x: torch.Tensor, group, n: int
                         ) -> torch.Tensor:
        """``[n, *x.shape]``, as ``DistributedComm.all_gather_group``."""
        if group is None:
            return x.unsqueeze(0)
        _stage(x)
        out = torch.empty((n, *x.shape), dtype=x.dtype, device=self.device)
        self.bytes["gathered"] += (n - 1) * _nbytes(x)
        self.calls["all_gather_group"] += 1
        self._wire("all-gather", out, n)
        return out

    def reduce_scatter(self, x: torch.Tensor, group, n: int) -> torch.Tensor:
        """The member's ``1/n`` of the leading axis, as
        ``DistributedComm.reduce_scatter``."""
        if group is None:
            return x
        _stage(x)
        out = torch.empty((x.shape[0] // n, *x.shape[1:]), dtype=x.dtype,
                          device=self.device)
        self.bytes["reduced"] += _nbytes(x)
        self.calls["reduce_scatter"] += 1
        self._wire("reduce-scatter", out, n)
        return out

    def all_reduce(self, x: torch.Tensor, group=None,
                   op: str = "sum") -> torch.Tensor:
        """A new tensor of ``x``'s shape, as ``DistributedComm.all_reduce``
        (every rank where ``group`` is None)."""
        if group is None and self.P == 1:
            return x
        if op not in ("sum", "max"):
            raise KeyError(op)
        _stage(x)
        out = torch.empty(x.shape, dtype=x.dtype, device=self.device)
        self.bytes["reduced"] += _nbytes(out)
        self.calls["all_reduce"] += 1
        self._wire("all-reduce", out, self.P if group is None else
                   group.size)
        return out

    def collective_bytes(self) -> Dict[str, int]:
        """The reference's ``collective_bytes`` record: per kind the wire
        bytes of this rank's collectives from each result's bytes and
        group size g (all-gather result (g-1)/g, all-reduce 2 result
        (g-1)/g, reduce-scatter result (g-1)), ``count`` and
        ``wire_total``."""
        out = dict(self.wire)
        out["count"] = sum(self.calls.values())
        out["wire_total"] = sum(self.wire.values())
        return out

    def counters(self) -> Dict[str, Dict[str, int]]:
        """``calls`` and ``bytes`` as ``DistributedComm`` keeps them."""
        return {"calls": dict(self.calls), "bytes": dict(self.bytes)}


def trace(step, args, *, cost: bool = True,
          cache: bool = True) -> Dict[str, Any]:
    """Run ``step(*args)`` under a :class:`StepTrace`, the arguments held
    live throughout.  Returns ``held`` (the arguments' bytes), ``peak`` /
    ``peak_blocks``, ``written`` (bytes of the argument storages the step
    updated in place), ``returned`` (bytes of new storages in the result),
    ``seconds``, and with ``cost`` ``flops``, ``bytes`` and ``kernels``."""
    t0 = time.perf_counter()
    mode = StepTrace(cost=cost, cache=cache)
    held = mode.hold(args)
    with mode:
        out = step(*args)
        returned = mode.new_bytes(out)
    record = {"held": held, "peak": mode.peak,
              "peak_blocks": mode.peak_blocks,
              "written": sum(mode.written.values()), "returned": returned,
              "seconds": time.perf_counter() - t0}
    if cost:
        record.update(flops=mode.flops, bytes=mode.bytes,
                      kernels={k: tuple(v) for k, v in mode.kernels.items()})
    del out
    return record
