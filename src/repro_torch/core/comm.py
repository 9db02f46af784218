"""The comm layer: the port's stand-in for the reference's mesh.

The JAX package runs the P devices of a quorum axis as ``jax.shard_map``
over a mesh and moves blocks with ``lax.ppermute`` / ``lax.all_gather``
(``lax.axis_index`` names the device).  The port has two backends with one
interface:

  * :class:`SingleProcessComm` keeps all P devices in one process on one
    torch device; each collective is an index permutation of the leading
    axis.  It runs the same way on the CPU and on one GPU.
  * :class:`DistributedComm` runs one process per device over
    ``torch.distributed`` (rank r is device r), so each process holds only
    its own device's blocks.

``comm.P`` is the global device count and ``comm.local`` the global
indices of the devices this process holds (``range(P)``, or the rank's
own).  Every per-device tensor carries a leading axis of length
``len(comm.local)``, so call sites have one code path for both backends.
A host decision every device must share (an escalation, another pass)
reads every device's figures through ``comm.all_rows``; a one-to-all
send (the batcher's launches) is ``comm.broadcast``.  Both are the
identity in one process.  The LM steps on a mesh (``launch/mesh.py``)
move tensors over process groups of ranks (:meth:`DistributedComm.group`)
with ``all_gather_group`` / ``reduce_scatter`` / ``all_reduce``.

:func:`shard` / :func:`unshard` / :func:`pad_local` move ``[N, ...]`` data
in and out of the ``[len(local), block, ...]`` layout (a rank moves only
its own rows to its device), :func:`run_main` starts a selfcheck in one
process or as a torchrun rank, and :func:`schedule_from_numpy` carries a
schedule across from the reference so tests feed both packages the same
inputs.
"""

from __future__ import annotations

import datetime
import os
import time
from typing import Any, Callable, Union

import numpy as np
import torch
import torch.distributed as dist

from .scheduler import PairSchedule

__all__ = [
    "resolve_device",
    "SingleProcessComm",
    "DistributedComm",
    "Comm",
    "tree_map",
    "shard",
    "unshard",
    "pad_blocks",
    "pad_local",
    "run_main",
    "schedule_from_numpy",
]


def resolve_device(device=None) -> torch.device:
    """The torch device an entry point runs on: ``None`` means the CUDA
    device, and asking for CUDA where there is none raises (the port never
    drops to the CPU unless the caller asks for it)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "port on the CPU")
    return dev


def tree_map(fn: Callable[..., Any], tree, *rest):
    """Map ``fn`` over the tensor leaves of a tuple / list / dict payload,
    named tuples included (the pytrees the reference's gather and scatter
    move)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        leaves = [tree_map(fn, *ls) for ls in zip(tree, *rest)]
        if hasattr(tree, "_fields"):          # a NamedTuple
            return type(tree)(*leaves)
        return type(tree)(leaves)
    return fn(tree, *rest)


class SingleProcessComm:
    """P simulated devices on one torch device (ROADMAP A.2, first backend).

    Per-device tensors are stacked on a leading ``[P, ...]`` axis.
    """

    def __init__(self, P: int, device=None):
        if int(P) < 1:
            raise ValueError(f"P must be >= 1, got {P}")
        self.P = int(P)
        self.local = range(self.P)
        self.device = resolve_device(device)

    def local_rows(self, table):
        """The rows of a ``[P, ...]`` per-device table that this process
        holds: all of them."""
        return table

    def axis_index(self) -> torch.Tensor:
        """``lax.axis_index``: device i's own index, as a [P] tensor."""
        return torch.arange(self.P, device=self.device)

    def all_rows(self, x: torch.Tensor) -> torch.Tensor:
        """Every device's row of a small ``[P, ...]`` per-device tensor
        (counts, flags): the figures a host decision shared by all
        devices reads.  One process holds them all: ``x`` itself."""
        return x

    def broadcast(self, x: torch.Tensor, src: int = 0) -> torch.Tensor:
        """Process ``src``'s ``x`` on every process: one process is its
        own source, so ``x`` itself."""
        return x

    def ppermute(self, x: torch.Tensor, shift: int) -> torch.Tensor:
        """The cyclic shift of ``core/sweep.py:_shift_perm``: device i
        receives device ``(i + shift) % P``'s tensor."""
        s = int(shift) % self.P
        if s == 0:
            return x
        return torch.roll(x, -s, dims=0)

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """``lax.all_gather``: every device sees the whole ``[P, ...]``
        stack, so the result is ``[P (device), P (block), ...]`` (a
        broadcast view: one copy of the data stands for all P)."""
        return x.unsqueeze(0).expand(self.P, *x.shape)

    def __repr__(self) -> str:
        return f"SingleProcessComm(P={self.P}, device={self.device})"


#: how long a collective waits for a peer before the run fails
DIST_TIMEOUT = datetime.timedelta(seconds=300)


class DistributedComm:
    """One process per device over ``torch.distributed`` (ROADMAP A.15):
    rank r is device r, ``P`` is the world size, and every per-device
    tensor carries a leading axis of length 1.

    The caller names the transport, and nothing chooses another:

      * ``backend="gloo"`` moves CPU tensors as they are, and stages CUDA
        tensors through pinned host buffers (``transport`` says
        ``gloo, host-staged``): gloo carries no CUDA tensor through
        ``send`` / ``recv``, and it is the one way several ranks share one
        card, where NCCL refuses;
      * ``backend="nccl"`` moves CUDA tensors; where NCCL refuses (two
        ranks on one card, no CUDA) its error propagates.

    The device follows :func:`resolve_device`: the CUDA device unless the
    caller passes ``device="cpu"``; with several cards rank r takes
    ``cuda:(local_rank % count)``.  The process group is made here with an
    explicit ``timeout``, so a dead peer fails the run instead of hanging
    it; :meth:`close` destroys it.  :meth:`from_env` reads torchrun's
    environment; the constructor takes an explicit ``init_method`` (e.g. a
    ``file://`` store).
    """

    def __init__(self, backend: str, *, rank: int, world_size: int,
                 init_method: str, device=None, local_rank: int | None = None,
                 timeout: datetime.timedelta = DIST_TIMEOUT):
        if backend not in ("gloo", "nccl"):
            raise ValueError(f"backend must be 'gloo' or 'nccl', got "
                             f"{backend!r}")
        if not 0 <= int(rank) < int(world_size):
            raise ValueError(f"rank {rank} is not in [0, {world_size})")
        dev = resolve_device(device)
        if backend == "nccl" and dev.type != "cuda":
            raise ValueError(f"backend 'nccl' moves CUDA tensors; the device "
                             f"is {dev}")
        if dev.type == "cuda" and dev.index is None:
            lr = int(rank) if local_rank is None else int(local_rank)
            dev = torch.device("cuda", lr % torch.cuda.device_count())
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        dist.init_process_group(
            backend, init_method=init_method, rank=int(rank),
            world_size=int(world_size), timeout=timeout,
            **({"device_id": dev} if backend == "nccl" else {}))
        self.rank = int(rank)
        self.P = int(world_size)
        self.local = range(self.rank, self.rank + 1)
        self.device = dev
        self.staged = backend == "gloo" and dev.type == "cuda"
        self.transport = "gloo, host-staged" if self.staged else backend
        self._groups: dict = {}
        #: bytes this rank received in group gathers and sent into
        #: reductions (``reduce_scatter`` / ``all_reduce``)
        self.bytes = {"gathered": 0, "reduced": 0}
        #: how many of each of those collectives this rank took part in,
        #: and the host seconds spent in them: from the end of the
        #: device's queued work (host-staged) to the result, staging and
        #: waiting for the other members included
        self.calls = {"all_gather_group": 0, "reduce_scatter": 0,
                      "all_reduce": 0}
        self.seconds = 0.0

    @classmethod
    def from_env(cls, backend: str, device=None,
                 timeout: datetime.timedelta = DIST_TIMEOUT
                 ) -> "DistributedComm":
        """The comm of a process that torchrun started: ``RANK``,
        ``WORLD_SIZE``, ``LOCAL_RANK`` and ``MASTER_ADDR`` /
        ``MASTER_PORT`` from the environment."""
        env = os.environ
        missing = [k for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR",
                               "MASTER_PORT") if k not in env]
        if missing:
            raise RuntimeError(f"not started by torchrun: {missing} unset")
        return cls(backend, rank=int(env["RANK"]),
                   world_size=int(env["WORLD_SIZE"]), init_method="env://",
                   device=device,
                   local_rank=int(env.get("LOCAL_RANK", env["RANK"])),
                   timeout=timeout)

    def barrier(self) -> None:
        """Wait until every rank gets here."""
        dist.barrier()

    def close(self) -> None:
        """Destroy the process group."""
        if dist.is_initialized():
            dist.destroy_process_group()

    def local_rows(self, table):
        """``table[local]`` of a ``[P, ...]`` per-device table: the rank's
        own row, the counterpart of ``jnp.take(table, axis_index)``."""
        return table[self.rank:self.rank + 1]

    def axis_index(self) -> torch.Tensor:
        """``lax.axis_index``: this rank's index, as a [1] tensor."""
        return torch.tensor([self.rank], device=self.device)

    def _wire(self, x: torch.Tensor) -> torch.Tensor:
        """``x``'s bytes as a flat uint8 tensor the transport carries: a
        view where it can, else a copy (into pinned host memory for a
        host-staged CUDA tensor)."""
        flat = x.contiguous().reshape(-1).view(torch.uint8)
        if not self.staged:
            return flat
        host = torch.empty(flat.shape, dtype=torch.uint8, pin_memory=True)
        host.copy_(flat)
        return host

    def _unwire(self, buf: torch.Tensor, dtype, shape) -> torch.Tensor:
        """The inverse of :meth:`_wire`, on the comm's device."""
        out = buf.view(dtype).reshape(shape)
        return out.to(self.device) if self.staged else out

    def all_rows(self, x: torch.Tensor) -> torch.Tensor:
        """Every device's row of a small per-device tensor: this rank's
        ``[1, ...]`` -> ``[P, ...]`` in device order, through
        :meth:`all_gather`, so every rank takes a shared host decision
        (an escalation, another pass) on the same figures."""
        return self.all_gather(x)[0]

    def broadcast(self, x: torch.Tensor, src: int = 0) -> torch.Tensor:
        """Rank ``src``'s ``x`` on every rank (``dist.broadcast``, staged
        like :meth:`ppermute`); the other ranks pass a tensor of the same
        shape and dtype, whose values are not read."""
        buf = self._wire(x)
        dist.broadcast(buf, int(src))
        return self._unwire(buf, x.dtype, x.shape)

    def _buffer(self, nbytes: int) -> torch.Tensor:
        return torch.empty(nbytes, dtype=torch.uint8,
                           device="cpu" if self.staged else self.device,
                           pin_memory=self.staged)

    def ppermute(self, x: torch.Tensor, shift: int) -> torch.Tensor:
        """The cyclic shift of ``core/sweep.py:_shift_perm``: device i
        receives device ``(i + shift) % P``'s tensor.  Rank r sends to
        ``(r - shift) % P`` and receives from ``(r + shift) % P`` in one
        ``batch_isend_irecv``."""
        s = int(shift) % self.P
        if s == 0:
            return x
        send = self._wire(x)
        recv = self._buffer(send.numel())
        ops = [dist.P2POp(dist.isend, send, (self.rank - s) % self.P),
               dist.P2POp(dist.irecv, recv, (self.rank + s) % self.P)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return self._unwire(recv, x.dtype, x.shape)

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """``lax.all_gather``: x ``[1, ...]`` -> ``[1, P (block), ...]``,
        every device's block in device order."""
        send = self._wire(x)
        recv = self._buffer(self.P * send.numel())
        dist.all_gather(list(recv.chunk(self.P)), send)
        return self._unwire(recv, x.dtype, (1, self.P, *x.shape[1:]))

    # -- process groups (the LM steps' mesh axes, launch/mesh.py) --------

    def group(self, partition):
        """This rank's process group of ``partition``, a list of disjoint
        rank lists covering every rank (the ranks that share the
        coordinates off some mesh axes).  Every rank makes every group of
        the partition (``dist.new_group`` needs all of them, in one
        order), once; a group lists its ranks in ascending order, which
        is the order of its members' indices.  ``None`` stands for a
        group of one rank (no transfer)."""
        key = tuple(tuple(sorted(int(r) for r in g)) for g in partition)
        if key not in self._groups:
            mine = None
            for ranks in key:
                if len(ranks) == 1:
                    g = None
                elif len(ranks) == self.P:
                    g = dist.group.WORLD
                else:
                    g = dist.new_group(list(ranks))
                if self.rank in ranks:
                    mine = g
            self._groups[key] = mine
        return self._groups[key]

    def _host(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` where the transport reads it: a pinned host copy of a
        host-staged CUDA tensor, else ``x`` made contiguous."""
        if not self.staged:
            return x.contiguous()
        host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
        host.copy_(x)
        return host

    def _back(self, t: torch.Tensor) -> torch.Tensor:
        return t.to(self.device) if self.staged else t

    def all_gather_group(self, x: torch.Tensor, group, n: int
                         ) -> torch.Tensor:
        """The ``n`` members' ``x`` of ``group`` stacked on a new leading
        axis in member order: ``[n, *x.shape]``."""
        if group is None:
            return x.unsqueeze(0)
        t0 = self._start()
        send = self._wire(x)
        recv = self._buffer(n * send.numel())
        dist.all_gather(list(recv.chunk(n)), send, group=group)
        self.bytes["gathered"] += (n - 1) * send.numel()
        out = self._unwire(recv, x.dtype, (n, *x.shape))
        self._count("all_gather_group", t0)
        return out

    def reduce_scatter(self, x: torch.Tensor, group, n: int) -> torch.Tensor:
        """Sum ``x`` over the ``n`` members of ``group`` and keep this
        member's ``1/n`` of the leading axis (member i the i-th run of
        rows)."""
        if group is None:
            return x
        t0 = self._start()
        src = self._host(x)
        out = torch.empty((x.shape[0] // n, *x.shape[1:]), dtype=x.dtype,
                          pin_memory=self.staged)
        _reduce_scatter(out, src, group=group)
        self.bytes["reduced"] += src.numel() * src.element_size()
        out = self._back(out)
        self._count("reduce_scatter", t0)
        return out

    def all_reduce(self, x: torch.Tensor, group=None,
                   op: str = "sum") -> torch.Tensor:
        """The sum (``op="max"``: the maximum) of ``x`` over ``group``
        (every rank where ``None``)."""
        if group is None and self.P == 1:
            return x
        t0 = self._start()
        buf = self._host(x)
        if buf is x:
            buf = x.clone()
        dist.all_reduce(buf, group=group, op={
            "sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op])
        self.bytes["reduced"] += buf.numel() * buf.element_size()
        buf = self._back(buf)
        self._count("all_reduce", t0)
        return buf

    def _start(self) -> float:
        if self.staged:
            # the staging copy waits for the stream anyway
            torch.cuda.current_stream(self.device).synchronize()
        return time.perf_counter()

    def _count(self, kind: str, t0: float) -> None:
        self.calls[kind] += 1
        self.seconds += time.perf_counter() - t0

    def __repr__(self) -> str:
        return (f"DistributedComm(P={self.P}, rank={self.rank}, "
                f"device={self.device}, transport={self.transport})")


#: torch 2.13 names ``reduce_scatter_tensor`` ``reduce_scatter_single``
_reduce_scatter = getattr(dist, "reduce_scatter_single", None) \
    or dist.reduce_scatter_tensor


#: either backend: the type the engine's ``comm`` arguments take
Comm = Union[SingleProcessComm, DistributedComm]


def shard(x_np, comm: Comm, dtype=None) -> torch.Tensor:
    """``[N, ...]`` array -> this process's ``[len(local), N // P, ...]``
    blocks on the comm's device: device i holds rows ``i*block :
    (i+1)*block``.  The rows are taken on the host, so a rank never puts
    the other ranks' rows on its device."""
    t = torch.as_tensor(np.asarray(x_np))
    if t.shape[0] % comm.P:
        raise ValueError(f"N={t.shape[0]} does not divide by P={comm.P}")
    t = t.reshape(comm.P, t.shape[0] // comm.P, *t.shape[1:])
    return comm.local_rows(t).to(device=comm.device, dtype=dtype)


def unshard(t: torch.Tensor) -> torch.Tensor:
    """The inverse of :func:`shard`: ``[len(local), block, ...]`` ->
    this process's ``[len(local) * block, ...]`` rows."""
    return t.reshape(t.shape[0] * t.shape[1], *t.shape[2:])


def pad_blocks(corpus, P: int, device) -> torch.Tensor:
    """The [N, d] corpus (numpy or tensor) zero-padded to P blocks of
    ceil(N / P) rows on ``device``: [P, block, d] float32."""
    corpus = torch.as_tensor(corpus, dtype=torch.float32)
    N, d = corpus.shape
    block = -(-N // P)
    x = torch.zeros(P * block, d, dtype=torch.float32, device=device)
    x[:N] = corpus.to(device)
    return x.reshape(P, block, d)


def pad_local(corpus, comm: Comm, block: int | None = None) -> torch.Tensor:
    """This process's blocks ``[len(local), block, d]`` float32 on
    ``comm.device`` of the [N, d] corpus (numpy or tensor) zero-padded to
    P blocks of ``block`` rows (default ceil(N / P)): the rows are taken
    where the corpus lies, so a rank moves only its own to its device."""
    corpus = torch.as_tensor(corpus, dtype=torch.float32)
    N, d = corpus.shape
    block = -(-N // comm.P) if block is None else int(block)
    L = len(comm.local)
    r0 = comm.local.start * block
    n = max(0, min(N, comm.local.stop * block) - r0)
    x = torch.zeros(L * block, d, dtype=torch.float32, device=comm.device)
    x[:n] = corpus[r0:r0 + n].to(comm.device)
    return x.reshape(L, block, d)


def run_main(main: Callable[..., Any], *args, device=None,
             dist: str | None = None, **kw):
    """Run a selfcheck's ``main(*args, device=..., comm=...)`` from its
    CLI: without ``dist`` in one process (``main`` makes its
    ``SingleProcessComm`` on ``device``); with it as one rank of a
    torchrun job on :meth:`DistributedComm.from_env`, closed after."""
    if dist is None:
        return main(*args, device=device, **kw)
    comm = DistributedComm.from_env(dist, device)
    try:
        return main(*args, comm=comm, **kw)
    finally:
        comm.close()


def schedule_from_numpy(P, A, shifts, pair_slots, pair_diff) -> PairSchedule:
    """The port's :class:`PairSchedule` from the numpy fields of another
    one (duck-typed: e.g. a reference ``repro.core.scheduler.PairSchedule``,
    without importing it)."""
    return PairSchedule(
        P=int(P),
        A=tuple(int(a) for a in A),
        shifts=np.asarray(shifts, dtype=np.int32),
        pair_slots=np.asarray(pair_slots, dtype=np.int32).reshape(-1, 2),
        pair_diff=np.asarray(pair_diff, dtype=np.int32),
    )
