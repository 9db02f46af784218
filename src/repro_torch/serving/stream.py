"""Streaming corpus updates for the online serving tier (counterpart of
``repro/serving/stream.py``).

Corpus residency follows the batch engine: the corpus is chunked into P
blocks of ``block`` rows, device i owns block i (its *shard*) and also
holds the k blocks of its quorum as a resident ``[k, block, d]`` *stack*
(slot s = block (i + A[s]) % P, the layout ``quorum_gather`` produces).  A
validity flag per row handles partially filled blocks — appends land in
empty block capacity, no resharding.

``replace_block`` writes the new data into the owner's shard and pushes it
to the block's k holder quorums with the same k-1 cyclic shifts that built
the residency (non-holders receive their unchanged neighbours' blocks,
which the stack invariant makes a no-op).  Shard and validity ride one
gather as a two-leaf payload.  ``append_block`` is ``replace_block`` into
the first empty block slot (tracked host-side).

Every tensor carries the comm layer's leading axis over the L devices
this process holds (L = P in one process, 1 a rank under
``DistributedComm``; written ``[P, ...]`` below, as in one process); where
the reference stacks the per-device quorums device-major as ``[P * k,
block, d]``, the port keeps ``[P, k, block, d]`` (:func:`state_from_numpy`
converts).  A rank puts only its own shard on its device, then its quorum
through the gather.
"""

from __future__ import annotations

import functools
from typing import Callable, List, NamedTuple

import numpy as np
import torch

from ..core.comm import Comm, pad_local
from ..core.placement import Placement, placement_from_env, resolve_placement
from ..core.sweep import quorum_gather

__all__ = ["ServingState", "build_state", "update_fn", "replace_block",
           "state_from_numpy", "register_dirty_listener",
           "unregister_dirty_listener"]

# Dirty-block listeners (DESIGN.md section 16.5): every streamed block
# update — replace, and append (a replace into empty capacity) — notifies
# the registered callbacks with the block id, so standing delta indexes
# learn about churn at the moment it is applied, not by polling.
_DIRTY_LISTENERS: List[Callable[[int], None]] = []


def register_dirty_listener(fn: Callable[[int], None]) -> Callable[[int], None]:
    """Register a callback invoked with the block id after every
    streamed block update (replace or append).  Returns ``fn`` so it can
    be used as a decorator."""
    _DIRTY_LISTENERS.append(fn)
    return fn


def unregister_dirty_listener(fn: Callable[[int], None]) -> None:
    """Remove a callback added by :func:`register_dirty_listener`
    (no-op if it is not registered)."""
    try:
        _DIRTY_LISTENERS.remove(fn)
    except ValueError:
        pass


def _notify_dirty(b: int) -> None:
    for fn in list(_DIRTY_LISTENERS):
        fn(int(b))


class ServingState(NamedTuple):
    """Device-resident serving tensors (host metadata lives in
    ``engine.ServingCorpus``).

    shard       : [P, block, d]    — device i's owned block.
    valid       : [P, block]       — row validity of the owned blocks.
    stack       : [P, k, block, d] — per-device quorum stacks (device i's
                  slot s holds block (i + A[s]) % P).
    stack_valid : [P, k, block]    — validity rows aligned with ``stack``.
    """

    shard: torch.Tensor
    valid: torch.Tensor
    stack: torch.Tensor
    stack_valid: torch.Tensor


def state_from_numpy(shard, valid, stack, stack_valid, P: int,
                     device=None) -> ServingState:
    """The port's :class:`ServingState` from the fields of another one in
    the reference's device-major layout (``shard [P * block, d]``, ``valid
    [P * block]``, ``stack [P * k, block, d]``, ``stack_valid [P * k,
    block]``; duck-typed, e.g. a ``repro.serving.stream.ServingState``
    converted with ``np.asarray``), on ``device`` (default: the CPU)."""
    shard = torch.as_tensor(np.asarray(shard, np.float32), device=device)
    stack = torch.as_tensor(np.asarray(stack, np.float32), device=device)
    block, d = stack.shape[1], stack.shape[2]
    return ServingState(
        shard=shard.reshape(P, block, d),
        valid=torch.as_tensor(np.asarray(valid, bool),
                              device=device).reshape(P, block),
        stack=stack.reshape(P, -1, block, d),
        stack_valid=torch.as_tensor(np.asarray(stack_valid, bool),
                                    device=device).reshape(P, -1, block))


@functools.lru_cache(maxsize=32)
def update_fn(comm: Comm, placement: Placement):
    """The update program shared by replace and append, cached per (comm,
    placement).

    ``f(shard, valid, b, data, nvalid)``: the owner of block ``b``
    (device b, in whichever process holds it) overwrites its shard with
    ``data`` (rows >= nvalid invalid), then the k cyclic shifts, which
    every process runs, redistribute the updated shards —
    each holder of b receives the new block at its matching slot, every
    other slot arrives unchanged (the stack invariant), so the gather *is*
    the propagation.  Works for any shift-structured placement, including
    full replication.  The old state's tensors are left untouched.
    """
    sched = placement.schedule()

    def f(shard, valid, b: int, data, nvalid: int):
        block = shard.shape[1]
        shard = shard.clone()
        valid = valid.clone()
        if b in comm.local:                  # the owner's write
            at = b - comm.local.start
            shard[at] = data
            valid[at] = torch.arange(block, device=valid.device) < nvalid
        stack, stack_valid = quorum_gather((shard, valid), sched, comm)
        return shard, valid, stack, stack_valid

    return f


def build_state(corpus, comm: Comm, block: int | None = None,
                placement=None) -> ServingState:
    """Chunk ``corpus`` [N, d] into P blocks (zero-padded; padding rows
    invalid), put this process's on ``comm.device`` and build the
    resident quorum stacks with one gather.  ``block`` overrides the per-block row capacity (>=
    ceil(N/P)) to leave empty slots for streamed appends.  ``placement``
    picks the residency layer (None defers to ``REPRO_PLACEMENT`` / auto
    == cyclic)."""
    P = comm.P
    plc = (placement_from_env(P) if placement is None
           else resolve_placement(placement, P))
    corpus = torch.as_tensor(corpus, dtype=torch.float32)
    N, d = corpus.shape
    block = max(block or 1, 1, -(-N // P))
    shard = pad_local(corpus, comm, block)
    L = shard.shape[0]
    valid = (torch.arange(comm.local.start * block,
                          comm.local.stop * block, device=comm.device)
             < N).reshape(L, block)
    stack, stack_valid = quorum_gather((shard, valid), plc.schedule(), comm)
    return ServingState(shard=shard, valid=valid, stack=stack,
                        stack_valid=stack_valid)


def replace_block(state: ServingState, comm: Comm, b: int,
                  data, nvalid: int | None = None,
                  placement=None) -> ServingState:
    """Replace block ``b`` with ``data`` ([rows <= block, d]) and push it to
    the k holder quorums.  Rows beyond ``nvalid`` (default: data row count)
    are marked invalid; data is zero-padded to the block size.
    ``placement`` must match the one the state was built with (the stack
    layout is placement-defined)."""
    P = comm.P
    plc = (placement_from_env(P) if placement is None
           else resolve_placement(placement, P))
    block = state.shard.shape[1]
    data = torch.as_tensor(data, dtype=torch.float32)
    rows, d = data.shape
    if rows > block:
        raise ValueError(f"data has {rows} rows; block capacity is {block}")
    nvalid = rows if nvalid is None else nvalid
    if not 0 <= nvalid <= rows:
        raise ValueError(f"nvalid={nvalid} outside [0, {rows}] — padding "
                         "rows must not be marked valid")
    full = torch.zeros(block, d, dtype=torch.float32, device=comm.device)
    full[:rows] = data.to(comm.device)
    out = update_fn(comm, plc)(state.shard, state.valid, int(b), full,
                               int(nvalid))
    _notify_dirty(b)
    return ServingState(*out)
