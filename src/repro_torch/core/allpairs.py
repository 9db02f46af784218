"""The quorum all-pairs engine of the port (counterpart of
``repro/core/allpairs.py``, DESIGN.md section 2).

  1. ``quorum_gather``  — every device pulls its k quorum blocks with k-1
     cyclic shifts (k*N/P = O(N/sqrt(P)) resident per device).
  2. pair compute       — the runtime's batched / overlap / scan modes
     driving :class:`DenseReduceEmitter`: every scheduled pair's
     ``pair_fn`` output is weighted by the ownership mask and accumulated
     into per-slot partials.
  3. ``quorum_scatter`` — the partials go home with the inverse shifts and
     are summed.

Plus :func:`allgather_allpairs`, the "all data everywhere" baseline used as
the oracle.  ``pair_fn(bi, bj) -> (out_i, out_j)`` acts on blocks with any
leading batch dimensions (``[..., block, F]``): the engine calls it on
``[L, block, F]`` slots, and in the batched mode on ``[L, n_pairs, block,
F]`` stacks, where L = ``len(comm.local)`` is the number of devices this
process holds (P in one process, 1 a rank under ``DistributedComm``).
"""

from __future__ import annotations

import functools
import math
from typing import Callable

import torch

from ..obs import trace as obs_trace
from . import sweep as sweep_mod
from .comm import Comm
from .scheduler import PairSchedule
from .sweep import (ENGINE_MODES, SweepEmitter, auto_batch_bytes,
                    env_mode_override, mark_varying, pair_mask_table,
                    pair_ready_order, quorum_gather, quorum_scatter)

__all__ = [
    "quorum_gather",
    "quorum_scatter",
    "quorum_allpairs",
    "allgather_allpairs",
    "pair_mask_table",
    "mark_varying",
    "auto_batch_bytes",
    "env_mode_override",
    "pair_ready_order",
    "DenseReduceEmitter",
    "ENGINE_MODES",
]


def _wmul(out: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Weight ``out`` by ``w``, whose dims are ``out``'s leading dims."""
    return out * w.to(out.dtype).reshape(w.shape + (1,) * (out.dim() - w.dim()))


def _probe(pair_fn, x: torch.Tensor) -> torch.Tensor:
    """``pair_fn``'s per-block ``out_i`` structure, from a call on meta
    tensors (no data, no compute)."""
    blk = torch.empty(x.shape[1:], dtype=x.dtype, device="meta")
    out_i, _ = pair_fn(blk, blk)
    return out_i


def _select_mode(schedule: PairSchedule, x: torch.Tensor,
                 probe: torch.Tensor, batch_fn) -> str:
    """The dense engine's ``mode="auto"`` working set, per device (the
    [2*n_pairs, block, ...] operand + output bytes of the batched step), fed
    to the shared heuristic."""
    out_bytes = math.prod(probe.shape) * probe.element_size()
    in_bytes = obs_trace.nbytes_of(x) // x.shape[0]
    ws = 2 * schedule.n_pairs * (in_bytes + out_bytes)
    return sweep_mod.select_mode(schedule, ws, batch_fn)


class DenseReduceEmitter(SweepEmitter):
    """Dense monoid scatter-reduce over the scheduled pairs (DESIGN.md
    section 12.2, the ``quorum_allpairs`` workload).

    Every pair's ``pair_fn(bi, bj) -> (out_i, out_j)`` is weighted by the
    [L, n_pairs] ownership mask (this process's rows) and accumulated into
    per-slot ``[L, k, block, ...]`` partials; self pairs keep only
    ``out_i``.  Its leading size comes from the tensors, never from the
    schedule's P.
    """

    def __init__(self, pair_fn, schedule: PairSchedule, mask: torch.Tensor,
                 probe: torch.Tensor, batch_fn=None):
        self.pair_fn = pair_fn
        self.schedule = schedule
        self.mask = mask
        self.probe = probe
        self.batch_fn = batch_fn
        self.lo_slots = schedule.pair_slots[:, 0]
        self.hi_slots = schedule.pair_slots[:, 1]
        self.is_self = schedule.pair_diff == 0

    @staticmethod
    def delta_retract(standing, stale, ctx=None):
        """Subtract a stale tile partial from the running float64 total,
        the additive group's retract (DESIGN.md section 16.2).  The delta
        index publishes the canonical-order refold of its ledger (float
        addition is not associative); this running total is the O(1)
        estimate the refold is checked against."""
        standing = torch.as_tensor(standing, dtype=torch.float64)
        return standing - torch.as_tensor(stale, dtype=torch.float64,
                                          device=standing.device)

    @staticmethod
    def delta_fold(standing, fresh, ctx=None):
        """Add a fresh tile partial to the running float64 total, the
        counterpart of :meth:`delta_retract`."""
        standing = torch.as_tensor(standing, dtype=torch.float64)
        return standing + torch.as_tensor(fresh, dtype=torch.float64,
                                          device=standing.device)

    def _zeros(self, *lead) -> torch.Tensor:
        return torch.zeros(lead + tuple(self.probe.shape),
                           dtype=self.probe.dtype, device=self.mask.device)

    def batch(self, quorum):
        """All pairs in one step, then a per-slot sum in pair order (no
        float atomics); with ``batch_fn`` the whole step (slot gather, pair
        interaction, slot reduction) is one fused kernel, e.g.
        ``kernels.ops.pairwise_batch_forces``."""
        P, k = quorum.shape[0], self.schedule.k
        wi = self.mask
        is_self = torch.as_tensor(self.is_self, device=wi.device)
        wj = torch.where(is_self, torch.zeros_like(wi), wi)
        if self.batch_fn is not None:
            return self.batch_fn(quorum, self.lo_slots, self.hi_slots, wi, wj)
        lo = torch.as_tensor(self.lo_slots, dtype=torch.long,
                             device=quorum.device)
        hi = torch.as_tensor(self.hi_slots, dtype=torch.long,
                             device=quorum.device)
        out_i, out_j = self.pair_fn(quorum[:, lo], quorum[:, hi])
        data = torch.cat([_wmul(out_i, wi), _wmul(out_j, wj)], dim=1)
        ids = torch.as_tensor(list(self.lo_slots) + list(self.hi_slots))
        acc = self._zeros(P, k)
        for s in range(k):
            sel = torch.nonzero(ids == s).reshape(-1).to(data.device)
            if sel.numel():
                acc[:, s] = data.index_select(1, sel).sum(1)
        return acc.to(self.probe.dtype)

    def scan_init(self):
        """Zeroed ``[L, k, block, ...]`` slot accumulator."""
        return self._zeros(self.mask.shape[0], self.schedule.k)

    def scan_items(self):
        """(lo_slot, hi_slot, is_self, mask column [L]) per pair."""
        return (self.lo_slots, self.hi_slots, self.is_self, self.mask.T)

    def scan_emit(self, acc, quorum, item):
        """One pair's weighted contributions added into the carry."""
        lo, hi, selfp, w = int(item[0]), int(item[1]), bool(item[2]), item[3]
        out_i, out_j = self.pair_fn(quorum[:, lo], quorum[:, hi])
        acc[:, lo] += _wmul(out_i, w)
        if not selfp:  # self pair: count once
            acc[:, hi] += _wmul(out_j, w)
        return acc

    def overlap_begin(self):
        """Per-slot contribution lists the sweep appends into."""
        return [[] for _ in range(self.schedule.k)]

    def overlap_emit(self, contribs, idx, bi, bj):
        """Run pair ``idx`` as soon as its later slot lands; per-slot
        contributions stay apart so each slot is scattered on its own."""
        lo = int(self.lo_slots[idx])
        hi = int(self.hi_slots[idx])
        w = self.mask[:, idx]
        out_i, out_j = self.pair_fn(bi, bj)
        contribs[lo].append(_wmul(out_i, w))
        if lo != hi:  # self pair: count once
            contribs[hi].append(_wmul(out_j, w))

    def overlap_finalize(self, contribs):
        """Each slot's contributions folded: the per-slot partials list
        ``quorum_scatter`` takes."""
        P = self.mask.shape[0]
        return [functools.reduce(torch.add, c).to(self.probe.dtype) if c
                else self._zeros(P) for c in contribs]


def quorum_allpairs(
    pair_fn: Callable[[torch.Tensor, torch.Tensor],
                      tuple[torch.Tensor, torch.Tensor]],
    x: torch.Tensor,
    comm: Comm,
    *,
    schedule: PairSchedule | None = None,
    mask: torch.Tensor | None = None,
    mode: str = "auto",
    batch_fn: Callable[..., torch.Tensor] | None = None,
    placement=None,
) -> torch.Tensor:
    """A symmetric all-pairs reduction with quorum replication.

    ``x`` is ``[L, block, ...]`` on ``comm.device``: the blocks of the
    L = ``len(comm.local)`` devices this process holds (device
    ``comm.local[i]``'s block is ``x[i]``).  ``pair_fn(bi, bj) -> (out_i,
    out_j)`` gives the interaction's contribution to each side, with
    ``out_j(bi, bj) == out_i(bj, bi)``; self pairs keep only ``out_i``.
    ``mask`` is those devices' rows ``[L, n_pairs]`` of the dedup /
    validity mask (default: ``comm.local_rows`` of the schedule's
    :func:`pair_mask_table`, which dedups the d = P/2 orbit on even P).

    ``mode``: ``batched`` (all pairs in one step), ``overlap`` (each pair at
    its ready slot), ``scan`` (one pair at a time) or ``auto`` (the shared
    heuristic, overridable with ``REPRO_ALLPAIRS_MODE``).  ``batch_fn(quorum,
    lo_slots, hi_slots, wi, wj) -> [L, k, block, ...]`` is an optional fused
    replacement of the batched step (e.g.
    ``kernels.ops.pairwise_batch_forces``) and implies ``batched`` under
    ``auto``.  ``placement`` selects the block placement; a full-replication
    placement routes to :func:`allgather_allpairs`.  With neither schedule
    nor placement, ``REPRO_PLACEMENT`` decides.

    Returns the per-block reduced output ``[L, block, ...]``.
    """
    sweep_mod.validate_mode(mode, batch_fn)
    L = len(comm.local)
    if x.shape[0] != L:
        raise ValueError(f"x must carry the device axis first: "
                         f"{tuple(x.shape)} for {L} local device(s) of "
                         f"P={comm.P}")
    schedule, placement = sweep_mod.resolve_sweep_placement(
        schedule, comm.P, placement)
    if placement is not None and placement.full:
        if batch_fn is not None:
            raise ValueError(
                "batch_fn fuses the quorum batched step; the full-replication "
                "placement routes through allgather_allpairs — drop batch_fn "
                "or pick a quorum placement")
        if mask is not None:
            raise ValueError(
                "mask expresses per-pair validity over the quorum schedule; "
                "the full-replication placement routes through "
                "allgather_allpairs, which would silently ignore it — drop "
                "the mask or pick a quorum placement")
        return allgather_allpairs(pair_fn, x, comm)
    if schedule is None:
        schedule = placement.schedule()

    if mask is None:
        mask = comm.local_rows(torch.as_tensor(pair_mask_table(schedule)))
    mask = mask.to(x.device).reshape(L, schedule.n_pairs)

    probe = _probe(pair_fn, x)
    if mode == "auto":
        mode = _select_mode(schedule, x, probe, batch_fn)

    emitter = DenseReduceEmitter(pair_fn, schedule, mask, probe,
                                 batch_fn=batch_fn)
    partials = sweep_mod.pair_sweep(emitter, schedule=schedule, comm=comm,
                                    mode=mode, x=x)
    return quorum_scatter(partials, schedule, comm)


def allgather_allpairs(
    pair_fn: Callable[[torch.Tensor, torch.Tensor],
                      tuple[torch.Tensor, torch.Tensor]],
    x: torch.Tensor,
    comm: Comm,
) -> torch.Tensor:
    """Baseline: every device holds ALL blocks (paper section 1.1) and
    computes every interaction of its own block — the oracle and the
    memory baseline.  Same ``pair_fn`` contract as
    :func:`quorum_allpairs`."""
    P, L = comm.P, x.shape[0]
    tr = obs_trace.get_tracer()
    if tr:  # (P-1) peer blocks land per device
        tr.count("comm.allgather.bytes",
                 (P - 1) * obs_trace.nbytes_of(x) // L)
    i = comm.axis_index()                    # [L] global device ids
    allblocks = comm.all_gather(x)           # [L, P, block, ...]
    self_out, _ = pair_fn(x, x)
    acc = torch.zeros_like(self_out)
    for j in range(P):
        out_i, _ = pair_fn(x, allblocks[:, j])
        own = (i == j).reshape((L,) + (1,) * (out_i.dim() - 1))
        acc = acc + torch.where(own, torch.zeros_like(out_i), out_i)
    return acc + self_out
