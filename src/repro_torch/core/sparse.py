"""Thresholded sparse all-pairs similarity join over quorum placements
(counterpart of ``repro/core/sparse.py``, DESIGN.md section 11).

:class:`ThresholdJoinEmitter` plugs into the port's pair-sweep runtime
(core/sweep.py), so the join reuses the quorum schedule and every
registered placement but emits only the passing ``(i, j, score)`` triples:

  1. **prefilter** — per-slot norm extrema bound every block-pair tile's
     best score (``|x.y| <= |x||y|`` for dot; the norm-interval gap for
     l2), and tiles whose bound misses the threshold are skipped whole.
  2. **tile compute + threshold compaction** — each scheduled slot pair's
     [block, block] score tile is thresholded and its survivors are
     compacted in (pair, row, col) order into a fixed-capacity buffer per
     device.  The hand-written B5 kernel (kernels/pairwise_threshold.py)
     replaces the batched step through the ``batch_fn`` hook.
  3. **exactly-once emission** — the per-difference ownership rule plus
     the engine's dedup mask partition all unordered pairs over the
     devices; self-pair tiles keep the strict upper triangle, so every
     passing global pair ``i < j`` is reported by exactly one device.
     :func:`ring_allgather_hits` replicates the per-device buffers with
     single-step shifts.

**Capacity / overflow contract** (DESIGN.md section 11.2): buffers hold
``capacity`` triples; ``count`` is always the *true* number of passing
pairs on the device and entries past ``capacity`` are dropped, never
reordered, so ``count > capacity`` is an exact escalation signal and the
kept prefix is valid either way.  :func:`similarity_join` doubles the
capacity until the flag clears.

Every per-device tensor carries the comm layer's leading axis over the L
devices this process holds (L = P in one process, 1 a rank under
``DistributedComm``; written ``[P, ...]`` below, as in one process).
Where the reference skips a tile per device with ``lax.cond``, the port
forms the tile for all L devices and masks by each device's flag, and
skips it only where no device has it active: the results are identical.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, NamedTuple, Optional, Sequence

import numpy as np
import torch

from ..kernels.ref import IDX_SENTINEL, NEG_INF, tile_scores
from ..obs import trace as obs_trace
from . import env as env_mod
from . import sweep as sweep_mod
from .comm import (Comm, DistributedComm, SingleProcessComm, pad_local,
                   run_main, tree_map)
from .scheduler import PairSchedule
from .sweep import ENGINE_MODES, SweepEmitter, pair_mask_table

__all__ = [
    "SparseHits",
    "JoinResult",
    "ThresholdJoinEmitter",
    "default_capacity",
    "pair_score_bounds",
    "quorum_allpairs_threshold",
    "ring_allgather_hits",
    "similarity_join",
    "brute_force_join",
    "owned_pairs",
    "threshold_with_gap",
    "threshold_for_selectivity",
    "JOIN_METRICS",
]

JOIN_METRICS = ("dot", "l2")

# the reference's fused kernel carries global row ids as exact float32
# integers; the port keeps int32 ids but the same corpus limit, so both
# packages accept the same inputs (DESIGN.md 11.2)
MAX_ROWS_F32_EXACT = 1 << 24


def _pair_rows(rows, device=None) -> torch.Tensor:
    """(i, j) hit rows as an [n, 2] int64 tensor."""
    return torch.as_tensor(rows, dtype=torch.int64,
                           device=device).reshape(-1, 2)


def _pair_key(rows: torch.Tensor) -> torch.Tensor:
    """One int64 per (i, j) row ordering as (i, j) lexicographically
    (0 <= j < 2^32)."""
    return (rows[:, 0] << 32) | rows[:, 1]


class SparseHits(NamedTuple):
    """Every device's compacted passing pairs.

    vals  : [P, capacity] float32 — passing scores; slots >= min(count,
            capacity) hold ``NEG_INF``.
    i, j  : [P, capacity] int32 — global row ids with i < j; empty slots
            hold ``IDX_SENTINEL``.
    count : [P] int32 — each device's TRUE number of passing pairs (may
            exceed capacity; see the overflow contract above).
    """

    vals: torch.Tensor
    i: torch.Tensor
    j: torch.Tensor
    count: torch.Tensor


def default_capacity(n_candidates: int) -> int:
    """Starting per-device buffer capacity (DESIGN.md section 11.2).

    ``REPRO_SPARSE_CAPACITY`` overrides; otherwise 1/8 of the device's
    candidate count, rounded up to a multiple of 128 with a floor of 128.
    Read at selection time, and only a *start*: :func:`similarity_join`
    doubles it until the overflow flag clears.
    """
    cap = env_mod.read_knob("REPRO_SPARSE_CAPACITY")
    if cap is not None:
        return int(cap)
    cap = max(128, -(-n_candidates // 8))
    return -(-cap // 128) * 128


def _norm_extrema(blk: torch.Tensor, valid: torch.Tensor):
    """(max, min) row norm over the valid rows of blocks [..., block, d];
    (0, +inf) for a block with none (which makes every bound below reject
    the tile)."""
    norms = torch.sqrt(torch.sum(blk * blk, dim=-1))
    return (torch.where(valid, norms, 0.0).amax(dim=-1),
            torch.where(valid, norms, float("inf")).amin(dim=-1))


def _interval_bound(maxn_i, minn_i, maxn_j, minn_j, metric: str):
    """Tile score upper bound from two blocks' norm extrema — the single
    home of the DESIGN.md 11.1 derivation, shared by every mode.

    ``dot``: Cauchy-Schwarz, ``x.y <= max|x| * max|y|``.  ``l2`` (score =
    -|x-y|^2): reverse triangle inequality, ``|x-y| >= gap`` with gap the
    distance between the [min|x|, max|x|] norm intervals, so the score is
    at most ``-gap^2`` (an all-invalid block's +inf min norm yields a -inf
    bound: always skipped).
    """
    if metric == "dot":
        return maxn_i * maxn_j
    gap = torch.clamp(torch.maximum(minn_i - maxn_j, minn_j - maxn_i),
                      min=0.0)
    return -torch.where(torch.isinf(gap), float("inf"), gap * gap)


def pair_score_bounds(quorum: torch.Tensor, valid: torch.Tensor, lo_slots,
                      hi_slots, metric: str) -> torch.Tensor:
    """Upper bound on each scheduled tile's best score (DESIGN.md 11.1):
    quorum [P, k, block, d]; valid [P, k, block] row validity; lo / hi
    [n_pairs] slot ids.  Returns [P, n_pairs]; a tile whose bound misses
    the threshold holds no passing pair — the prefilter."""
    if metric not in JOIN_METRICS:
        raise ValueError(f"metric must be one of {JOIN_METRICS}, "
                         f"got {metric!r}")
    maxn, minn = _norm_extrema(quorum, valid)                    # [P, k]
    lo = torch.as_tensor(lo_slots, dtype=torch.long, device=maxn.device)
    hi = torch.as_tensor(hi_slots, dtype=torch.long, device=maxn.device)
    return _interval_bound(maxn[:, lo], minn[:, lo], maxn[:, hi],
                           minn[:, hi], metric)


def _scatter_hits(bufs, count, keep, vals, gi, gj, capacity: int):
    """Append the passing entries of [P, M] candidates to the running
    [P, capacity + 1] buffers at ``count + cumsum(keep) - 1``; positions
    at or past capacity land in the spare last column, which is dropped
    at the end, while the count grows by the true passing total — the
    overflow contract."""
    vbuf, ibuf, jbuf = bufs
    pos = count[:, None] + torch.cumsum(keep, dim=1) - 1
    pos = torch.where(keep & (pos < capacity), pos, capacity)
    vbuf.scatter_(1, pos, vals)
    ibuf.scatter_(1, pos, gi)
    jbuf.scatter_(1, pos, gj)
    return count + keep.sum(dim=1)


def _empty_bufs(P: int, capacity: int, device):
    """Sentinel-filled [P, capacity + 1] buffers and zero counts."""
    return ((torch.full((P, capacity + 1), NEG_INF, dtype=torch.float32,
                        device=device),
             torch.full((P, capacity + 1), IDX_SENTINEL, dtype=torch.int32,
                        device=device),
             torch.full((P, capacity + 1), IDX_SENTINEL, dtype=torch.int32,
                        device=device)),
            torch.zeros(P, dtype=torch.int64, device=device))


def _finalize(bufs, count, capacity: int) -> SparseHits:
    """Drop the spare column: every mode returns the same padded layout,
    (NEG_INF, IDX_SENTINEL) past min(count, capacity)."""
    vbuf, ibuf, jbuf = bufs
    return SparseHits(vals=vbuf[:, :capacity], i=ibuf[:, :capacity],
                      j=jbuf[:, :capacity], count=count.to(torch.int32))


def _select_mode(schedule: PairSchedule, block: int,
                 batch_fn: Optional[Callable]) -> str:
    """The sparse engine's ``mode="auto"`` working set fed to the shared
    heuristic (core/sweep.py select_mode): scores f32 + two i32 id planes
    per [n_pairs, block, block] tile entry."""
    return sweep_mod.select_mode(
        schedule, schedule.n_pairs * block * block * 12, batch_fn)


def _pair_meta(schedule: PairSchedule, comm: Comm, block: int,
               n_valid: Optional[int]):
    """Per-pair metadata of every device: global block ids, valid row
    counts and self-pair flags.  ``n_valid`` marks trailing padding rows
    of the global [P * block] numbering invalid.  Returns ``(lo, hi, ga,
    gb, nv_lo, nv_hi, is_self, nv)``: lo / hi / is_self [n_pairs] (the
    same on every device), ga / gb / nv_lo / nv_hi [P, n_pairs], nv
    [P, k]."""
    P = schedule.P
    dev = comm.device
    shifts = torch.as_tensor(schedule.shifts, dtype=torch.long, device=dev)
    gblocks = (comm.axis_index()[:, None] + shifts[None]) % P        # [P, k]
    lo = torch.as_tensor(schedule.pair_slots[:, 0], dtype=torch.long,
                         device=dev)
    hi = torch.as_tensor(schedule.pair_slots[:, 1], dtype=torch.long,
                         device=dev)
    if n_valid is None:
        nv = torch.full_like(gblocks, block)
    else:
        nv = torch.clamp(n_valid - gblocks * block, 0, block)
    is_self = torch.as_tensor(schedule.pair_diff == 0, device=dev)
    return (lo, hi, gblocks[:, lo], gblocks[:, hi], nv[:, lo], nv[:, hi],
            is_self, nv)


def _tile_keep(scores, thr, nv_lo, nv_hi, is_self):
    """Threshold + row-validity + self-pair strict-triangle mask of
    [P, m, n] tiles against ``thr`` (a scalar or a broadcastable bound);
    nv_lo / nv_hi [P]; is_self a bool."""
    r = torch.arange(scores.shape[-2], device=scores.device)[:, None]
    s = torch.arange(scores.shape[-1], device=scores.device)[None, :]
    keep = ((scores >= thr) & (r < nv_lo[:, None, None])
            & (s < nv_hi[:, None, None]))
    return keep & (r < s) if is_self else keep


def _tile_emit(ga, gb, block: int, m: int, n: int):
    """Global-id planes of [P, m, n] tiles in the canonical (i < j)
    orientation: blocks are disjoint row ranges, so the elementwise
    (min, max) of the two ids orients every entry."""
    dev = ga.device
    gi = ga[:, None, None] * block + torch.arange(m, device=dev)[:, None]
    gj = gb[:, None, None] * block + torch.arange(n, device=dev)[None, :]
    gi, gj = torch.broadcast_tensors(gi, gj)
    return torch.minimum(gi, gj).to(torch.int32), \
        torch.maximum(gi, gj).to(torch.int32)


class ThresholdJoinEmitter(SweepEmitter):
    """Fixed-capacity threshold compaction over the scheduled pairs
    (DESIGN.md sections 11, 12.2 — the similarity-join workload).

    Each active tile is scored, thresholded under the ownership rules
    (row validity, self-pair strict triangle, the engine dedup mask) and
    compacted into per-device (vals, i, j) buffers under the overflow
    contract.  The norm-bound prefilter deactivates whole tiles: up front
    over the gathered stack in batched / scan modes (:meth:`prepare`),
    from per-slot extrema as blocks land in overlap mode
    (:meth:`overlap_slot`).
    """

    def __init__(self, schedule: PairSchedule, mask, thr: float,
                 capacity: int, metric: str, block: int, prefilter: bool,
                 meta, nv, batch_fn=None):
        self.schedule = schedule
        self.mask = mask
        self.thr = thr
        self.capacity = capacity
        self.metric = metric
        self.block = block
        self.prefilter = prefilter
        self.lo, self.hi, self.ga, self.gb, self.nv_lo, self.nv_hi, \
            self.is_self = meta
        self.nv = nv
        self.batch_fn = batch_fn
        self.active = self.mask > 0           # [P, n_pairs], refined below
        self.P = mask.shape[0]

    @staticmethod
    def delta_retract(standing, stale, ctx=None):
        """Retract stale (i, j) rows from a standing sorted hit set
        (DESIGN.md section 16.3).  A global pair lives in exactly one
        tile, so removing the dirty tiles' old rows is an exact set
        difference.  Both are [n, 2] int64 tensors."""
        standing = _pair_rows(standing)
        stale = _pair_rows(stale, standing.device)
        if not len(standing) or not len(stale):
            return standing
        return standing[~torch.isin(_pair_key(standing), _pair_key(stale))]

    @staticmethod
    def delta_fold(standing, fresh, ctx=None):
        """Insert fresh (i, j) rows into a standing hit set and restore
        the canonical (lo, hi) order (DESIGN.md section 16.3): rows are
        globally unique, so the sorted union is bit-equal to a
        from-scratch fold."""
        standing = _pair_rows(standing)
        allr = torch.cat([standing, _pair_rows(fresh, standing.device)])
        return allr[torch.argsort(_pair_key(allr))]

    def _slot_valid(self) -> torch.Tensor:
        return (torch.arange(self.block, device=self.nv.device)[None, None]
                < self.nv[:, :, None])                     # [P, k, block]

    def prepare(self, quorum):
        """Norm-bound prefilter over the full gathered stack
        (batched / scan modes; DESIGN.md 11.1)."""
        if not self.prefilter:
            return
        bounds = pair_score_bounds(quorum, self._slot_valid(), self.lo,
                                   self.hi, self.metric)
        self.active = self.active & (bounds >= self.thr)

    def batch(self, quorum):
        """One compaction over every tile.  The batched step IS the plain
        version (``kernels/ref.py:pairwise_threshold``) — one home for the
        threshold membership and compaction — with the B5 kernel swapping
        in through the same hook."""
        batch_fn = self.batch_fn
        if batch_fn is None:
            from ..kernels import ref as kref
            batch_fn = functools.partial(
                kref.pairwise_threshold, threshold=self.thr,
                capacity=self.capacity, block_rows=self.block,
                metric=self.metric)
        P, n = self.active.shape
        meta = torch.stack([self.active.to(torch.int32),
                            self.is_self.to(torch.int32).expand(P, n),
                            self.ga.to(torch.int32), self.gb.to(torch.int32),
                            self.nv_lo.to(torch.int32),
                            self.nv_hi.to(torch.int32)], dim=-1)
        vals, ei, ej, count = batch_fn(quorum, self.lo, self.hi, meta)
        return SparseHits(vals=vals, i=ei, j=ej,
                          count=count.reshape(P).to(torch.int32))

    def _tile(self, bi, bj):
        """One tile's scores [P, block, block] and the bound each entry
        must reach."""
        return tile_scores(bi, bj, self.metric), self.thr

    def _compact_tile(self, carry, idx: int, act, bi, bj):
        """Score pair ``idx``'s tiles [P, block, block] from its two slots
        and append the survivors of the devices with ``act`` set; a pair
        no device has active is skipped."""
        if not bool(act.any()):
            return carry
        bufs, count = carry
        P = self.P
        scores, bound = self._tile(bi, bj)
        keep = _tile_keep(scores, bound, self.nv_lo[:, idx],
                          self.nv_hi[:, idx],
                          bool(self.schedule.pair_diff[idx] == 0))
        keep &= act[:, None, None]
        ei, ej = _tile_emit(self.ga[:, idx], self.gb[:, idx], self.block,
                            *scores.shape[1:])
        count = _scatter_hits(bufs, count, keep.reshape(P, -1),
                              scores.reshape(P, -1), ei.reshape(P, -1),
                              ej.reshape(P, -1), self.capacity)
        return bufs, count

    def scan_init(self):
        """Empty compaction buffers + zero true counts."""
        return _empty_bufs(self.P, self.capacity, self.mask.device)

    def scan_items(self):
        """The pair indices, walked in order."""
        return np.arange(self.schedule.n_pairs)

    def scan_emit(self, carry, quorum, item):
        """Serial per-pair compaction; inactive tiles skip their compute."""
        idx = int(item)
        lo, hi = (int(s) for s in self.schedule.pair_slots[idx])
        return self._compact_tile(carry, idx, self.active[:, idx],
                                  tree_map(lambda a: a[:, lo], quorum),
                                  tree_map(lambda a: a[:, hi], quorum))

    def scan_finalize(self, carry):
        """Drop the spare buffer column (the shared layout)."""
        return _finalize(*carry, self.capacity)

    def overlap_begin(self):
        """The running (bufs, count) carry + the per-slot extrema list the
        incremental prefilter appends into."""
        return {"extrema": [], "carry": self.scan_init()}

    def overlap_slot(self, state, slot, blk):
        """Per-slot norm extrema, computed once at land time."""
        if self.prefilter:
            vrow = (torch.arange(self.block, device=blk.device)[None]
                    < self.nv[:, slot, None])
            state["extrema"].append(_norm_extrema(blk, vrow))

    def overlap_emit(self, state, idx, bi, bj):
        """Score / compact one tile as soon as its later block lands."""
        l_s = int(self.schedule.pair_slots[idx, 0])
        h_s = int(self.schedule.pair_slots[idx, 1])
        act = self.mask[:, idx] > 0
        if self.prefilter:
            mx_i, mn_i = state["extrema"][l_s]
            mx_j, mn_j = state["extrema"][h_s]
            act = act & (_interval_bound(mx_i, mn_i, mx_j, mn_j,
                                         self.metric) >= self.thr)
        state["carry"] = self._compact_tile(state["carry"], idx, act, bi, bj)

    def overlap_finalize(self, state):
        """Drop the spare buffer column (the shared layout)."""
        return _finalize(*state["carry"], self.capacity)


def quorum_allpairs_threshold(
    x: torch.Tensor,
    comm: Comm,
    *,
    threshold: float,
    capacity: int,
    schedule: PairSchedule | None = None,
    placement=None,
    metric: str = "dot",
    mode: str = "auto",
    mask: torch.Tensor | None = None,
    n_valid: int | None = None,
    prefilter: bool = True,
    batch_fn: Callable | None = None,
) -> SparseHits:
    """Distributed thresholded similarity join (DESIGN.md section 11).

    ``x`` is ``[L, block, d]`` on ``comm.device``: the blocks of the L =
    ``len(comm.local)`` devices this process holds.  Emits every global
    pair ``i < j`` with ``score(x_i, x_j) >= threshold`` exactly once
    across devices and returns those devices' :class:`SparseHits` under
    the overflow contract; ``mask`` is their rows of the dedup mask.

    ``placement`` / ``schedule`` select the residency layer as in
    :func:`core.allpairs.quorum_allpairs` (``REPRO_PLACEMENT`` consulted
    when both are None; a full-replication placement runs the same
    pipeline over its A = {0..P-1} shifts).  ``mode`` is the runtime's
    batched / overlap / scan surface (``REPRO_ALLPAIRS_MODE`` honored);
    ``prefilter`` toggles the norm-bound tile skip; ``n_valid``
    invalidates global rows >= n_valid (corpus padding); ``batch_fn(quorum,
    lo, hi, meta) -> (vals, i, j, count)`` is the fused-kernel hook
    (``kernels.ops.pairwise_threshold``), batched mode only.
    """
    if metric not in JOIN_METRICS:
        raise ValueError(f"metric must be one of {JOIN_METRICS}, "
                         f"got {metric!r}")
    sweep_mod.validate_mode(mode, batch_fn)
    if capacity < 1:
        raise ValueError(f"capacity must be >= 1, got {capacity}")
    L = len(comm.local)
    if x.shape[0] != L:
        raise ValueError(f"x must carry the device axis first: "
                         f"{tuple(x.shape)} for {L} local device(s) of "
                         f"P={comm.P}")
    schedule, placement = sweep_mod.resolve_sweep_placement(
        schedule, comm.P, placement)
    if schedule is None:
        schedule = placement.schedule()

    block = x.shape[1]
    if mask is None:
        mask = comm.local_rows(torch.as_tensor(pair_mask_table(schedule)))
    mask = mask.to(x.device).reshape(L, schedule.n_pairs)

    if mode == "auto":
        mode = _select_mode(schedule, block, batch_fn)

    lo, hi, ga, gb, nv_lo, nv_hi, is_self, nv = _pair_meta(
        schedule, comm, block, n_valid)
    emitter = ThresholdJoinEmitter(
        schedule, mask, float(np.float32(threshold)), capacity, metric, block,
        prefilter, (lo, hi, ga, gb, nv_lo, nv_hi, is_self), nv,
        batch_fn=batch_fn)
    return sweep_mod.pair_sweep(emitter, schedule=schedule, comm=comm,
                                mode=mode, x=x)


def ring_allgather_hits(hits: SparseHits,
                        comm: Comm) -> SparseHits:
    """Replicate every device's sparse buffers with a shift ring
    (DESIGN.md section 11.3).

    P - 1 single-step shifts rotate each device's (vals, i, j, count) past
    every other device; arrivals are placed at their source device's row,
    so all devices end with the identical device-ordered [P, capacity]
    stack: fields ``[L (device), P (source), ...]`` for the L devices this
    process holds.  The pair-ownership partition guarantees the union of
    rows lists every passing pair exactly once.
    """
    P = comm.P
    L = hits.vals.shape[0]
    fields = [hits.vals, hits.i, hits.j, hits.count.reshape(L, 1)]
    dev_ids = comm.axis_index().to(hits.vals.device)    # global ids [L]
    ar = torch.arange(L, device=hits.vals.device)       # local positions
    out = [torch.zeros((L, P) + f.shape[1:], dtype=f.dtype, device=f.device)
           for f in fields]
    for o, f in zip(out, fields):
        o[ar, dev_ids] = f
    cur = fields
    for step in range(1, P):
        cur = [comm.ppermute(c, -1) for c in cur]   # from device i - 1
        src = (dev_ids - step) % P
        for o, c in zip(out, cur):
            o[ar, src] = c
    vals, ei, ej, count = out
    return SparseHits(vals=vals, i=ei, j=ej, count=count.reshape(L, P))


# ---------------------------------------------------------------------------
# Host-level entry point: padding, program cache, capacity escalation
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class JoinResult:
    """Host-side similarity-join output (:func:`similarity_join`).

    i, j, scores : the passing pairs, sorted by (i, j); i < j, each pair
        exactly once (under ``DistributedComm``: the pairs this rank's
        device owns, which the other ranks' complete).  ``counts`` is
        every device's true passing total ([P] on every process),
        ``capacity`` the final per-device buffer size, ``escalations`` how
        many capacity doublings the overflow contract forced, and
        ``overflow`` whether the final pass still overflowed (only with
        ``escalate=False`` — the kept pairs are then a valid prefix).
    """

    i: np.ndarray
    j: np.ndarray
    scores: np.ndarray
    counts: np.ndarray
    capacity: int
    escalations: int
    overflow: bool

    @property
    def n_pairs(self) -> int:
        """Number of passing pairs reported."""
        return int(self.i.shape[0])


@functools.lru_cache(maxsize=64)
def _join_fn(comm: Comm, N: int, block: int, threshold: float,
             metric: str, mode: str, capacity: int, prefilter: bool,
             use_kernel: bool, placement):
    """Build (and cache) the distributed join callable ``f(x [P, block,
    d]) -> SparseHits`` — one per (comm, shape, threshold, capacity, ...)
    key, reused across escalation retries and repeated joins."""
    sched = placement.schedule()
    mask_table = comm.local_rows(
        torch.as_tensor(pair_mask_table(sched))).to(comm.device)
    batch_fn = None
    if use_kernel:
        if mode not in ("batched", "auto"):
            raise ValueError(
                f"use_kernel needs the batched mode (got mode={mode!r}); "
                "the fused kernel only replaces the batched inner step")
        from ..kernels import ops as kops
        batch_fn = functools.partial(
            kops.pairwise_threshold, threshold=threshold, capacity=capacity,
            block_rows=block, metric=metric)

    def run(xs):
        return quorum_allpairs_threshold(
            xs, comm, threshold=threshold, capacity=capacity, schedule=sched,
            mask=mask_table, metric=metric, mode=mode, n_valid=N,
            prefilter=prefilter, batch_fn=batch_fn)
    return run


def similarity_join(corpus, comm: Comm, *, threshold: float,
                    metric: str = "dot", mode: str = "auto", placement=None,
                    capacity: int | None = None, prefilter: bool = True,
                    use_kernel: bool = False, escalate: bool = True,
                    max_doublings: int = 16,
                    quant: str | None = None) -> JoinResult:
    """All pairs of ``corpus`` rows with score >= threshold, exactly once.

    The host entry point (DESIGN.md section 11): pads the [N, d] corpus
    (numpy or tensor) into P quorum blocks, puts this process's on
    ``comm.device``, runs :func:`quorum_allpairs_threshold` under the
    selected placement (None defers to ``REPRO_PLACEMENT``), and applies
    the capacity escalation — whenever any device's overflow flag is set
    (every device's count, gathered: all ranks double together), the
    per-device ``capacity`` doubles and the join re-runs.  With
    ``escalate=False`` an overflowing pass returns its valid prefix with
    ``overflow=True``.  Under ``DistributedComm`` each rank returns the
    pairs its device owns (:func:`owned_pairs`); their union over the
    ranks, sorted, is the single process's result.

    ``use_kernel`` routes the batched step through the B5 kernel
    (kernels/pairwise_threshold.py); ``prefilter`` toggles the norm-bound
    tile skip.  ``quant`` selects the quantized band with f32 rescoring
    (DESIGN.md section 17): ``"int8"`` / ``"bf16"`` route through
    :func:`core.quant.quant_similarity_join` (the same pairs), ``"off"``
    forces f32, None defers to ``REPRO_QUANT``.  Returns a
    :class:`JoinResult` with pairs sorted by (i, j).
    """
    from . import quant as quant_mod
    if quant is None:
        quant = quant_mod.quant_from_env()
    if quant != "off":
        return quant_mod.quant_similarity_join(
            corpus, comm, threshold=threshold, quant=quant, metric=metric,
            mode=mode, placement=placement, capacity=capacity,
            use_kernel=use_kernel, escalate=escalate,
            max_doublings=max_doublings)
    dev = comm.device
    N = int(torch.as_tensor(corpus).shape[0])
    if N >= MAX_ROWS_F32_EXACT:
        raise ValueError(
            f"corpus has {N} rows >= 2^24; global row ids would lose "
            "float32 exactness in the fused kernel's compaction")
    P = comm.P
    from .placement import placement_from_env, resolve_placement
    plc = (placement_from_env(P) if placement is None
           else resolve_placement(placement, P))
    xs = pad_local(corpus, comm)
    block = xs.shape[1]
    sched = plc.schedule()
    n_cand = sched.n_pairs * block * block
    cap = int(capacity) if capacity is not None else default_capacity(n_cand)

    escalations = 0
    tr = obs_trace.get_tracer()
    span = tr.span("sparse.join", N=N, P=P, metric=metric, mode=mode,
                   threshold=float(threshold), placement=plc.name) if tr \
        else obs_trace.NOOP.span("")
    with span:
        while True:
            run = _join_fn(comm, N, block, float(threshold), metric, mode,
                           cap, prefilter, use_kernel, plc)
            hits = run(xs)
            counts = comm.all_rows(hits.count).cpu().numpy().reshape(-1)
            overflow = bool((counts > cap).any())
            if (not overflow or not escalate
                    or escalations >= max_doublings):
                break
            cap = 2 * cap
            escalations += 1
    if tr:
        L = len(comm.local)
        tr.count("sparse.tiles_scheduled", L * sched.n_pairs)
        tr.count("sparse.candidates", L * n_cand)
        if prefilter:
            tr.count("sparse.tiles_pruned",
                     _count_pruned_tiles(xs, N, block, sched,
                                         float(threshold), metric, comm))
        tr.count("sparse.escalations", escalations)
    if overflow and escalate:
        raise RuntimeError(
            f"similarity join still overflows capacity {cap} after "
            f"{escalations} doublings; raise `capacity`/`max_doublings` "
            "or the threshold")

    used = (torch.arange(cap, device=dev)[None]
            < torch.clamp(hits.count, max=cap)[:, None])
    ai, aj, av = hits.i[used], hits.j[used], hits.vals[used]
    order = torch.argsort(aj.long(), stable=True)
    order = order[torch.argsort(ai[order].long(), stable=True)]
    if tr:
        tr.count("sparse.pairs_emitted", int(ai.shape[0]))
    return JoinResult(i=ai[order].cpu().numpy(), j=aj[order].cpu().numpy(),
                      scores=av[order].cpu().numpy(), counts=counts,
                      capacity=cap, escalations=escalations,
                      overflow=overflow)


def _count_pruned_tiles(x: torch.Tensor, N: int, block: int,
                        sched: PairSchedule, threshold: float,
                        metric: str, comm: Comm) -> int:
    """Replay of the DESIGN.md 11.1 interval bound over the scheduled
    tiles of the devices this process holds (``x`` their [L, block, d]
    blocks; every block's norm extrema gathered) — the
    ``sparse.tiles_pruned`` counter."""
    P = sched.P
    gid = comm.axis_index().to(x.device)
    valid = (gid[:, None] * block
             + torch.arange(block, device=x.device)[None]) < N
    maxn, minn = (comm.all_rows(e) for e in _norm_extrema(x, valid))  # [P]
    shifts = torch.as_tensor(sched.shifts, dtype=torch.long, device=x.device)
    dev_ids = gid[:, None]
    a = (dev_ids + shifts[torch.as_tensor(sched.pair_slots[:, 0],
                                          device=x.device).long()]) % P
    b = (dev_ids + shifts[torch.as_tensor(sched.pair_slots[:, 1],
                                          device=x.device).long()]) % P
    bound = _interval_bound(maxn[a], minn[a], maxn[b], minn[b], metric)
    return int((bound < threshold).sum())


def _pair_score_matrix(corpus: np.ndarray, metric: str) -> np.ndarray:
    """Host-side [N, N] score matrix with the engine's f32 formulas."""
    if metric not in JOIN_METRICS:
        raise ValueError(f"metric must be one of {JOIN_METRICS}, "
                         f"got {metric!r}")
    c = np.asarray(corpus, np.float32)
    s = c @ c.T
    if metric == "l2":
        n2 = (c * c).sum(-1)
        s = 2.0 * s - n2[None, :] - n2[:, None]
    return s


def brute_force_join(corpus: np.ndarray, threshold: float,
                     metric: str = "dot"):
    """Dense O(N^2) oracle: all (i, j, score) with i < j and score >=
    threshold, sorted by (i, j).  Scores use the same float32 formula as
    the engine (DESIGN.md section 11.3) so membership agrees away from
    exact-threshold ties; tests pick thresholds with a guaranteed gap."""
    s = _pair_score_matrix(corpus, metric)
    iu, ju = np.triu_indices(s.shape[0], k=1)
    keep = s[iu, ju] >= threshold
    return iu[keep], ju[keep], s[iu, ju][keep]


def owned_pairs(i, j, block: int, schedule: PairSchedule,
                devices) -> np.ndarray:
    """Which of the global row pairs ``(i, j)`` (numpy, i < j) the given
    devices emit: the ownership rule and dedup mask give each unordered
    block pair to exactly one (device, scheduled pair), so a pair is
    owned where its two blocks are.  A [n] bool mask; the pairs a rank of
    ``DistributedComm`` returns are those owned by ``comm.local``."""
    P = schedule.P
    mask = pair_mask_table(schedule)
    lo = schedule.shifts[schedule.pair_slots[:, 0]]
    hi = schedule.shifts[schedule.pair_slots[:, 1]]
    mine = np.zeros((P, P), bool)
    for dev in devices:
        on = mask[dev] > 0
        a, b = (dev + lo[on]) % P, (dev + hi[on]) % P
        mine[np.minimum(a, b), np.maximum(a, b)] = True
    bi, bj = np.asarray(i) // block, np.asarray(j) // block
    return mine[np.minimum(bi, bj), np.maximum(bi, bj)]


def threshold_with_gap(scores, selectivity: float,
                       min_gap: float = 1e-4) -> float:
    """A threshold passing ~``selectivity`` of ``scores`` (any shape),
    placed at the midpoint of a score gap wider than ``min_gap`` near
    that quantile, so float-rounding differences between engine paths
    cannot flip membership (DESIGN.md section 11.3).  The single home of
    the gap-placement idiom — the pairwise wrapper below and the serving
    selfcheck both use it.

    ``scores`` may be a tensor: the sort and the gap search then run on
    its device.  The search takes the nearest gap to the target rank,
    the lower rank first at equal distance (the reference's widening
    loop, in one pass)."""
    flat = torch.sort(torch.as_tensor(scores, dtype=torch.float32)
                      .reshape(-1), descending=True).values
    n = flat.numel()
    target = max(1, min(n - 2, int(round(selectivity * n))))
    gap = flat[:-1] - flat[1:]              # gap[idx - 1] sits above idx
    idx = torch.nonzero(gap > min_gap).reshape(-1) + 1
    if not idx.numel():
        raise ValueError("no score gap wide enough for a robust threshold")
    off = idx - target
    best = int(idx[torch.argmin(2 * off.abs() + (off > 0).long())])
    return float((flat[best - 1] + flat[best]) / 2.0)


def threshold_for_selectivity(corpus: np.ndarray, selectivity: float,
                              metric: str = "dot",
                              min_gap: float = 1e-4) -> float:
    """A join threshold passing ~``selectivity`` of all unordered pairs
    of ``corpus`` rows — :func:`threshold_with_gap` over the upper
    triangle of the pairwise score matrix (DESIGN.md section 11.3)."""
    s = _pair_score_matrix(corpus, metric)
    iu, ju = np.triu_indices(s.shape[0], k=1)
    return threshold_with_gap(s[iu, ju], selectivity, min_gap)


# ---------------------------------------------------------------------------
# Selfcheck (python -m repro_torch.core.sparse)
# ---------------------------------------------------------------------------

def selfcheck_main(nblocks: int = 8,
                   modes: Sequence[str] = ENGINE_MODES + ("kernel",),
                   placement: str | None = None, device=None,
                   comm: Comm | None = None) -> None:
    """Sparse-join selfcheck (DESIGN.md section 11.5) on ``comm`` (default:
    a ``SingleProcessComm`` of ``nblocks`` devices on ``device``, itself
    defaulting to the CUDA device).

    Run as ``python -m repro_torch.core.sparse [P] [modes] [placement]
    [--device cpu] [--dist gloo|nccl]``; with ``--dist`` each of P
    processes started by torchrun is one device (``DistributedComm``).
    Asserts index-level pair-set equality with the dense brute-force
    oracle (under ``DistributedComm``: its pairs the rank's device owns)
    for every requested mode (``kernel`` is the batched path through the
    B5 hook), both metrics, prefilter on / off, plus the ring-gather
    replication and the overflow / escalation contract.
    """
    from .placement import placement_from_env, resolve_placement

    Pn = int(nblocks)
    comm = SingleProcessComm(Pn, device) if comm is None else comm
    if comm.P != Pn:
        raise ValueError(f"the comm has P={comm.P} devices, not {Pn}")
    plc = (placement_from_env(Pn) if placement is None
           else resolve_placement(placement, Pn))
    block, d = 8, 16
    rng = np.random.default_rng(0)
    N = Pn * block - 3          # ragged tail: exercises row validity
    corpus = rng.normal(size=(N, d)).astype(np.float32)
    # two low-norm block spans make whole tiles prunable for `dot`
    corpus[: 2 * block] *= 0.05
    sched = plc.schedule()

    def oracle(thr, metric):
        wi, wj, wv = brute_force_join(corpus, thr, metric)
        mine = owned_pairs(wi, wj, block, sched, comm.local)
        return wi[mine], wj[mine], wv[mine], len(wi)

    for metric in JOIN_METRICS:
        thr = threshold_for_selectivity(corpus, 0.08, metric)
        wi, wj, wv, _n = oracle(thr, metric)
        label = f"P={Pn} metric={metric}"
        for m in modes:
            mode, uk = ("batched", True) if m == "kernel" else (m, False)
            for pf in (True, False):
                res = similarity_join(corpus, comm, threshold=thr,
                                      metric=metric, mode=mode,
                                      placement=plc, use_kernel=uk,
                                      prefilter=pf)
                np.testing.assert_array_equal(
                    res.i, wi, err_msg=f"{label} mode={m} prefilter={pf}")
                np.testing.assert_array_equal(
                    res.j, wj, err_msg=f"{label} mode={m} prefilter={pf}")
                np.testing.assert_allclose(
                    res.scores, wv, rtol=1e-5, atol=1e-5,
                    err_msg=f"{label} mode={m} prefilter={pf}")

    # overflow contract: a capacity below the busiest device's true count
    # must flag, keep a valid prefix, and escalate back to the full answer
    thr = threshold_for_selectivity(corpus, 0.08, "dot")
    wi, wj, _, n_all = oracle(thr, "dot")
    base = similarity_join(corpus, comm, threshold=thr, placement=plc)
    np.testing.assert_array_equal(base.i, wi)
    np.testing.assert_array_equal(base.j, wj)
    if int(base.counts.sum()) != n_all:
        raise AssertionError(f"device counts {base.counts} do not sum to "
                             f"the oracle's {n_all} pairs")
    mx = int(base.counts.max())
    if mx < 2:
        raise AssertionError(f"corpus too small to exercise overflow: {mx}")
    cap_small = max(1, mx // 2)
    for m in modes:
        mode, uk = ("batched", True) if m == "kernel" else (m, False)
        low = similarity_join(corpus, comm, threshold=thr,
                              capacity=cap_small, placement=plc,
                              escalate=False, mode=mode, use_kernel=uk)
        if not (low.overflow and (low.counts > cap_small).any()):
            raise AssertionError(f"mode={m}: no overflow at capacity "
                                 f"{cap_small}: counts {low.counts}")
        got = set(zip(low.i.tolist(), low.j.tolist()))
        if not (got <= set(zip(wi.tolist(), wj.tolist()))
                and len(got) == len(low.i)):
            raise AssertionError(f"mode={m}: overflow prefix is not a "
                                 "subset of the oracle's pairs")
    esc = similarity_join(corpus, comm, threshold=thr, capacity=cap_small,
                          placement=plc)
    if esc.escalations < 1:
        raise AssertionError("a small capacity did not escalate")
    np.testing.assert_array_equal(esc.i, wi)
    np.testing.assert_array_equal(esc.j, wj)

    # ring gather: every device ends with the identical stack, whose row
    # of each local device is that device's own buffers
    hits = quorum_allpairs_threshold(
        pad_local(corpus, comm), comm, threshold=thr, capacity=esc.capacity,
        schedule=sched, n_valid=N)
    g = ring_allgather_hits(hits, comm)
    for pos, dev in enumerate(comm.local):
        if not (torch.equal(g.vals[pos], g.vals[0])
                and torch.equal(g.i[pos], g.i[0])
                and torch.equal(g.count[pos], g.count[0])
                and torch.equal(g.vals[pos, dev], hits.vals[pos])
                and torch.equal(g.j[pos, dev], hits.j[pos])
                and int(g.count[pos, dev]) == int(hits.count[pos])):
            raise AssertionError(f"ring gather: device {dev}'s copy differs")
    if g.count[0].cpu().numpy().tolist() != esc.counts.tolist():
        raise AssertionError(f"ring gather counts {g.count[0]} != the "
                             f"join's {esc.counts}")

    sel = n_all / max(1, N * (N - 1) // 2)
    where = (f" rank={comm.rank} transport={comm.transport} "
             f"pairs={len(wi)}" if isinstance(comm, DistributedComm) else "")
    print(f"sparse selfcheck OK: P={Pn} placement={plc.describe()} "
          f"modes={','.join(modes)} device={comm.device}{where} "
          f"hits={n_all} selectivity={100 * sel:.1f}% "
          f"capacity={esc.capacity}")


if __name__ == "__main__":
    import argparse
    ap = argparse.ArgumentParser(description="sparse-join selfcheck")
    ap.add_argument("P", nargs="?", type=int, default=8)
    ap.add_argument("modes", nargs="?",
                    default=",".join(ENGINE_MODES + ("kernel",)))
    ap.add_argument("placement", nargs="?", default=None)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    ap.add_argument("--dist", choices=("gloo", "nccl"), default=None,
                    help="one process per device over torch.distributed "
                         "with this backend (start under torchrun)")
    args = ap.parse_args()
    run_main(selfcheck_main, args.P, tuple(args.modes.split(",")),
             args.placement, device=args.device, dist=args.dist)
