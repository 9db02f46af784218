"""The online query engine: cover-routed top-k over quorum stacks
(counterpart of ``repro/serving/engine.py``, DESIGN.md section 9).

A query microbatch ``[Q, d]`` goes to the cover devices (serving/cover.py);
each scores it against its resident ``[k, block, d]`` quorum stack under
the dedup mask (so every corpus row scores exactly once), selects a local
top-k, and a recursive-doubling shift merge combines the per-device lists
into the global ``[Q, topk]`` result in ceil(log2 P) rounds.  All P
simulated devices run the program — non-cover devices contribute
sentinel-only lists.

Selection is everywhere by the total order **(-score, global index)**, so
results are deterministic and identical across execution modes, the B4
kernel and the brute-force oracle — ties break toward the smaller corpus
index.

Local scoring is a *slot sweep* on the port's pair-sweep runtime
(core/sweep.py): the work items are the k resident slots, the stack is
already resident (no gather), and the shared mode surface applies:

  * ``batched`` — every slot in one step and one top-k over k*block
    candidates (the plain version ``kernels/ref.py:query_topk``); with
    ``batch_fn`` (``kernels.ops.query_topk``, the B4 kernel) the whole
    step is one launch for every device.
  * ``overlap`` — per-slot top-k lists merged by a pairwise tournament.
  * ``scan``    — a running [Q, topk] carry merged slot by slot.
  * ``auto``    — the shared heuristic (``REPRO_ALLPAIRS_MODE`` first,
    then batched while the score working set fits
    ``REPRO_BATCH_BYTES_LIMIT``, else overlap when k >= 3, else scan).

Every per-device tensor carries the comm layer's leading axis over the L
devices this process holds (L = P in one process, 1 a rank under
``DistributedComm``; written ``[P, ...]`` below, as in one process).
Under ``DistributedComm`` the engine is SPMD: every rank calls
``ServingCorpus.query`` / ``query_threshold`` / ``replace_block`` with the
same arguments in the same order, and every rank gets the same answer.
"""

from __future__ import annotations

import functools
from typing import Callable, Tuple

import numpy as np
import torch

from ..core import sweep as sweep_mod
from ..core.comm import Comm, tree_map
from ..core.placement import (Placement, get_placement, placement_from_env,
                              resolve_placement)
from ..core.scheduler import PairSchedule
from ..core.sparse import default_capacity
from ..core.sweep import SweepEmitter, merge_topk, slot_items, topk_by_score
from ..kernels import ref as kref
from ..kernels.ref import IDX_SENTINEL, NEG_INF
from ..kernels.ref import QUERY_METRICS as METRICS
from ..obs import trace as obs_trace
from .cover import build_cover
from .stream import ServingState, build_state, replace_block

__all__ = [
    "IDX_SENTINEL",
    "topk_by_score",
    "merge_topk",
    "tree_merge_topk",
    "quantize_pow2",
    "QUERY_CHUNK",
    "quorum_query_topk",
    "quorum_query_threshold",
    "QueryTopKEmitter",
    "QueryThresholdEmitter",
    "ServingCorpus",
]


def quantize_pow2(n: int, floor: int = 1) -> int:
    """Round ``n`` up to the smallest power of two >= max(n, floor).

    The program-cache quantizer (DESIGN.md section 15.2): request-shape
    parameters (``topk``, range-query ``capacity``) are bucketed onto
    powers of two before they become cache keys, so heterogeneous traffic
    builds O(log N) programs, and capacity escalation (doubling) maps onto
    the same bucket set.
    """
    n = max(int(n), int(floor), 1)
    return 1 << (n - 1).bit_length()


#: rows of every launch on the library-scored query paths (cuBLAS on the
#: card, BLAS on the CPU): a fixed width, because a GEMM's reduction order
#: may change with its row count, and a request must score the same bits
#: alone as packed with others (``serving/batching.py``)
QUERY_CHUNK = 32


def _launch_rows(run, q: torch.Tensor, *per_query, width: int | None):
    """``run(q_rows, *per_query_rows)`` over launches of ``width`` rows of
    ``q`` (``None``: one launch of at least two rows, where the kernel's
    scores do not depend on the row count but a one-row product takes the
    matrix-vector path), the last zero-padded; ``per_query`` vectors pad
    with +inf.  The outputs are concatenated and cut to the Q rows."""
    Q = q.shape[0]
    w = max(Q, 2) if width is None else width
    outs = []
    for c0 in range(0, Q, w):
        pad = max(0, c0 + w - Q)
        rows = torch.nn.functional.pad(q[c0:c0 + w], (0, 0, 0, pad))
        extra = [torch.nn.functional.pad(v[c0:c0 + w], (0, pad),
                                         value=float("inf"))
                 for v in per_query]
        outs.append(run(rows, *extra))
    return tuple(torch.cat([o[i] for o in outs])[:Q]
                 for i in range(len(outs[0])))


def _scores(queries: torch.Tensor, blk: torch.Tensor,
            metric: str) -> torch.Tensor:
    """[Q, d] x [P, block, d] -> [P, Q, block] under the chosen metric.

    ``l2`` scores are ``2 q.x - |x|^2 - |q|^2`` (= -|q - x|^2); the oracle
    and the B4 kernel use the identical formula.
    """
    if metric not in METRICS:
        raise ValueError(f"metric must be one of {METRICS}, got {metric!r}")
    return kref.tile_scores(queries, blk, metric)


def tree_merge_topk(vals, idx, *, comm: Comm, topk: int):
    """Recursive-doubling merge of [P, Q, topk] lists: after ceil(log2 P)
    shift rounds every device holds the global top-k.  Round r pulls the
    running list from device i + 2^r; windows overlap when P is not a
    power of two, which the index dedup in :func:`core.sweep.merge_topk`
    absorbs exactly."""
    tr = obs_trace.get_tracer()
    P = comm.P
    shift = 1
    while shift < P:
        if tr:  # per hop and device: the running (vals, idx) payload
            tr.count("comm.ppermute.merge_hops")
            tr.count("comm.ppermute.merge_bytes",
                     (obs_trace.nbytes_of(vals)
                      + obs_trace.nbytes_of(idx)) // vals.shape[0])
        ov = comm.ppermute(vals, shift)
        oi = comm.ppermute(idx, shift)
        vals, idx = merge_topk(vals, idx, ov, oi, topk)
        shift *= 2
    return vals, idx


def _select_mode(schedule: PairSchedule, queries, block: int,
                 batch_fn) -> str:
    """The query engine's ``mode="auto"`` working set per device fed to the
    shared heuristic: the [Q, k*block] score tensor (x2 for the sort
    copy)."""
    Q = queries.shape[0]
    return sweep_mod.select_mode(
        schedule, 2 * Q * schedule.k * block * queries.element_size(),
        batch_fn)


def _query_geometry(schedule: PairSchedule, comm: Comm,
                    block: int, mask_row, stack_valid):
    """Shared geometry of both query paths: global row ids [P, k, block]
    int32 and the cover-dedup x validity mask [P, k, block] bool."""
    P = schedule.P
    dev = stack_valid.device
    shifts = torch.as_tensor(schedule.shifts, dtype=torch.long, device=dev)
    gblocks = (comm.axis_index()[:, None] + shifts[None]) % P       # [P, k]
    gidx = (gblocks[..., None] * block
            + torch.arange(block, device=dev)).to(torch.int32)
    mask = (mask_row.to(dev)[:, :, None] > 0) & stack_valid
    return gidx, mask


class QueryTopKEmitter(SweepEmitter):
    """Per-row top-k selection over the resident slot sweep (DESIGN.md
    sections 9.2, 12.2 — the serving top-k workload).

    Each slot's [P, Q, block] score tile is masked (cover dedup x row
    validity) and folded into running [P, Q, topk] (value, index) lists
    under the (-score, index) total order; the three modes fold
    differently but select identically.
    """

    def __init__(self, schedule: PairSchedule, queries, mask, gidx,
                 topk: int, metric: str, batch_fn=None):
        self.schedule = schedule
        self.queries = queries
        self.mask = mask
        self.gidx = gidx
        self.topk = topk
        self.metric = metric
        self.batch_fn = batch_fn

    def items(self):
        """Slot sweep: one work item per resident slot."""
        return slot_items(self.schedule.k)

    def batch(self, quorum):
        """Every slot at once and one top-k over all k*block candidates:
        the plain version, or the B4 kernel through ``batch_fn``."""
        fn = self.batch_fn or functools.partial(
            kref.query_topk, topk=self.topk, metric=self.metric)
        return fn(quorum, self.queries, self.mask.to(torch.float32),
                  self.gidx)

    def _slot_scores(self, blk) -> torch.Tensor:
        """[P, Q, block] scores of one slot's rows."""
        return _scores(self.queries, blk, self.metric)

    def _slot(self, slot: int, blk):
        """One slot's masked scores and ids, [P, Q, block] each."""
        Q, block = self.queries.shape[0], self.mask.shape[-1]
        vrow = self.mask[:, slot]                           # [P, block]
        s = torch.where(vrow[:, None], self._slot_scores(blk), NEG_INF)
        g = torch.where(vrow, self.gidx[:, slot], IDX_SENTINEL)
        return s, g[:, None].expand(-1, Q, block)

    def scan_init(self):
        """Sentinel-filled [P, Q, topk] running lists."""
        P, Q = self.mask.shape[0], self.queries.shape[0]
        dev = self.queries.device
        return (torch.full((P, Q, self.topk), NEG_INF, device=dev),
                torch.full((P, Q, self.topk), IDX_SENTINEL,
                           dtype=torch.int32, device=dev))

    def scan_items(self):
        """The resident slots, in order."""
        return np.arange(self.schedule.k)

    def scan_emit(self, carry, quorum, item):
        """Merge one slot's masked scores into the running lists."""
        slot = int(item)
        blk = tree_map(lambda a: a[:, slot], quorum)
        return merge_topk(*carry, *self._slot(slot, blk), self.topk)

    def overlap_begin(self):
        """The per-slot candidate lists the tournament merge folds."""
        return []

    def overlap_emit(self, lists, idx, bi, bj):
        """Select each slot's local top-k as its scores materialize."""
        lists.append(topk_by_score(*self._slot(idx, bi), self.topk))

    def overlap_finalize(self, lists):
        """Pairwise tournament merge: log2(k) depth."""
        while len(lists) > 1:
            nxt = [merge_topk(*lists[j], *lists[j + 1], self.topk)
                   for j in range(0, len(lists) - 1, 2)]
            if len(lists) % 2:
                nxt.append(lists[-1])
            lists = nxt
        return lists[0]


def quorum_query_topk(
    queries: torch.Tensor,
    stack: torch.Tensor,
    stack_valid: torch.Tensor,
    mask_row: torch.Tensor,
    *,
    topk: int,
    comm: Comm,
    schedule: PairSchedule,
    mode: str = "auto",
    metric: str = "dot",
    batch_fn: Callable[..., Tuple[torch.Tensor, torch.Tensor]] | None = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Score a query microbatch against the corpus; global top-k per query.

    Args (``[P, ...]`` per device):
      queries     : [Q, d] microbatch, the same on every device.
      stack       : [P, k, block, d] resident quorum stacks (stream.py).
      stack_valid : [P, k, block] bool row validity.
      mask_row    : [P, k] cover dedup mask (CoverPlan.mask_table; zero
                    rows off the cover).
      batch_fn    : optional fused local step — called as
                    ``batch_fn(stack, queries, mask [P, k, block], gidx
                    [P, k, block]) -> (vals [P, Q, topk], idx [P, Q,
                    topk])`` (kernels.ops.query_topk); implies
                    ``batched``.

    Returns (scores [P, Q, topk], global corpus indices [P, Q, topk]),
    identical on every device after the tree merge; ties break toward
    smaller indices, missing candidates are (NEG_INF, IDX_SENTINEL).
    """
    sweep_mod.validate_mode(mode, batch_fn)
    L, k, block, d = stack.shape
    mask_row = mask_row.reshape(L, k)
    if mode == "auto":
        mode = _select_mode(schedule, queries, block, batch_fn)

    gidx, mask = _query_geometry(schedule, comm, block, mask_row,
                                 stack_valid)
    emitter = QueryTopKEmitter(schedule, queries, mask, gidx, topk, metric,
                               batch_fn=batch_fn)
    vals, idx = sweep_mod.pair_sweep(emitter, schedule=schedule, comm=comm,
                                     mode=mode, stack=stack)
    return tree_merge_topk(vals, idx, comm=comm, topk=topk)


def _compact_rows(vbuf, ibuf, cnt, keep, vals, idx, capacity: int):
    """Append each query row's kept entries to its (vbuf, ibuf) prefix.

    keep / vals / idx: [P, Q, M] candidates; buffers [P, Q, capacity + 1]
    (the spare last column takes the entries past capacity and is
    dropped by the caller); positions are per row ``cnt + cumsum(keep) -
    1``, and ``cnt`` grows by the true kept total — the same overflow
    contract as the batch sparse engine (core/sparse.py).  Returns new
    buffers; the inputs are left untouched.
    """
    pos = cnt[..., None] + torch.cumsum(keep, dim=-1) - 1
    pos = torch.where(keep & (pos < capacity), pos, capacity)
    vbuf = vbuf.scatter(-1, pos, vals.to(vbuf.dtype))
    ibuf = ibuf.scatter(-1, pos, idx.to(torch.int32))
    return vbuf, ibuf, cnt + keep.sum(dim=-1)


def _select_threshold_mode(schedule: PairSchedule, queries,
                           block: int) -> str:
    """``mode="auto"`` for the thresholded query path — the same shared
    heuristic and working set as the top-k path, minus the fused-kernel
    arm."""
    return _select_mode(schedule, queries, block, None)


class QueryThresholdEmitter(SweepEmitter):
    """Per-query fixed-capacity threshold compaction over the resident
    slot sweep (DESIGN.md sections 11.4, 12.2 — the range-query workload).

    Each slot's passing (score, index) entries are compacted into
    [P, Q, capacity + 1] buffers under the overflow contract; the adapter
    appends the other devices' prefixes with a shift ring afterwards.
    """

    def __init__(self, schedule: PairSchedule, queries, mask, gidx, thr,
                 capacity: int, metric: str):
        self.schedule = schedule
        self.queries = queries
        self.mask = mask
        self.gidx = gidx
        self.thr = thr
        self.capacity = capacity
        self.metric = metric

    def items(self):
        """Slot sweep: one work item per resident slot."""
        return slot_items(self.schedule.k)

    def _init_bufs(self):
        """Sentinel-filled [P, Q, capacity + 1] buffers + zero counts."""
        P, Q = self.mask.shape[0], self.queries.shape[0]
        dev = self.queries.device
        return (torch.full((P, Q, self.capacity + 1), NEG_INF, device=dev),
                torch.full((P, Q, self.capacity + 1), IDX_SENTINEL,
                           dtype=torch.int32, device=dev),
                torch.zeros(P, Q, dtype=torch.int64, device=dev))

    def _slot(self, slot: int, blk):
        """One slot's scores, keep mask and ids, [P, Q, block] each."""
        Q, block = self.queries.shape[0], blk.shape[1]
        s = _scores(self.queries, blk, self.metric)
        keep = (s >= self.thr[None, :, None]) & self.mask[:, slot][:, None]
        return keep, s, self.gidx[:, slot][:, None].expand(-1, Q, block)

    def batch(self, quorum):
        """Every slot scored at once, then a single compaction."""
        P, k, block, d = quorum.shape
        Q = self.queries.shape[0]
        s = _scores(self.queries, quorum.reshape(P, k * block, d),
                    self.metric)                       # [P, Q, k * block]
        keep = ((s >= self.thr[None, :, None])
                & self.mask.reshape(P, 1, k * block))
        return _compact_rows(
            *self._init_bufs(), keep, s,
            self.gidx.reshape(P, 1, k * block).expand(P, Q, k * block),
            self.capacity)

    def scan_init(self):
        """Empty per-query compaction buffers."""
        return self._init_bufs()

    def scan_items(self):
        """The resident slots, in order."""
        return np.arange(self.schedule.k)

    def scan_emit(self, carry, quorum, item):
        """Compact one slot's passing entries into the running buffers."""
        slot = int(item)
        keep, s, g = self._slot(slot, quorum[:, slot])
        return _compact_rows(*carry, keep, s, g, self.capacity)

    def overlap_begin(self):
        """Per-slot (keep, scores, ids) lists for the single deferred
        compaction."""
        return {"keep": [], "s": [], "g": []}

    def overlap_emit(self, state, idx, bi, bj):
        """Score one slot as it lands; compaction is deferred."""
        keep, s, g = self._slot(idx, bi)
        state["keep"].append(keep)
        state["s"].append(s)
        state["g"].append(g)

    def overlap_finalize(self, state):
        """One compaction over every slot's concatenated candidates."""
        return _compact_rows(
            *self._init_bufs(), torch.cat(state["keep"], dim=-1),
            torch.cat(state["s"], dim=-1), torch.cat(state["g"], dim=-1),
            self.capacity)


def quorum_query_threshold(
    queries: torch.Tensor,
    stack: torch.Tensor,
    stack_valid: torch.Tensor,
    mask_row: torch.Tensor,
    *,
    threshold,
    capacity: int,
    comm: Comm,
    schedule: PairSchedule,
    mode: str = "auto",
    metric: str = "dot",
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Range query: every corpus row scoring >= threshold, per query.

    The sparse sibling of :func:`quorum_query_topk` (DESIGN.md section
    11.4): the same cover-routed local scoring under the dedup mask, but
    passing rows are compacted into fixed-capacity [Q, capacity] buffers,
    and a **shift ring** (P - 1 single-step shifts) appends every other
    device's passing prefix, so all devices end with the identical global
    result, sorted by ascending corpus index.

    ``threshold`` is a scalar or a per-query ``[Q]`` vector.  Returns
    ``(scores [P, Q, capacity], indices [P, Q, capacity], count [P, Q])``;
    count is each query's TRUE passing total — ``count > capacity`` flags
    overflow (overflowing buffers keep a valid but device-order-dependent
    subset), and slots past ``min(count, capacity)`` hold (NEG_INF,
    IDX_SENTINEL) sentinels.
    """
    sweep_mod.validate_mode(mode, None)
    if metric not in METRICS:
        raise ValueError(f"metric must be one of {METRICS}, got {metric!r}")
    P = comm.P
    L, k, block, d = stack.shape
    Q = queries.shape[0]
    mask_row = mask_row.reshape(L, k)
    if mode == "auto":
        mode = _select_threshold_mode(schedule, queries, block)

    gidx, mask = _query_geometry(schedule, comm, block, mask_row,
                                 stack_valid)
    thr = torch.as_tensor(threshold, dtype=torch.float32,
                          device=queries.device).broadcast_to((Q,))
    emitter = QueryThresholdEmitter(schedule, queries, mask, gidx, thr,
                                    capacity, metric)
    vbuf, ibuf, cnt = sweep_mod.pair_sweep(emitter, schedule=schedule,
                                           comm=comm, mode=mode, stack=stack)

    # shift ring: append every other device's passing prefix
    tr = obs_trace.get_tracer()
    cur = (vbuf, ibuf, cnt)
    slot_iota = torch.arange(capacity + 1, device=queries.device)
    for _ in range(1, P):
        if tr:  # per hop and device: the three ring buffers
            tr.count("comm.ppermute.ring_hops")
            tr.count("comm.ppermute.ring_bytes",
                     sum(obs_trace.nbytes_of(c) for c in cur) // L)
        cur = tuple(comm.ppermute(c, -1) for c in cur)  # from device i - 1
        rv, ri, rc = cur
        valid_in = slot_iota < torch.clamp(rc, max=capacity)[..., None]
        vbuf, ibuf, _unclamped = _compact_rows(vbuf, ibuf, cnt, valid_in,
                                               rv, ri, capacity)
        cnt = cnt + rc        # true totals, not the clamped append

    # canonical order: ascending corpus index (sentinels sort last)
    ibuf, vbuf = ibuf[..., :capacity], vbuf[..., :capacity]
    order = torch.argsort(ibuf, dim=-1, stable=True)
    return vbuf.gather(-1, order), ibuf.gather(-1, order), cnt.to(torch.int32)


@functools.lru_cache(maxsize=64)
def threshold_fn(comm: Comm, capacity: int, mode: str,
                 metric: str, placement: Placement | None = None):
    """Build (and cache) the distributed range-query callable ``f(queries
    [Q, d], threshold, state) -> (scores [Q, capacity], idx [Q, capacity],
    count [Q])`` — cached per capacity like :func:`query_fn`; the
    threshold (scalar or per-query ``[Q]``) is an operand, so one entry
    serves every threshold value.  Callers pre-quantize ``capacity``
    through :func:`quantize_pow2`."""
    P = comm.P
    if placement is None:
        placement = get_placement("cyclic", P)
    sched = placement.schedule()
    plan = build_cover(P, placement)
    mask_table = comm.local_rows(
        torch.as_tensor(plan.mask_table())).to(comm.device)

    def run(queries, threshold, state: ServingState):
        vals, idx, cnt = quorum_query_threshold(
            queries, state.stack, state.stack_valid, mask_table,
            threshold=threshold, capacity=capacity, comm=comm,
            schedule=sched, mode=mode, metric=metric)
        return vals[0], idx[0], cnt[0]      # all device copies identical

    return run


@functools.lru_cache(maxsize=64)
def query_fn(comm: Comm, topk: int, mode: str, metric: str,
             use_kernel: bool, placement: Placement | None = None):
    """Build (and cache) the distributed query callable ``f(queries [Q, d],
    state) -> (scores [Q, topk], idx [Q, topk])``.  ``placement`` selects
    the residency layer (None = cyclic) and is part of the cache key; the
    serving data plane is the generic shift pipeline for every placement
    (full replication is a one-device cover over an everything-resident
    stack).  ``use_kernel`` routes the batched step through the B4
    kernel."""
    P = comm.P
    if placement is None:
        placement = get_placement("cyclic", P)
    sched = placement.schedule()
    plan = build_cover(P, placement)
    mask_table = comm.local_rows(
        torch.as_tensor(plan.mask_table())).to(comm.device)
    batch_fn = None
    if use_kernel:
        if mode not in ("batched", "auto"):
            raise ValueError(
                f"use_kernel needs the batched mode (got mode={mode!r}); "
                "the fused kernel only replaces the batched local step")
        from ..kernels import ops as kops
        batch_fn = functools.partial(kops.query_topk, topk=topk,
                                     metric=metric)

    def run(queries, state: ServingState):
        vals, idx = quorum_query_topk(
            queries, state.stack, state.stack_valid, mask_table, topk=topk,
            comm=comm, schedule=sched, mode=mode, metric=metric,
            batch_fn=batch_fn)
        return vals[0], idx[0]              # all device copies identical

    return run


class ServingCorpus:
    """Host-side handle: resident corpus state + cached query callables.

    >>> corpus = ServingCorpus.build(vectors, SingleProcessComm(8))
    >>> scores, ids = corpus.query(q, topk=8)
    >>> corpus.replace_block(3, new_vectors)     # streamed, no reshuffle
    >>> corpus.append_block(more_vectors)        # lands in empty capacity
    """

    def __init__(self, comm: Comm, state: ServingState,
                 filled: np.ndarray, placement: Placement | None = None):
        self.comm = comm
        self.state = state
        self.filled = filled  # [P] valid-row count per block, on every rank
        self.P = comm.P
        self.placement = (get_placement("cyclic", self.P)
                          if placement is None
                          else resolve_placement(placement, self.P))
        self.block = state.shard.shape[1]
        self.d = state.shard.shape[2]
        self.schedule = self.placement.schedule()
        self.plan = build_cover(self.P, self.placement)
        self.quant = None        # QuantServing when built with quant != off

    @classmethod
    def build(cls, corpus, comm: Comm, block: int | None = None,
              placement=None, quant: str | None = None) -> "ServingCorpus":
        """``corpus`` [N, d] (numpy or tensor) becomes resident on
        ``comm.device`` (under ``DistributedComm``: each rank's shard and
        quorum on its device; every rank passes the same corpus, and keeps
        it on the host where it lies).  ``block`` (optional) reserves a larger per-block
        row capacity than ceil(N/P), leaving empty slots for streamed
        appends.  ``placement`` picks the residency layer (a Placement or
        spec name); None defers to ``REPRO_PLACEMENT`` (default auto ==
        cyclic).  ``quant`` additionally keeps a quantized resident stack
        (core/quant.py ``QuantServing``) that :meth:`query` scores against
        with certified exact rescoring: ``"int8"`` / ``"bf16"`` enable it,
        ``"off"`` stays f32, None defers to ``REPRO_QUANT``."""
        P = comm.P
        plc = (placement_from_env(P) if placement is None
               else resolve_placement(placement, P))
        state = build_state(corpus, comm, block=block, placement=plc)
        block = state.shard.shape[1]
        N = corpus.shape[0]
        filled = np.clip(N - block * np.arange(P), 0, block).astype(np.int64)
        out = cls(comm, state, filled, placement=plc)
        from ..core.quant import QuantServing, quant_from_env
        qmode = quant_from_env() if quant is None else quant
        if qmode != "off":
            # the f32 mirror: on the device in one process, on the host
            # for a rank (QuantServing's RescoreRows)
            where = comm.device if len(comm.local) == P else "cpu"
            rows = torch.zeros(P * block, out.d, dtype=torch.float32,
                               device=where)
            rows[:N] = torch.as_tensor(corpus, dtype=torch.float32).to(where)
            out.quant = QuantServing(qmode, comm, out.schedule, block, rows)
        return out

    @property
    def n_valid(self) -> int:
        """Total valid corpus rows across all blocks."""
        return int(self.filled.sum())

    def _queries(self, queries) -> torch.Tensor:
        return torch.as_tensor(queries, dtype=torch.float32,
                               device=self.comm.device)

    def query(self, queries, *, topk: int, mode: str = "auto",
              metric: str = "dot", use_kernel: bool = False):
        """queries [Q, d] -> (scores [Q, topk], global row ids [Q, topk]).

        The cached callable is keyed on the power-of-two bucket
        ``quantize_pow2(topk)`` rather than the raw ``topk`` and the result
        is sliced back to ``topk`` columns — exact by the prefix property
        of the (-score, index) total order.  ``use_kernel`` routes the
        batched step through the B4 kernel (at most 1024 per bucket).

        With tracing on, each call is a ``serving.query`` host span
        (synchronized with the device, so the span is the true end-to-end
        latency) and a ``serving.queries`` counter.

        A corpus built with ``quant != "off"`` scores against its quantized
        stack and rescores the certified candidates exactly
        (``core.quant.serving_query``): the same results, global row ids
        as int64; the B4 kernel does not apply there."""
        if topk < 1:
            raise ValueError(f"topk must be >= 1, got {topk}")
        if self.quant is not None:
            if use_kernel:
                raise ValueError(
                    "use_kernel applies to the f32 serving path only; "
                    "the quantized path has no fused kernel (rebuild "
                    "with quant='off' for kernel queries)")
            from ..core.quant import serving_query
            return serving_query(self, queries, topk=topk, mode=mode,
                                 metric=metric)
        kq = quantize_pow2(topk)
        run = query_fn(self.comm, kq, mode, metric, use_kernel,
                       self.placement)
        q = self._queries(queries)
        # the B4 kernel scores a query the same in any launch width; the
        # library path launches QUERY_CHUNK rows at a time
        width = None if use_kernel else QUERY_CHUNK
        tr = obs_trace.get_tracer()
        if not tr:
            out = _launch_rows(lambda r: run(r, self.state), q, width=width)
        else:
            with tr.span("serving.query", Q=int(q.shape[0]), topk=topk,
                         mode=mode, metric=metric, P=self.P):
                out = _launch_rows(lambda r: run(r, self.state), q,
                                   width=width)
                if q.device.type == "cuda":
                    torch.cuda.synchronize(q.device)
            tr.count("serving.queries", int(q.shape[0]))
        if kq == topk:
            return out
        return out[0][:, :topk], out[1][:, :topk]

    def query_threshold(self, queries, *, threshold,
                        capacity: int | None = None, mode: str = "auto",
                        metric: str = "dot", escalate: bool = True,
                        max_doublings: int = 16):
        """Range query: every corpus row with score >= threshold, per query.

        queries [Q, d] -> ``(scores [Q, cap], global row ids [Q, cap],
        count [Q])``, each query's hits sorted by ascending corpus index
        with (NEG_INF, IDX_SENTINEL) sentinels past ``count``.
        ``threshold`` is a scalar or a per-query ``[Q]`` vector.

        ``capacity`` defaults to the ``REPRO_SPARSE_CAPACITY``-aware
        heuristic; the working capacity ``cap`` is its
        :func:`quantize_pow2` bucket (clamped to the corpus size), and
        escalation doubles along the same ladder until every query's true
        ``count`` fits (capped at the corpus size); with
        ``escalate=False`` the first pass returns as-is — ``count > cap``
        then marks a truncated query.
        """
        total_rows = self.P * self.block
        cap_req = (int(capacity) if capacity is not None
                   else min(default_capacity(total_rows), total_rows))
        cap = min(quantize_pow2(cap_req), total_rows)
        q = self._queries(queries)
        Q = q.shape[0]
        thr = torch.as_tensor(threshold, dtype=torch.float32,
                              device=q.device).broadcast_to((Q,))
        escalations = 0
        tr = obs_trace.get_tracer()
        span = tr.span("serving.query_threshold", Q=Q,
                       mode=mode, metric=metric, P=self.P) if tr \
            else obs_trace.NOOP.span("")
        with span:
            while True:
                run = threshold_fn(self.comm, cap, mode, metric,
                                   self.placement)
                # QUERY_CHUNK rows a launch; padding rows match nothing
                vals, idx, cnt = _launch_rows(
                    lambda r, t: run(r, t, self.state), q, thr,
                    width=QUERY_CHUNK)
                if not escalate:        # the caller reads the counts
                    break
                # the ring gave every device every count: the processes
                # must agree on them before they escalate together
                counts = sweep_mod.agreed(self.comm, cnt.cpu().numpy(),
                                          "range-query counts")
                if (not (counts > cap).any() or cap >= total_rows
                        or escalations >= max_doublings):
                    break
                cap = min(2 * cap, total_rows)
                escalations += 1
        if tr:
            tr.count("serving.queries", Q)
            tr.count("serving.threshold_escalations", escalations)
        if escalate and (counts > cap).any():
            raise RuntimeError(
                f"thresholded query still overflows capacity {cap} after "
                f"{escalations} doublings; raise `capacity` or the "
                "threshold")
        return vals, idx, cnt

    def _check_block_data(self, data, what: str) -> torch.Tensor:
        """Validate streamed block payloads at the handle layer: ``data``
        must be ``[rows, d]`` with ``rows <= block`` — so oversized or
        misshapen updates fail here with the block capacity in the
        message (DESIGN.md section 9.4)."""
        arr = torch.as_tensor(data, dtype=torch.float32)
        if arr.dim() != 2 or arr.shape[1] != self.d:
            raise ValueError(
                f"{what} data must be a [rows, {self.d}] array (the "
                f"corpus embedding dim), got shape {tuple(arr.shape)}")
        if arr.shape[0] > self.block:
            raise ValueError(
                f"{what} data has {arr.shape[0]} rows but the block "
                f"capacity is {self.block}; split the update or rebuild "
                "with a larger `block` (ServingCorpus.build)")
        return arr

    def replace_block(self, b: int, data, nvalid: int | None = None) -> None:
        """Replace block ``b`` in place (streamed to its k holder
        quorums).  ``data`` must be ``[rows <= block capacity, d]``."""
        if not 0 <= b < self.P:
            raise ValueError(f"block id {b} out of range [0, {self.P})")
        data = self._check_block_data(data, f"replace_block({b})")
        self.state = replace_block(self.state, self.comm, b, data, nvalid,
                                   placement=self.placement)
        self.filled[b] = (data.shape[0] if nvalid is None else nvalid)
        if self.quant is not None:
            self.quant.update_block(b, data, int(self.filled[b]))

    def append_block(self, data) -> int:
        """Stream ``data`` (rows <= block capacity, validated at this
        layer) into the first empty block slot; returns the block id it
        landed in."""
        data = self._check_block_data(data, "append_block")
        empty = np.nonzero(self.filled == 0)[0]
        if empty.size == 0:
            raise ValueError(
                "corpus full: no empty block slot; grow the quorum axis "
                "to add capacity")
        b = int(empty[0])
        self.replace_block(b, data)
        return b
