"""All-pairs k-NN graph construction over quorum placements (counterpart
of ``repro/core/knn.py``, DESIGN.md section 12.3).

For every corpus row, the top-k nearest other rows: a per-row top-k
selection over the full O(N^2) pair sweep, on the port's pair-sweep
runtime (core/sweep.py), which owns the schedule, the gather, the modes and
the kernel hook.  This module supplies the emitter and the monoid:

  * **emitter** — :class:`KnnEmitter`: each scheduled tile's [block,
    block] scores feed *both* endpoints' lists (rows of the ``lo`` block
    take the ``hi`` block's rows as candidates and vice versa; self tiles
    exclude the diagonal and contribute one side), masked by the
    ownership rules and folded into per-slot running [P, k, block, topk]
    lists under the (-score, index) total order.  The hand-written B6
    kernel (kernels/pairwise_topk.py) replaces the batched step through
    the ``batch_fn`` hook.
  * **monoid** — the scatter reduction is a top-k *merge*:
    ``quorum_scatter`` routes each slot's partial lists home with the
    inverse shifts and folds arrivals with the selection merge.
  * **delta rules** — :meth:`KnnEmitter.delta_retract` /
    :meth:`KnnEmitter.delta_fold` patch a standing graph under churn
    (``core/delta.py``); :func:`lexsort_topk` is their selection.

Every candidate row v != u reaches u's list exactly once globally (the
ownership partition plus the even-P dedup mask), and selection by a strict
total order makes the merges associative, so every mode, the kernel and
the scatter order give identical indices.  l2 scores use the
orientation-consistent order ``(2 dot - |cand|^2) - |row|^2`` on both
sides of a tile.

Every per-device tensor carries the comm layer's leading axis over the L
devices this process holds (L = P in one process, 1 a rank under
``DistributedComm``; written ``[P, ...]`` below, as in one process).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from ..kernels.ref import IDX_SENTINEL, NEG_INF, topk_by_score_index
from ..kernels.ref import QUERY_METRICS as KNN_METRICS
from . import sweep as sweep_mod
from .comm import (Comm, DistributedComm, SingleProcessComm, pad_local,
                   run_main, tree_map)
from .scheduler import PairSchedule
from .sparse import _pair_meta, _pair_score_matrix
from .sweep import ENGINE_MODES, SweepEmitter, pair_mask_table, quorum_scatter

__all__ = [
    "KnnEmitter",
    "KnnResult",
    "quorum_allpairs_knn",
    "knn_graph",
    "brute_force_knn",
    "lexsort_topk",
    "KNN_METRICS",
]

_LOW = (1 << 32) - 1
#: the missing-neighbour id of int64 candidate lists (``core/delta.py``,
#: ``core/faults.py``)
SENT_I64 = torch.iinfo(torch.int64).max


def lexsort_topk(scores: torch.Tensor, idx: torch.Tensor, topk: int):
    """The first ``topk`` (score, index) entries of each row under the
    strict (-score, index) order, best first: ``np.lexsort((idx,
    -score))`` and a slice, through the packed-key ``torch.topk`` of
    ``kernels.ref.topk_by_score_index``.  ``idx`` is int64 with ids below
    2^32 - 1 and the int64-max sentinel, which ranks last among equal
    scores.  Rows shorter than ``topk`` pad with (-inf, sentinel)."""
    m = scores.shape[1]
    if m < topk:
        scores = torch.nn.functional.pad(scores, (0, topk - m),
                                         value=float("-inf"))
        idx = torch.nn.functional.pad(idx, (0, topk - m), value=SENT_I64)
    s, i = topk_by_score_index(scores, idx.clamp(max=_LOW), topk)
    return s, torch.where(i == _LOW, SENT_I64, i)


def _merge_lists(cv, ci, sv, si, topk: int):
    """Fold candidate (scores, ids) into running [..., topk] lists by the
    (-score, index) total order — the k-NN selection monoid (core/sweep.py
    topk_by_score)."""
    return sweep_mod.topk_by_score(torch.cat([cv, sv], dim=-1),
                                   torch.cat([ci, si], dim=-1), topk)


def _item_candidates(dots, n2_lo, n2_hi, metric: str, active,
                      is_self: bool, ga, gb, nv_lo, nv_hi, block_rows: int):
    """Both orientations' masked candidate planes of one tile for every
    device, from its dots [P, block, block] and the two blocks' squared
    norms [P, block] — the single home of the k-NN tile masking (as
    ``kernels/ref.py:pairwise_topk``); active / ga / gb / nv_lo / nv_hi
    [P].  Returns (lo-side scores [P, block, block], lo-side ids, hi-side
    scores, hi-side ids); the hi side is all sentinel on a self tile."""
    if metric == "l2":
        t_lo = (2.0 * dots - n2_hi[:, None, :]) - n2_lo[:, :, None]
        t_hi = (2.0 * dots - n2_lo[:, :, None]) - n2_hi[:, None, :]
    else:
        t_lo = t_hi = dots
    dev = dots.device
    r = torch.arange(dots.shape[1], device=dev)[:, None]
    s = torch.arange(dots.shape[2], device=dev)[None, :]
    act = active[:, None, None]
    keep = (act & (s < nv_hi[:, None, None])).expand_as(t_lo)
    if is_self:
        keep = keep & (r != s)
    cv_l = torch.where(keep, t_lo, NEG_INF)
    ci_l = torch.where(keep, (gb[:, None, None] * block_rows + s)
                       .to(torch.int32), IDX_SENTINEL)
    keep_t = (act & (not is_self) & (r < nv_lo[:, None, None])).expand_as(t_hi)
    cv_h = torch.where(keep_t, t_hi, NEG_INF).transpose(-1, -2)
    ci_h = torch.where(keep_t, (ga[:, None, None] * block_rows + r)
                       .to(torch.int32), IDX_SENTINEL).transpose(-1, -2)
    return cv_l, ci_l, cv_h, ci_h


def _select_mode(schedule: PairSchedule, block: int,
                 batch_fn: Optional[Callable]) -> str:
    """The k-NN engine's ``mode="auto"`` working set fed to the shared
    heuristic (core/sweep.py select_mode): two [n_pairs, block, block]
    candidate planes (f32 scores + i32 ids) per tile orientation."""
    return sweep_mod.select_mode(
        schedule, schedule.n_pairs * block * block * 16, batch_fn)


class KnnEmitter(SweepEmitter):
    """Per-row top-k selection over the scheduled pairs (DESIGN.md section
    12.3 — the k-NN graph workload).

    Folds every tile's two candidate planes into per-slot running [P, k,
    block, topk] (value, index) lists; the adapter then scatter-*merges*
    the per-slot partials at the block owners.  Its delta rules patch a
    standing graph for ``core/delta.py``.
    """

    def __init__(self, schedule: PairSchedule, mask, topk: int, metric: str,
                 block: int, meta, batch_fn=None):
        self.schedule = schedule
        self.mask = mask
        self.topk = topk
        self.metric = metric
        self.block = block
        self.lo, self.hi, self.ga, self.gb, self.nv_lo, self.nv_hi, \
            self.is_self = meta
        self.batch_fn = batch_fn
        self.P = mask.shape[0]

    @staticmethod
    def delta_retract(standing, stale, ctx=None):
        """The rows whose standing neighbour list cites a retracted
        source (DESIGN.md section 16.4).  Top-k selection is not
        invertible (a removed neighbour can expose a candidate the list
        already dropped), so retraction returns the *refresh set*:
        ``standing`` is ``(scores, indices [n, k])``, ``stale`` the dirty
        global-id ``(starts, stops)`` ranges, the result an [n] bool mask
        of rows the delta index rebuilds from its per-tile ledger."""
        best_i = standing[1]
        starts = torch.as_tensor(stale[0], dtype=torch.int64,
                                 device=best_i.device)
        stops = torch.as_tensor(stale[1], dtype=torch.int64,
                                device=best_i.device)
        hit = ((best_i[:, :, None] >= starts) & (best_i[:, :, None] < stops))
        return hit.any(dim=2).any(dim=1)

    @staticmethod
    def delta_fold(standing, fresh, ctx=None):
        """Merge fresh per-row candidates into standing neighbour lists
        under the strict (-score, index) total order (DESIGN.md section
        16.4), an associative, commutative monoid.  Both arguments are
        ``(scores [n, k], indices [n, k])`` with the (-inf, int64 max)
        sentinel padding."""
        s = torch.cat([standing[0], fresh[0]], dim=1)
        i = torch.cat([standing[1], fresh[1]], dim=1)
        return lexsort_topk(s, i, standing[0].shape[1])

    def meta_rows(self) -> torch.Tensor:
        """The [P, n_pairs, 6] int32 ``(active, is_self, ga, gb, nv_lo,
        nv_hi)`` rows the batched step and the kernels take."""
        P, n = self.mask.shape
        return torch.stack([(self.mask > 0).to(torch.int32),
                            self.is_self.to(torch.int32).expand(P, n),
                            self.ga.to(torch.int32), self.gb.to(torch.int32),
                            self.nv_lo.to(torch.int32),
                            self.nv_hi.to(torch.int32)], dim=-1)

    def batch(self, quorum):
        """Every tile in one batched accumulation.  The batched step IS the
        plain version (``kernels/ref.py:pairwise_topk``), with the B6
        kernel swapping in through the same hook."""
        batch_fn = self.batch_fn
        if batch_fn is None:
            from ..kernels import ref as kref
            batch_fn = functools.partial(
                kref.pairwise_topk, topk=self.topk, block_rows=self.block,
                metric=self.metric)
        return batch_fn(quorum, self.lo, self.hi, self.meta_rows())

    def scan_init(self):
        """Sentinel-filled per-slot running lists [P, k, block, topk]."""
        shape = (self.P, self.schedule.k, self.block, self.topk)
        dev = self.mask.device
        return (torch.full(shape, NEG_INF, dtype=torch.float32, device=dev),
                torch.full(shape, IDX_SENTINEL, dtype=torch.int32,
                           device=dev))

    def scan_items(self):
        """The pair indices, walked in order."""
        return np.arange(self.schedule.n_pairs)

    @staticmethod
    def _tile(bi, bj):
        """One tile's dots [P, block, block] and both blocks' squared norms
        [P, block], each norm summed once per row."""
        return (bi @ bj.transpose(-1, -2), torch.sum(bi * bi, dim=-1),
                torch.sum(bj * bj, dim=-1))

    def _fold(self, carry, idx: int, bi, bj):
        """Merge pair ``idx``'s two candidate planes into the running
        lists of its slots (a self tile contributes one side)."""
        vals, idx_l = carry
        lo_s, hi_s = (int(s) for s in self.schedule.pair_slots[idx])
        cv_l, ci_l, cv_h, ci_h = _item_candidates(
            *self._tile(bi, bj), self.metric, self.mask[:, idx] > 0,
            bool(self.schedule.pair_diff[idx] == 0), self.ga[:, idx],
            self.gb[:, idx], self.nv_lo[:, idx], self.nv_hi[:, idx],
            self.block)
        vals[:, lo_s], idx_l[:, lo_s] = _merge_lists(
            vals[:, lo_s], idx_l[:, lo_s], cv_l, ci_l, self.topk)
        if lo_s != hi_s:
            vals[:, hi_s], idx_l[:, hi_s] = _merge_lists(
                vals[:, hi_s], idx_l[:, hi_s], cv_h, ci_h, self.topk)
        return vals, idx_l

    def scan_emit(self, carry, quorum, item):
        """Serial per-pair merge (the low-memory oracle)."""
        idx = int(item)
        lo_s, hi_s = (int(s) for s in self.schedule.pair_slots[idx])
        return self._fold(carry, idx, tree_map(lambda a: a[:, lo_s], quorum),
                          tree_map(lambda a: a[:, hi_s], quorum))

    def overlap_begin(self):
        """Boxed per-slot running lists the unrolled sweep updates."""
        return {"carry": self.scan_init()}

    def overlap_emit(self, state, idx, bi, bj):
        """Merge one tile as soon as its later block lands."""
        state["carry"] = self._fold(state["carry"], idx, bi, bj)

    def overlap_finalize(self, state):
        """The per-slot running lists, ready for the scatter merge."""
        return state["carry"]


def quorum_allpairs_knn(
    x: torch.Tensor,
    comm: Comm,
    *,
    topk: int,
    schedule: PairSchedule | None = None,
    placement=None,
    metric: str = "dot",
    mode: str = "auto",
    mask: torch.Tensor | None = None,
    n_valid: int | None = None,
    batch_fn: Callable | None = None,
):
    """Distributed all-pairs k-NN graph construction (DESIGN.md section
    12.3).

    ``x`` is ``[L, block, d]`` on ``comm.device``, the blocks of the L
    devices this process holds.  Returns ``(scores [L, block, topk],
    indices [L, block, topk])`` — each *valid* row's top-k
    nearest other valid rows (self excluded) by the (-score, index) total
    order, with (NEG_INF, IDX_SENTINEL) sentinels when fewer than
    ``topk`` candidates exist; rows beyond ``n_valid`` carry unspecified
    lists.  ``placement`` / ``schedule`` / ``mode`` / ``n_valid`` as in
    :func:`core.sparse.quorum_allpairs_threshold`; ``batch_fn(quorum, lo,
    hi, meta) -> (vals, idx)`` is the fused-kernel hook
    (``kernels.ops.pairwise_topk``), batched mode only.
    """
    if metric not in KNN_METRICS:
        raise ValueError(f"metric must be one of {KNN_METRICS}, "
                         f"got {metric!r}")
    if topk < 1:
        raise ValueError(f"topk must be >= 1, got {topk}")
    sweep_mod.validate_mode(mode, batch_fn)
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

    lo, hi, ga, gb, nv_lo, nv_hi, is_self, _nv = _pair_meta(
        schedule, comm, block, n_valid)
    emitter = KnnEmitter(schedule, mask, topk, metric, block,
                         (lo, hi, ga, gb, nv_lo, nv_hi, is_self),
                         batch_fn=batch_fn)
    vals, idx = sweep_mod.pair_sweep(emitter, schedule=schedule, comm=comm,
                                     mode=mode, x=x)
    partials = [(vals[:, s], idx[:, s]) for s in range(schedule.k)]
    return quorum_scatter(
        partials, schedule, comm,
        reduce_fn=lambda a, b: _merge_lists(a[0], a[1], b[0], b[1], topk))


# ---------------------------------------------------------------------------
# Host-level driver + oracle (DESIGN.md section 12.3)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class KnnResult:
    """Host-side k-NN graph (:func:`knn_graph`).

    ``indices[r]`` lists row ``row0 + r``'s ``topk`` nearest other rows
    (best first by the (-score, index) order); ``scores`` the matching
    scores.  When the corpus has fewer than ``topk`` other rows, the tail
    is (IDX_SENTINEL, NEG_INF) padding.  ``row0`` is 0 in one process,
    where the graph has every row; under ``DistributedComm`` a rank holds
    the rows of its own block, from ``row0 = rank * block``.
    """

    indices: np.ndarray
    scores: np.ndarray
    topk: int
    row0: int = 0

    @property
    def n_rows(self) -> int:
        """Number of corpus rows in the graph."""
        return int(self.indices.shape[0])


@functools.lru_cache(maxsize=64)
def _knn_fn(comm: Comm, N: int, block: int, topk: int,
            metric: str, mode: str, use_kernel: bool, placement):
    """Build (and cache) the distributed k-NN callable ``f(x [P, block,
    d]) -> (vals, idx [P, block, topk])`` per (comm, shape, topk, ...)
    key."""
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
        batch_fn = functools.partial(kops.pairwise_topk, topk=topk,
                                     block_rows=block, metric=metric)

    def run(xs):
        return quorum_allpairs_knn(
            xs, comm, topk=topk, schedule=sched, mask=mask_table,
            metric=metric, mode=mode, n_valid=N, batch_fn=batch_fn)
    return run


def knn_graph(corpus, comm: Comm, *, topk: int,
              metric: str = "dot", mode: str = "auto", placement=None,
              use_kernel: bool = False,
              quant: str | None = None) -> KnnResult:
    """The k-NN graph of ``corpus`` rows, exactly (DESIGN.md section
    12.3).

    The host entry point: pads the [N, d] corpus (numpy or tensor) into P
    quorum blocks, puts this process's on ``comm.device``, runs
    :func:`quorum_allpairs_knn` under the selected placement (None defers
    to ``REPRO_PLACEMENT``), and slices the padding rows off: every row in
    one process, the rank's own block's rows under ``DistributedComm``
    (``KnnResult.row0``).  ``use_kernel`` routes the batched step
    through the B6 kernel.  ``quant`` selects the quantized candidate
    generation with certified rescoring (DESIGN.md section 17): ``"int8"``
    / ``"bf16"`` route through :func:`core.quant.quant_knn_graph`
    (identical results), ``"off"`` forces f32, None defers to
    ``REPRO_QUANT``.
    """
    from . import quant as quant_mod
    if quant is None:
        quant = quant_mod.quant_from_env()
    if quant != "off":
        return quant_mod.quant_knn_graph(
            corpus, comm, topk=topk, quant=quant, metric=metric, mode=mode,
            placement=placement, use_kernel=use_kernel)
    P = comm.P
    from .placement import placement_from_env, resolve_placement
    plc = (placement_from_env(P) if placement is None
           else resolve_placement(placement, P))
    xs = pad_local(corpus, comm)
    N = int(torch.as_tensor(corpus).shape[0])
    run = _knn_fn(comm, N, xs.shape[1], int(topk), metric, mode,
                  use_kernel, plc)
    vals, idx = run(xs)
    row0, n = local_row_span(comm, xs.shape[1], N)
    return KnnResult(indices=idx.reshape(-1, topk)[:n].cpu().numpy(),
                     scores=vals.reshape(-1, topk)[:n].cpu().numpy(),
                     topk=int(topk), row0=row0)


def local_row_span(comm: Comm, block: int, N: int) -> tuple[int, int]:
    """(first global row, valid row count) of the blocks this process
    holds, of an N-row corpus in blocks of ``block`` rows."""
    row0 = comm.local.start * block
    return row0, max(0, min(N, comm.local.stop * block) - row0)


def brute_force_knn(corpus: np.ndarray, topk: int,
                    metric: str = "dot") -> KnnResult:
    """Dense O(N^2) oracle: each row's top-k other rows by the engine's
    (-score, index) total order, same float32 score formulas,
    sentinel-padded when topk > N - 1."""
    s = _pair_score_matrix(corpus, metric)
    N = s.shape[0]
    eff = min(topk, N - 1)
    idx = np.full((N, topk), np.int32(IDX_SENTINEL), np.int32)
    vals = np.full((N, topk), np.float32(NEG_INF), np.float32)
    for r in range(N):
        cand = np.concatenate([np.arange(r), np.arange(r + 1, N)])
        order = np.lexsort((cand, -s[r, cand]))[:eff]
        idx[r, :eff] = cand[order]
        vals[r, :eff] = s[r, cand[order]]
    return KnnResult(indices=idx, scores=vals, topk=int(topk))


# ---------------------------------------------------------------------------
# Selfcheck (python -m repro_torch.core.knn)
# ---------------------------------------------------------------------------

def selfcheck_main(nblocks: int = 8,
                   modes: Sequence[str] = ENGINE_MODES + ("kernel",),
                   placement: str | None = None, device=None,
                   comm: Comm | None = None) -> None:
    """Distributed k-NN graph selfcheck on ``comm`` (default: a
    ``SingleProcessComm`` of ``nblocks`` devices on ``device``, itself
    defaulting to the CUDA device).

    Run as ``python -m repro_torch.core.knn [P] [modes] [placement]
    [--device cpu] [--dist gloo|nccl]`` (``--dist``: one device a
    torchrun process).  Asserts exact neighbour-index equality with the
    dense brute-force oracle's rows (a rank's: its own block's) for every
    requested mode (``kernel`` is the batched path through the B6 hook),
    both metrics, a ragged corpus tail, and an underfull (topk > N - 1)
    list with sentinel padding.
    """
    from .placement import placement_from_env, resolve_placement

    Pn = int(nblocks)
    comm = SingleProcessComm(Pn, device) if comm is None else comm
    if comm.P != Pn:
        raise ValueError(f"the comm has P={comm.P} devices, not {Pn}")
    plc = (placement_from_env(Pn) if placement is None
           else resolve_placement(placement, Pn))
    block, d, topk = 8, 16, 4
    rng = np.random.default_rng(0)
    N = Pn * block - 3          # ragged tail: exercises row validity
    corpus = rng.normal(size=(N, d)).astype(np.float32)

    for metric in KNN_METRICS:
        want = brute_force_knn(corpus, topk, metric)
        label = f"P={Pn} metric={metric}"
        for m in modes:
            mode, uk = ("batched", True) if m == "kernel" else (m, False)
            got = knn_graph(corpus, comm, topk=topk, metric=metric,
                            mode=mode, placement=plc, use_kernel=uk,
                            quant="off")
            rows = slice(got.row0, got.row0 + got.n_rows)
            np.testing.assert_array_equal(
                got.indices, want.indices[rows], err_msg=f"{label} mode={m}")
            np.testing.assert_allclose(
                got.scores, want.scores[rows], rtol=1e-5, atol=1e-5,
                err_msg=f"{label} mode={m}")

    # underfull lists: topk exceeds the candidate count; the tail must be
    # exact (IDX_SENTINEL, NEG_INF) padding in every mode
    tiny = rng.normal(size=(Pn + 2, d)).astype(np.float32)
    want = brute_force_knn(tiny, Pn + 4, "dot")
    for m in modes:
        mode, uk = ("batched", True) if m == "kernel" else (m, False)
        got = knn_graph(tiny, comm, topk=Pn + 4, mode=mode, placement=plc,
                        use_kernel=uk, quant="off")
        np.testing.assert_array_equal(
            got.indices, want.indices[got.row0:got.row0 + got.n_rows],
            err_msg=f"underfull mode={m}")

    where = (f" rank={comm.rank} transport={comm.transport}"
             if isinstance(comm, DistributedComm) else "")
    print(f"knn selfcheck OK: P={Pn} placement={plc.describe()} "
          f"modes={','.join(modes)} device={comm.device}{where} N={N} "
          f"topk={topk} metrics={','.join(KNN_METRICS)}")


if __name__ == "__main__":
    import argparse
    ap = argparse.ArgumentParser(description="k-NN graph selfcheck")
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
