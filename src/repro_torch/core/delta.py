"""Incremental delta-sweep: dirty-block scheduling that maintains standing
sweep outputs under churn (counterpart of ``repro/core/delta.py``,
DESIGN.md section 16).

A set D of dirty blocks invalidates exactly the pair tiles with >= 1
endpoint in D: ``|D|*P - C(|D|,2) <= |D|*P`` tiles, not O(P^2) (Ullman's
output-sensitive "Some Pairs" framing, arXiv:1602.01443).  This module
owns that schedule and the code around it:

  * :func:`dirty_tiles` — the one shared dirty-tile enumerator (sorted,
    canonical (x, y) x <= y order) that the delta scheduler here and the
    failure recovery of ``core/faults.py`` both use.
  * :func:`owner_partition` — the exactly-once tile -> owner partition
    over the holder quorums (``Placement.owner_of`` /
    ``weighted_owner_table``), shared with the fault-tolerant sweep.
  * :func:`delta_sweep` — run only the dirty tiles, grouped into the
    engine mode's rounds (:func:`core.sweep.sweep_rounds`).
  * :class:`DeltaIndex` — a standing output kept current: a per-tile
    partials ledger plus each emitter's patch rule (``delta_retract`` /
    ``delta_fold`` on the ``SweepEmitter`` classes): subtract-then-add
    for the dense reduce (published as a canonical-order refold of the
    ledger, which keeps it bit-exact), a hit-set patch for the join, and
    the per-row candidate refresh for the k-NN graph.

The workloads (``core/faults.py``) hold their blocks and partials as
tensors on their device; the schedule is host-side.  The check is the
churn differential selfcheck (``python -m repro_torch.core.delta
[--device cpu]``): random replace / append updates across every
registered placement x engine mode x P, asserting after every update that
the maintained output is bit-identical to a from-scratch recompute and
that the delta sweep touched at most ``|dirty| * P`` tiles.
"""

from __future__ import annotations

import dataclasses
from typing import (Any, Dict, Iterable, List, Mapping, Optional, Sequence,
                    Tuple)

import numpy as np
import torch

from . import env as env_mod
from .allpairs import DenseReduceEmitter
from .knn import SENT_I64, KnnEmitter
from .placement import (Placement, get_placement, registered_placements,
                        resolve_placement, weighted_owner_table)
from .sparse import ThresholdJoinEmitter
from .sweep import ENGINE_MODES, sweep_rounds

__all__ = [
    "DELTA_P",
    "dirty_tiles",
    "owner_partition",
    "delta_rounds",
    "delta_sweep",
    "DeltaStats",
    "DeltaIndex",
    "churn_workload",
    "scratch_fold",
    "churn_selfcheck",
]

# the churn matrix: odd / even P, the projective planes 7 and 13, the
# affine plane 12, and the small even P = 4
DELTA_P = (4, 5, 7, 8, 12, 13)

# workload name -> the SweepEmitter class carrying its patch rule
_EMITTER_OF = {
    "dense": DenseReduceEmitter,
    "sparse": ThresholdJoinEmitter,
    "knn": KnnEmitter,
}


def dirty_tiles(placement: Optional[Placement], dirty: Iterable[int],
                P: Optional[int] = None) -> List[Tuple[int, int]]:
    """All pair tiles (x, y), x <= y, with at least one endpoint block in
    ``dirty``, in sorted canonical order (DESIGN.md section 16.1).

    The delta scheduler runs exactly these tiles, and the failure
    recovery of ``core/faults.py`` scans the same set for a dead device's
    lost work (every pair a device can own has >= 1 endpoint among its
    resident blocks).  The order is the canonical fold order and the
    tie-break order ``scheduler.reassign`` sees, so plans built on it
    are stable.  ``P`` defaults to ``placement.P``.
    """
    if P is None:
        if placement is None:
            raise ValueError("need a placement or an explicit P")
        P = placement.P
    D = {int(b) for b in dirty}
    for b in D:
        if not 0 <= b < P:
            raise ValueError(f"dirty block {b} outside [0, {P})")
    return [(x, y) for x in range(P) for y in range(x, P)
            if x in D or y in D]


def owner_partition(placement: Placement,
                    pairs: Optional[Sequence[Tuple[int, int]]] = None, *,
                    weights: Optional[Sequence[float]] = None
                    ) -> Dict[Tuple[int, int], int]:
    """The exactly-once tile -> owner map over the holder quorums
    (DESIGN.md section 16.1): ``Placement.owner_of``, or the
    capacity-weighted ``weighted_owner_table`` when ``weights`` is given.
    ``pairs`` defaults to every canonical tile."""
    P = placement.P
    if pairs is None:
        pairs = [(x, y) for x in range(P) for y in range(x, P)]
    if weights is not None:
        table = weighted_owner_table(placement, weights)
        return {(x, y): int(table[x, y]) for (x, y) in pairs}
    return {(x, y): int(placement.owner_of(x, y)) for (x, y) in pairs}


def delta_rounds(placement: Placement, tiles: Sequence[Tuple[int, int]],
                 mode: str) -> List[List[Tuple[int, int]]]:
    """Group dirty tiles into the engine mode's synchronization rounds
    (DESIGN.md section 16.1): a tile lands in the round its difference
    class occupies under :func:`core.sweep.sweep_rounds` (batched: one
    round; overlap: the ready groups; scan: one tile per round), so a
    delta sweep sees the same boundaries as a full sweep in that mode.
    Within a round tiles stay sorted; empty rounds are dropped."""
    if mode not in ENGINE_MODES:
        raise ValueError(f"mode must be one of {ENGINE_MODES}, got {mode!r}")
    P = placement.P
    sched = placement.schedule()
    rounds = sweep_rounds(sched, mode)
    sidx_of_diff = {int(d): s for s, d in enumerate(sched.pair_diff)}
    round_of_sidx = {s: r for r, grp in enumerate(rounds) for s in grp}
    if mode == "scan":
        return [[t] for t in sorted(tiles)]
    grouped: Dict[int, List[Tuple[int, int]]] = {}
    for t in tiles:
        d = (t[1] - t[0]) % P
        dd = min(d, P - d) if P > 1 else 0
        grouped.setdefault(round_of_sidx[sidx_of_diff[dd]], []).append(t)
    return [sorted(grouped[r]) for r in sorted(grouped)]


def delta_sweep(workload, placement: Placement, dirty: Iterable[int], *,
                mode: str = "batched",
                owner_map: Optional[Mapping[Tuple[int, int], int]] = None,
                stats: Optional["DeltaStats"] = None
                ) -> Dict[Tuple[int, int], Any]:
    """Recompute only the dirty tiles' partials (DESIGN.md section 16.2),
    round by round in ``mode``'s structure, each at its owner
    (:func:`owner_partition` unless ``owner_map`` is given), counting
    tiles swept and per-device work into ``stats``.  Returns ``{tile:
    fresh partial}``.  Partials are pure functions of the block contents,
    so the patch is the same whichever mode shaped the rounds."""
    tiles = dirty_tiles(placement, dirty)
    if owner_map is None:
        owner_map = owner_partition(placement, tiles)
    fresh: Dict[Tuple[int, int], Any] = {}
    for rnd in delta_rounds(placement, tiles, mode):
        for t in rnd:
            x, y = t
            fresh[t] = workload.pair_partial(
                x, y, workload.blocks[x], workload.blocks[y])
            if stats is not None:
                o = int(owner_map[t])
                stats.tiles_by_device[o] = stats.tiles_by_device.get(o, 0) + 1
    if stats is not None:
        stats.tiles_swept += len(fresh)
        stats.last_tiles = len(fresh)
    return fresh


@dataclasses.dataclass
class DeltaStats:
    """Counters a :class:`DeltaIndex` accumulates across updates
    (DESIGN.md section 16.5)."""

    updates: int = 0               # apply() calls that saw dirty blocks
    tiles_swept: int = 0           # tiles recomputed, total
    last_tiles: int = 0            # tiles swept by the latest apply()
    tiles_full: int = 0            # C(P,2)+P, the full-sweep tile count
    full_rebuilds: int = 0         # max-dirty fallbacks to a full sweep
    rows_refreshed: int = 0        # k-NN rows rebuilt from the ledger
    rows_merged: int = 0           # k-NN rows patched by the fast merge
    hits_retracted: int = 0        # join rows retracted from the hit set
    hits_inserted: int = 0         # join rows inserted into the hit set
    tiles_by_device: Dict[int, int] = dataclasses.field(default_factory=dict)

    def as_dict(self) -> Dict[str, Any]:
        """The counters as a plain dict (for JSON output)."""
        return dataclasses.asdict(self)


def _max_dirty_pct_default() -> int:
    val = env_mod.read_knob("REPRO_DELTA_MAX_DIRTY_PCT")
    return 50 if val is None else int(val)


class DeltaIndex:
    """A continuously maintained sweep output (DESIGN.md section 16).

    Holds a per-tile partials **ledger** for one ``PairWorkload``
    (``core/faults.py``'s dense reduce, threshold join or k-NN graph)
    plus the standing folded output.  Updates arrive through
    :meth:`replace_block` (an append is a replace that grows the block
    within its capacity span) or :meth:`mark_dirty` (when the caller
    refreshes ``workload.blocks`` itself); :meth:`apply` recomputes only
    the dirty tiles and patches the standing output under the workload
    emitter's rule:

      * dense — subtract-then-add on a float64 running total; the
        published result is the canonical-order refold of the ledger,
        bit-exact against a from-scratch recompute;
      * join — retract the dirty tiles' stale (i, j) rows, insert the
        fresh ones (a pair's tile is unique: an exact set patch);
      * k-NN — rows in a dirty block, and rows whose list cites one, are
        rebuilt from the per-tile candidate ledger; every other row
        merges the fresh candidates into its list (exact: top-k under
        the strict (-score, index) order is a monoid).

    When more than ``max_dirty_pct`` percent of the blocks are dirty
    (``REPRO_DELTA_MAX_DIRTY_PCT``, default 50) the index rebuilds in
    full instead: the same bits, fewer bookkeeping passes.
    """

    def __init__(self, workload, placement: Placement, *,
                 mode: str = "batched",
                 weights: Optional[Sequence[float]] = None,
                 max_dirty_pct: Optional[int] = None):
        if mode not in ENGINE_MODES:
            raise ValueError(
                f"mode must be one of {ENGINE_MODES}, got {mode!r}")
        if workload.P != placement.P:
            raise ValueError(
                f"workload P={workload.P} != placement P={placement.P}")
        if workload.name not in _EMITTER_OF:
            raise ValueError(
                f"workload {workload.name!r} has no delta emitter rule "
                f"(supported: {tuple(_EMITTER_OF)})")
        self.workload = workload
        self.placement = placement
        self.mode = mode
        self.owner_map = owner_partition(placement, weights=weights)
        self.max_dirty_pct = (
            _max_dirty_pct_default() if max_dirty_pct is None
            else int(max_dirty_pct))
        if not 0 <= self.max_dirty_pct <= 100:
            raise ValueError(
                f"max_dirty_pct must be in [0, 100], got {self.max_dirty_pct}")
        self._emitter = _EMITTER_OF[workload.name]
        self.stats = DeltaStats(tiles_full=len(workload.canonical_pairs()))
        self.pending: set = set()
        self.ledger: Dict[Tuple[int, int], Any] = {}
        self._standing: Any = None
        self._running_total: Optional[torch.Tensor] = None  # dense estimate
        self._best_s: Optional[torch.Tensor] = None          # k-NN standing
        self._best_i: Optional[torch.Tensor] = None
        self._rebuild_all()

    # -- block geometry ---------------------------------------------------
    def span_of(self, b: int) -> int:
        """Block ``b``'s capacity span in global-index space: the id range
        ``[offsets[b], offsets[b] + span)`` is stable under churn, so an
        append never renumbers another block."""
        wl = self.workload
        if not 0 <= b < wl.P:
            raise ValueError(f"block {b} outside [0, {wl.P})")
        end = wl.offsets[b + 1] if b + 1 < wl.P else wl.n
        return int(end - wl.offsets[b])

    # -- update intake ----------------------------------------------------
    def mark_dirty(self, b: int) -> None:
        """Record block ``b`` as dirty without staging data; the caller
        refreshes ``workload.blocks[b]`` before :meth:`apply`."""
        if not 0 <= int(b) < self.workload.P:
            raise ValueError(f"block {b} outside [0, {self.workload.P})")
        self.pending.add(int(b))

    def replace_block(self, b: int, data) -> None:
        """Stage new contents for block ``b`` (rows <= its capacity span,
        numpy or tensor) and mark it dirty; the sweep runs at the next
        :meth:`apply`."""
        wl = self.workload
        dim = wl.blocks[0].shape[1]
        data = torch.as_tensor(data, dtype=torch.float32)
        if data.dim() != 2 or data.shape[1] != dim:
            raise ValueError(
                f"block data must be [rows, {dim}], got {tuple(data.shape)}")
        span = self.span_of(b)
        if data.shape[0] > span:
            raise ValueError(
                f"block {b} holds at most {span} rows, got {data.shape[0]}")
        wl.blocks[b] = data.to(wl.device).contiguous()
        self.pending.add(int(b))

    # -- the delta update -------------------------------------------------
    def apply(self) -> Any:
        """Fold every pending dirty block into the standing output and
        return it: sweep only the dirty tiles (:func:`delta_sweep` in this
        index's mode), patch the ledger and run the workload's rule, or
        rebuild in full past ``max_dirty_pct``.  The result is bit-equal
        to a from-scratch recompute of the current blocks."""
        dirty = sorted(self.pending)
        self.pending.clear()
        if not dirty:
            return self.result
        self.stats.updates += 1
        P = self.workload.P
        if 100 * len(dirty) > self.max_dirty_pct * P:
            self.stats.full_rebuilds += 1
            self._rebuild_all()
            return self.result
        fresh = delta_sweep(self.workload, self.placement, dirty,
                            mode=self.mode, owner_map=self.owner_map,
                            stats=self.stats)
        getattr(self, "_patch_" + self.workload.name)(dirty, fresh)
        return self.result

    @property
    def result(self) -> Any:
        """The standing output, always equal to a from-scratch fold of the
        current blocks: the dense float64 total, the sorted (i, j) join
        hit set, or the [N, topk] k-NN index matrix."""
        if self.workload.name == "knn":
            return self._best_i
        return self._standing

    # -- full (re)build ---------------------------------------------------
    def _rebuild_all(self) -> None:
        wl = self.workload
        pairs = wl.canonical_pairs()
        self.ledger = {
            (x, y): wl.pair_partial(x, y, wl.blocks[x], wl.blocks[y])
            for (x, y) in pairs}
        self.stats.tiles_swept += len(pairs)
        self.stats.last_tiles = len(pairs)
        if wl.name == "knn":
            n, topk = wl.n, wl.topk
            self._best_s = torch.full((n, topk), float("-inf"),
                                      device=wl.device)
            self._best_i = torch.full((n, topk), SENT_I64, dtype=torch.int64,
                                      device=wl.device)
            self._knn_rebuild_rows(torch.ones(n, dtype=torch.bool,
                                              device=wl.device))
        else:
            self._standing = wl.fold(self.ledger)
            if wl.name == "dense":
                self._running_total = self._standing.clone()

    # -- per-workload patch rules ----------------------------------------
    def _patch_dense(self, dirty: List[int],
                     fresh: Dict[Tuple[int, int], Any]) -> None:
        # subtract-then-add keeps an O(|delta|) running total; the
        # published result is the canonical-order refold of the ledger,
        # bit-exact under float non-associativity (DESIGN.md 16.2)
        emit = self._emitter
        total = self._running_total
        for t in sorted(fresh):
            total = emit.delta_retract(total, self.ledger[t])
            total = emit.delta_fold(total, fresh[t])
            self.ledger[t] = fresh[t]
        self._running_total = total
        self._standing = self.workload.fold(self.ledger)

    def _patch_sparse(self, dirty: List[int],
                      fresh: Dict[Tuple[int, int], Any]) -> None:
        # a global pair (i, j) lives in exactly one tile: retract-stale /
        # insert-fresh is an exact set difference and union (DESIGN.md
        # 16.3)
        emit = self._emitter
        order = sorted(fresh)
        stale = torch.cat([self.ledger[t] for t in order])
        ins = torch.cat([fresh[t] for t in order])
        standing = emit.delta_retract(self._standing, stale)
        self._standing = emit.delta_fold(standing, ins)
        self.stats.hits_retracted += int(stale.shape[0])
        self.stats.hits_inserted += int(ins.shape[0])
        for t in order:
            self.ledger[t] = fresh[t]

    def _patch_knn(self, dirty: List[int],
                   fresh: Dict[Tuple[int, int], Any]) -> None:
        # rows in a dirty block, and rows whose standing list cites one,
        # rebuild from the per-tile ledger; every other row merges the
        # fresh dirty-tile candidates into its list (DESIGN.md 16.4)
        wl = self.workload
        emit = self._emitter
        for t in sorted(fresh):
            self.ledger[t] = fresh[t]
        starts = [int(wl.offsets[b]) for b in dirty]
        stops = [lo + self.span_of(b) for lo, b in zip(starts, dirty)]
        refresh = emit.delta_retract((self._best_s, self._best_i),
                                     (starts, stops))
        for lo, hi in zip(starts, stops):
            refresh[lo:hi] = True
        self.stats.rows_refreshed += int(refresh.sum())
        self._knn_rebuild_rows(refresh)
        dirty_set = set(dirty)
        for (x, y) in sorted(fresh):
            part = fresh[(x, y)]
            for side, b in (("x", x), ("y", y)):
                if b in dirty_set:
                    continue  # rebuilt above
                if side == "y" and x == y:
                    continue  # a self tile carries only the x plane
                ps = part["xs"] if side == "x" else part["ys"]
                pi = part["xi"] if side == "x" else part["yi"]
                off = int(wl.offsets[b])
                m = ~refresh[off:off + wl.blocks[b].shape[0]]
                rows = off + torch.nonzero(m).reshape(-1)
                if not rows.numel():
                    continue
                ms, mi = emit.delta_fold(
                    (self._best_s[rows], self._best_i[rows]), (ps[m], pi[m]))
                self._best_s[rows] = ms
                self._best_i[rows] = mi
                self.stats.rows_merged += int(rows.numel())

    def _knn_rebuild_rows(self, mask: torch.Tensor) -> None:
        # exact per-row refold from the per-tile candidate ledger: a row's
        # global top-k lies in the union of its per-tile top-k lists
        wl = self.workload
        emit = self._emitter
        topk = wl.topk
        for x in range(wl.P):
            off = int(wl.offsets[x])
            span = self.span_of(x)
            rows = off + torch.nonzero(mask[off:off + span]).reshape(-1)
            if not rows.numel():
                continue
            # capacity rows past the block's valid count pin to sentinel
            self._best_s[rows] = float("-inf")
            self._best_i[rows] = SENT_I64
            nx = wl.blocks[x].shape[0]
            rows = rows[rows < off + nx]
            if not rows.numel():
                continue
            m = rows - off
            acc = (torch.full((rows.numel(), topk), float("-inf"),
                              device=wl.device),
                   torch.full((rows.numel(), topk), SENT_I64,
                              dtype=torch.int64, device=wl.device))
            for y in range(wl.P):
                part = self.ledger[(min(x, y), max(x, y))]
                ps, pi = ((part["xs"], part["xi"]) if x <= y
                          else (part["ys"], part["yi"]))
                acc = emit.delta_fold(acc, (ps[m], pi[m]))
            self._best_s[rows] = acc[0]
            self._best_i[rows] = acc[1]


# ---------------------------------------------------------------------------
# Churn differential selfcheck
# ---------------------------------------------------------------------------

def churn_workload(wl_cls, P: int, *, seed: int = 0, spare: int = 2,
                   device=None, **kwargs):
    """A churn-capable instance of a ``core/faults.py`` workload
    (DESIGN.md section 16.1): every block keeps its rows and gains
    ``spare`` empty capacity rows (global index = block offset + row),
    so a replace or append changes one block without renumbering any
    other.  ``kwargs`` (``n_items``, ``dim``) go to the workload."""
    if spare < 0:
        raise ValueError(f"spare must be >= 0, got {spare}")
    wl = wl_cls(P, seed=seed, device=device, **kwargs)
    spans = [b.shape[0] + spare for b in wl.blocks]
    starts = np.cumsum([0] + spans)
    wl.offsets = [int(s) for s in starts[:-1]]
    wl.n = int(starts[-1])
    wl.blocks = [b.contiguous() for b in wl.blocks]
    return wl


def scratch_fold(workload) -> Any:
    """From-scratch oracle: every tile's partial from the current blocks,
    folded in canonical order (DESIGN.md section 16.6)."""
    return workload.fold({
        (x, y): workload.pair_partial(
            x, y, workload.blocks[x], workload.blocks[y])
        for (x, y) in workload.canonical_pairs()})


def random_update(wl, rng: np.random.RandomState,
                  span_of) -> Tuple[int, torch.Tensor]:
    """One random replace-or-append (the reference's draws, in its
    order): returns (block, new contents on the workload's device)."""
    P = wl.P
    dim = wl.blocks[0].shape[1]
    b = int(rng.randint(P))
    cur = wl.blocks[b]
    span = span_of(b)
    free = span - cur.shape[0]
    if free > 0 and rng.rand() < 0.4:
        # append: grow the block within its capacity span
        extra = int(rng.randint(1, free + 1))
        add = torch.from_numpy(rng.randn(extra, dim).astype(np.float32))
        return b, torch.cat([cur, add.to(cur.device)])
    # replace: fresh contents, possibly a different valid count
    rows = int(rng.randint(1, span + 1))
    return b, torch.from_numpy(
        rng.randn(rows, dim).astype(np.float32)).to(cur.device)


def _delta_placements(P: int,
                      names: Optional[Sequence[str]] = None
                      ) -> List[Placement]:
    if names is None:
        return [get_placement(name, P)
                for name, cls in sorted(registered_placements().items())
                if cls.supports(P)]
    out: List[Placement] = []
    for name in names:
        plc = resolve_placement(name, P)
        if all(p.name != plc.name for p in out):
            out.append(plc)
    return out


def churn_selfcheck(Ps: Sequence[int] = DELTA_P,
                    modes: Sequence[str] = ENGINE_MODES,
                    placements: Optional[Sequence[str]] = None,
                    n_updates: Optional[int] = None,
                    seed: Optional[int] = None,
                    verbose: bool = True, device=None) -> int:
    """The churn differential check (DESIGN.md section 16.6), on the CUDA
    device unless ``device`` says otherwise: for every registered
    placement x engine mode x P in ``Ps`` and the three workloads, apply
    ``n_updates`` random replace / append updates (default
    ``REPRO_DELTA_UPDATES``, else 3; seed ``REPRO_DELTA_SEED``, else 0)
    to a :class:`DeltaIndex`, every third one dirtying two blocks, and
    assert after each that the output is bit-equal to a from-scratch
    recompute and that at most ``|dirty| * P`` tiles were swept.
    Returns the number of cases checked."""
    from .comm import resolve_device
    from .faults import WORKLOADS  # faults imports delta: keep it lazy
    device = resolve_device(device)
    if n_updates is None:
        val = env_mod.read_knob("REPRO_DELTA_UPDATES")
        n_updates = 3 if val is None else int(val)
    if seed is None:
        val = env_mod.read_knob("REPRO_DELTA_SEED")
        seed = 0 if val is None else int(val)
    n_cases = 0
    for P in Ps:
        for plc in _delta_placements(P, placements):
            for wl_cls in WORKLOADS:
                for mode in modes:
                    wl = churn_workload(wl_cls, P, seed=seed, device=device)
                    index = DeltaIndex(wl, plc, mode=mode)
                    rng = np.random.RandomState(
                        seed + 7 * P + len(mode) + sum(map(ord, plc.name)))
                    for u in range(n_updates):
                        n_dirty = 2 if (u % 3 == 2 and P > 2) else 1
                        seen: set = set()
                        while len(seen) < n_dirty:
                            b, data = random_update(wl, rng, index.span_of)
                            index.replace_block(b, data)
                            seen.add(b)
                        out = index.apply()
                        assert index.stats.last_tiles <= len(seen) * P, (
                            plc.name, P, mode, wl.name, index.stats)
                        assert wl.equal(out, scratch_fold(wl)), (
                            plc.name, P, mode, wl.name, u)
                    n_cases += 1
                    if verbose:
                        st = index.stats
                        print(f"  churn {wl.name:6s} {plc.name:10s} "
                              f"P={P:<3d} {mode:7s}: updates={st.updates} "
                              f"tiles={st.tiles_swept - st.tiles_full}"
                              f"/{st.tiles_full} bit-exact OK")
    if verbose:
        print(f"churn selfcheck OK ({n_cases} cases, P in {tuple(Ps)})")
    return n_cases


def _main(argv: Optional[Sequence[str]] = None) -> int:
    """CLI: ``python -m repro_torch.core.delta [--P 5 8] [--modes scan]
    [--placements cyclic] [--updates 3] [--seed 0] [--quiet]
    [--device cpu]``."""
    import argparse
    ap = argparse.ArgumentParser(
        description="churn selfcheck: delta-maintained outputs must be "
                    "bit-exact vs from-scratch recomputes")
    ap.add_argument("--P", type=int, nargs="*", default=list(DELTA_P))
    ap.add_argument("--modes", nargs="*", default=list(ENGINE_MODES),
                    choices=list(ENGINE_MODES))
    ap.add_argument("--placements", nargs="*", default=None)
    ap.add_argument("--updates", type=int, default=None)
    ap.add_argument("--seed", type=int, default=None)
    ap.add_argument("--quiet", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    args = ap.parse_args(argv)
    churn_selfcheck(Ps=args.P, modes=args.modes,
                    placements=args.placements, n_updates=args.updates,
                    seed=args.seed, verbose=not args.quiet,
                    device=args.device)
    return 0


if __name__ == "__main__":  # pragma: no cover
    raise SystemExit(_main())
