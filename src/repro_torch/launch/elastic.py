"""Elastic scaling + failure handling for the quorum all-pairs runtime
(counterpart of ``repro/launch/elastic.py``, on the port's own
``core.placement``, ``core.scheduler`` and ``obs.trace``).

The schedule and residency are pure functions of (P, placement)
(core.placement; difference-set construction is O(ms), memo-cached), so
the control plane here is small:

  * ``rescale(P_old, P_new, ...)`` — derive the new schedule + the minimal
    block-movement plan (which devices must fetch which blocks to satisfy
    their new residency), used when a pod grows/shrinks — and, at equal P,
    when the *placement* changes (e.g. a live cyclic -> projective-plane
    migration): block ids keep their meaning, so each device fetches only
    its residency delta.
  * ``failover(schedule, failed)`` — wrap core.scheduler.reassign into a
    runnable plan (paper section 6 "quorum redundancy" future work).
  * ``plan_replication_repair(placement, dead)`` — after failures, copy
    each under-replicated block from a surviving holder onto live
    non-holders until the k-residency invariant is restored (DESIGN.md
    section 13) — the re-replication half of mid-sweep recovery that
    ``core.faults`` executes between rounds.

All return plain data (no device state): the launcher applies them by
moving the named blocks between devices.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Sequence, Tuple

from ..core.placement import (Placement, placement_from_env,
                              resolve_placement)
from ..core.scheduler import PairSchedule, ReassignPlan, reassign
from ..obs import trace as obs_trace


@dataclasses.dataclass(frozen=True)
class RescalePlan:
    """A quorum-axis resize / placement-migration plan (DESIGN.md
    section 8): per-device new residency and the blocks to fetch."""
    P_old: int
    P_new: int
    schedule: PairSchedule
    # device -> global block ids it must hold afterwards (its new residency)
    new_quorums: List[List[int]]
    # device -> blocks it needs but cannot derive locally (must fetch)
    fetches: Dict[int, List[int]]
    # the placements the plan moves between (equal => pure resize logic)
    placement_old: Placement | None = None
    placement_new: Placement | None = None

    @property
    def total_fetch_blocks(self) -> int:
        """Blocks moved across devices by this plan (the cost)."""
        return sum(len(v) for v in self.fetches.values())

    @property
    def is_migration(self) -> bool:
        """True when the plan changes placement at constant P (block ids
        keep their meaning; only the residency delta moves)."""
        return (self.P_old == self.P_new
                and self.placement_old != self.placement_new)


def rescale(P_old: int, P_new: int, placement_old=None,
            placement_new=None) -> RescalePlan:
    """Plan a quorum-axis resize and/or placement migration (DESIGN.md
    sections 8, 13).

    Placement specs default to the ``REPRO_PLACEMENT`` selection at each
    P (auto == cyclic when unset — the historical behavior).  Three
    regimes, by (P, placement) delta:

      * identity (same P, same placement) — a no-op: block ids keep their
        meaning and every device already holds its full residency, so the
        fetch plan is empty.
      * migration (same P, different placement) — block ids keep their
        meaning, so device i fetches exactly ``new_residency(i) -
        old_residency(i)``: a cyclic -> plane migration at a
        plane-friendly P moves only the residency delta, not the corpus.
      * resize (different P) — blocks are re-chunked to P_new equal
        parts by the data layer.  When the sizes divide evenly
        (``P_new % P_old == 0`` or ``P_old % P_new == 0``) the chunk
        boundaries nest, so a surviving device re-chunks what it already
        holds locally — on grow, old block b splits into new blocks
        ``b*m .. b*m+m-1``; on shrink, new block b is derivable iff all
        of old blocks ``b*m .. b*m+m-1`` were held — and fetches only
        the delta.  Non-divisible resizes keep the conservative
        full-residency fetch (chunk boundaries don't align).
    """
    plc_old = (placement_from_env(P_old) if placement_old is None
               else resolve_placement(placement_old, P_old))
    plc_new = (placement_from_env(P_new) if placement_new is None
               else resolve_placement(placement_new, P_new))
    sched = plc_new.schedule()
    new_res = [sorted(plc_new.residency(i)) for i in range(P_new)]
    fetches: Dict[int, List[int]] = {}
    if P_old == P_new:
        for i in range(P_new):
            delta = sorted(set(new_res[i]) - plc_old.residency(i))
            if delta:
                fetches[i] = delta
    elif P_new % P_old == 0:
        m = P_new // P_old
        for i in range(P_new):
            if i < P_old:
                derivable = {b * m + j for b in plc_old.residency(i)
                             for j in range(m)}
            else:
                derivable = set()  # a freshly-joined device holds nothing
            delta = sorted(set(new_res[i]) - derivable)
            if delta:
                fetches[i] = delta
    elif P_old % P_new == 0:
        m = P_old // P_new
        for i in range(P_new):
            old = plc_old.residency(i)
            derivable = {b for b in range(P_new)
                         if all(b * m + j in old for j in range(m))}
            delta = sorted(set(new_res[i]) - derivable)
            if delta:
                fetches[i] = delta
    else:
        fetches = {i: list(S) for i, S in enumerate(new_res)}
    plan = RescalePlan(P_old=P_old, P_new=P_new, schedule=sched,
                       new_quorums=new_res, fetches=fetches,
                       placement_old=plc_old, placement_new=plc_new)
    tr = obs_trace.get_tracer()
    if tr:
        tr.count("elastic.fetch_blocks", plan.total_fetch_blocks)
    return plan


def failover(schedule: PairSchedule, failed: Sequence[int],
             placement=None) -> ReassignPlan:
    """Work reassignment after device failure (no resize; DESIGN.md
    section 13): peers that co-hold a failed device's pairs absorb them;
    pairs whose co-residency died fetch one block from a surviving
    holder.  ``placement`` supplies the residency sets when the schedule
    derives from a non-default placement.  See scheduler.reassign."""
    return reassign(schedule, failed, placement=placement)


@dataclasses.dataclass(frozen=True)
class ReplicationRepairPlan:
    """Block copies restoring the k-residency invariant after failures
    (DESIGN.md section 13): each ``(block, src, tgt)`` action copies
    ``block`` from live holder ``src`` onto live non-holder ``tgt``."""
    P: int
    dead: Tuple[int, ...]
    # ordered copy actions; deterministic for a given (placement, dead)
    actions: Tuple[Tuple[int, int, int], ...]
    # per-block live copy count after the plan is applied
    copies_after: Tuple[int, ...]

    @property
    def n_copies(self) -> int:
        """Blocks moved across devices by this plan (the cost)."""
        return len(self.actions)

    @property
    def blocks_repaired(self) -> Tuple[int, ...]:
        """Distinct block ids the plan re-replicates, ascending."""
        return tuple(sorted({b for (b, _s, _t) in self.actions}))


def plan_replication_repair(placement: Placement, dead: Sequence[int],
                            residency: Sequence[set] | None = None
                            ) -> ReplicationRepairPlan:
    """Plan the re-replication restoring each block to its pre-failure
    copy count after ``dead`` devices fail (DESIGN.md section 13).

    For every block the failures under-replicated, copy it from the
    smallest-id surviving holder onto surviving non-holders — fewest
    repair copies received first, then smallest id, so repair load
    spreads deterministically — until the block again has
    ``min(original copy count, live devices)`` live replicas.  This is
    the invariant the chaos selfcheck asserts between rounds: after
    repair, another ``replication - 1`` failures are survivable again.
    ``residency`` overrides the placement's residency sets with the
    cluster's *current* ones (they drift after earlier repairs); the
    per-block target count always comes from the placement.  A block
    whose holders all died cannot be repaired from residency and raises
    ``RuntimeError`` (restore it from a checkpoint first — the path
    ``core.faults`` drives).
    """
    t0 = time.perf_counter()
    P = placement.P
    dead_set = set(int(d) for d in dead)
    live = [i for i in range(P) if i not in dead_set]
    if not live:
        raise ValueError("all devices dead: nothing to repair onto")
    if residency is None:
        sets = [set(S) for S in placement.residency_sets]
    else:
        sets = [set(S) for S in residency]
    orig_count = [0] * P
    for S in placement.residency_sets:
        for b in S:
            orig_count[b] += 1
    live_holders = {b: sorted(i for i in live if b in sets[i])
                    for b in range(P)}
    lost = [b for b in range(P) if not live_holders[b]]
    if lost:
        raise RuntimeError(
            f"block {lost[0]} lost: all {orig_count[lost[0]]} holders "
            f"failed; restore from checkpoint before repairing")
    actions: List[Tuple[int, int, int]] = []
    received = [0] * P
    for b in range(P):
        target = min(orig_count[b], len(live))
        holders = list(live_holders[b])
        src = holders[0]
        while len(holders) < target:
            cands = [i for i in live if i not in holders]
            tgt = min(cands, key=lambda i: (received[i], i))
            actions.append((b, src, tgt))
            holders.append(tgt)
            received[tgt] += 1
    copies_after = [0] * P
    for b in range(P):
        copies_after[b] = len(live_holders[b]) + sum(
            1 for (bb, _s, _t) in actions if bb == b)
    plan = ReplicationRepairPlan(
        P=P, dead=tuple(sorted(dead_set)), actions=tuple(actions),
        copies_after=tuple(copies_after))
    tr = obs_trace.get_tracer()
    if tr:
        tr.count("elastic.rereplicated_blocks", plan.n_copies)
        tr.record("elastic.plan_repair", time.perf_counter() - t0,
                  P=P, dead=len(dead_set), copies=plan.n_copies)
    return plan
