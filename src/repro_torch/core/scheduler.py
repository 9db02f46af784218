"""Static all-pairs work schedules over cyclic quorums.

The paper distributes the P*(P+1)/2 block pairings across P processes and
relies on quorum symmetry for "equal work" (paper Eq. 12-13).  We make that
static and exact with the *per-difference ownership rule* (DESIGN.md 3.2):

For every cyclic difference ``d`` pick one canonical pair
``(a_hi, a_lo) in A x A`` with ``a_hi - a_lo = d (mod P)`` (it exists by the
difference-cover property).  Block pair ``(j, j+d)`` is then owned by device
``i = (j - a_lo) mod P`` — device i holds both blocks since
``j = i + a_lo in S_i`` and ``j + d = i + a_hi in S_i``.

Consequences (all verified in tests):
  * each device owns exactly one ordered pair per difference d, i.e.
    perfect static balance across devices: same pair count, same local
    quorum slot indices, zero control-flow divergence — pure SPMD,
  * unordered coverage: scheduling d in {0..floor(P/2)} covers every
    unordered pair exactly once (d and P-d name the same unordered pair),
  * all schedules are pure functions of P — elastic resize just recomputes.

A copy of ``repro/core/scheduler.py`` for the PyTorch port, which must import
nothing of the JAX package; keep the two in step (the port's tests
hold them equal).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .quorum import cyclic_quorums, difference_set

__all__ = [
    "PairSchedule",
    "build_schedule",
    "build_causal_schedule",
    "reassign",
    "ReassignPlan",
    "FETCH_LOAD_WEIGHT",
]

# load-model weight of a tier-2 recovery pair: the reassigned compute plus
# the one extra block transfer it costs (DESIGN.md section 13) — exposed so
# ReassignPlan.weighted_load and the greedy assignment agree by construction
FETCH_LOAD_WEIGHT = 1.5


@dataclasses.dataclass(frozen=True)
class PairSchedule:
    """A static all-pairs schedule for P devices.

    Attributes
    ----------
    P : number of block/devices on the quorum axis.
    A : the relaxed (P,k)-difference set (sorted).
    k : quorum size len(A).
    shifts : np.ndarray [k] — cyclic shifts a device pulls its quorum blocks
        from; local slot s of device i holds global block (i + shifts[s]) % P.
    pair_slots : np.ndarray [n_pairs, 2] int32 — *local slot* index pairs
        (lo_slot, hi_slot) each device computes.  Identical on every device
        (SPMD); device i's s-th pair is global blocks
        ((i + shifts[lo_slot]) % P, (i + shifts[hi_slot]) % P).
    pair_diff : np.ndarray [n_pairs] — the cyclic difference each pair covers.
    self_pair_index : position in pair_slots of the (0,0) self-pair.
    """

    P: int
    A: Tuple[int, ...]
    shifts: np.ndarray
    pair_slots: np.ndarray
    pair_diff: np.ndarray

    @property
    def k(self) -> int:
        """Quorum size (blocks resident per device)."""
        return len(self.A)

    @property
    def n_pairs(self) -> int:
        """Scheduled slot pairs per device (one per difference)."""
        return int(self.pair_slots.shape[0])

    def owner_of(self, x: int, y: int) -> int:
        """Global owner device of unordered block pair (x, y).

        The schedule entry for difference dd = min(d, P-d) is the canonical
        (a_lo, a_hi) with a_hi - a_lo = dd (mod P); the owner is the device i
        whose quorum places the pair's lower endpoint (in the canonical
        direction) at slot a_lo, i.e. i = j - a_lo (mod P) with j the
        endpoint satisfying (other - j) % P == dd.  For the doubly-owned
        d = P/2 orbit (even P) both endpoints qualify; this returns one of
        the two owners (the engine mask dedups the actual compute).
        """
        d = (y - x) % self.P
        dd = min(d, (self.P - d) % self.P)
        # find the schedule entry covering difference dd
        idx = int(np.nonzero(self.pair_diff == dd)[0][0])
        lo_slot = int(self.pair_slots[idx, 0])
        a_lo = int(self.shifts[lo_slot])
        j = x if d == dd else y  # lower endpoint of the canonical direction
        return (j - a_lo) % self.P

    def global_pairs_of(self, i: int) -> List[Tuple[int, int]]:
        """The global block pairs device i computes (for tests/debug)."""
        out = []
        for s in range(self.n_pairs):
            lo = (i + int(self.shifts[self.pair_slots[s, 0]])) % self.P
            hi = (i + int(self.shifts[self.pair_slots[s, 1]])) % self.P
            out.append((lo, hi))
        return out


def _canonical_pairs(P: int, A: Sequence[int]) -> Dict[int, Tuple[int, int]]:
    """difference d -> canonical (a_lo, a_hi) with a_hi - a_lo = d (mod P).

    Chosen deterministically; preferring pairs that reuse low slot indices
    keeps the gathered working set warm.
    """
    A = sorted(A)
    table: Dict[int, Tuple[int, int]] = {}
    for a_lo in A:
        for a_hi in A:
            d = (a_hi - a_lo) % P
            if d not in table:
                table[d] = (a_lo, a_hi)
    missing = [d for d in range(P) if d not in table]
    if missing:  # pragma: no cover - A is verified upstream
        raise AssertionError(f"A not a difference cover, missing {missing}")
    return table


def _placement_cover(P: int, placement) -> List[int]:
    """The difference cover a schedule derives from: ``difference_set(P)``
    for the default (bit-exact cyclic behavior), or the placement's shift
    structure.  Duck-typed on ``.shifts`` / ``.P`` so this module needs no
    import of core.placement (which imports us)."""
    if placement is None:
        return difference_set(P)
    if getattr(placement, "P", P) != P:
        raise ValueError(f"placement {placement!r} does not match P={P}")
    shifts = placement.shifts
    if shifts is None:
        raise ValueError(
            f"placement {getattr(placement, 'name', placement)!r} has no "
            "cyclic shift structure; the shift-based scheduler cannot use it")
    return [int(a) % P for a in shifts]


def build_schedule(P: int, placement=None) -> PairSchedule:
    """Full (symmetric) all-pairs schedule: one entry per d in 0..floor(P/2).

    Every unordered pair {x, y} (including self-pairs x==y via d=0) is computed
    by exactly one device, except d = P/2 for even P which is owned twice (the
    cyclic rule cannot halve an odd orbit); the engine halves that pair's work
    by masking (see core.allpairs), keeping exact single-coverage semantics.

    ``placement`` (a core.placement.Placement) substitutes its shift
    structure for the default ``difference_set(P)`` — the schedule machinery
    is placement-agnostic as long as residency is cyclic.
    """
    A = _placement_cover(P, placement)
    table = _canonical_pairs(P, A)
    slot_of = {a: s for s, a in enumerate(sorted(A))}

    pair_slots: List[Tuple[int, int]] = []
    pair_diff: List[int] = []
    for d in range(P // 2 + 1):
        a_lo, a_hi = table[d]
        pair_slots.append((slot_of[a_lo], slot_of[a_hi]))
        pair_diff.append(d)

    return PairSchedule(
        P=P,
        A=tuple(sorted(A)),
        shifts=np.asarray(sorted(A), dtype=np.int32),
        pair_slots=np.asarray(pair_slots, dtype=np.int32),
        pair_diff=np.asarray(pair_diff, dtype=np.int32),
    )


@dataclasses.dataclass(frozen=True)
class CausalSchedule:
    """Causal (triangular) all-pairs schedule for block attention.

    Unlike the cyclic case, causality breaks shift invariance: pair (q, kv)
    exists only for kv <= q, so per-device pair lists differ in *validity* but
    not in length — we keep the SPMD one-pair-per-difference structure and mask
    invalid pairs (valid[i, s] below), preserving uniform control flow.
    """

    P: int
    A: Tuple[int, ...]
    shifts: np.ndarray          # [k]
    pair_slots: np.ndarray      # [n_pairs, 2] (kv_slot, q_slot) local slots
    pair_diff: np.ndarray       # [n_pairs] difference d = q - kv >= 0
    valid: np.ndarray           # [P, n_pairs] bool — device i computes pair s?

    @property
    def k(self) -> int:
        """Quorum size (blocks resident per device)."""
        return len(self.A)

    @property
    def n_pairs(self) -> int:
        """Candidate slot pairs per device (validity-masked)."""
        return int(self.pair_slots.shape[0])


def build_causal_schedule(P: int, placement=None) -> CausalSchedule:
    """Schedule every causal block pair (q, kv), kv <= q, exactly once.

    Differences d = q - kv range over 0..P-1 (no modular wraparound in
    validity).  Device i's candidate pair for difference d is
    q = (i + a_hi) % P, kv = (i + a_lo) % P with the canonical (a_lo, a_hi);
    it is valid iff q - kv == d exactly (no wrap) — i.e. kv + d < P.
    Each difference d has exactly P - d valid (q, kv) pairs and the cyclic
    rule assigns each to a distinct device, so coverage is exact.
    Load per device = sum over d of [valid] ~ (P+1)/2 on average; worst-case
    imbalance is bounded by the quorum structure and reported by tests.
    ``placement`` substitutes its shift structure, as in build_schedule.
    """
    A = _placement_cover(P, placement)
    table = _canonical_pairs(P, A)
    slot_of = {a: s for s, a in enumerate(sorted(A))}
    shifts = np.asarray(sorted(A), dtype=np.int32)

    pair_slots: List[Tuple[int, int]] = []
    pair_diff: List[int] = []
    valid = np.zeros((P, P), dtype=bool)
    for d in range(P):
        a_lo, a_hi = table[d]
        pair_slots.append((slot_of[a_lo], slot_of[a_hi]))
        pair_diff.append(d)
        for i in range(P):
            kv = (i + a_lo) % P
            q = (i + a_hi) % P
            valid[i, d] = (q - kv) == d  # no wraparound => causal pair exists
    return CausalSchedule(
        P=P,
        A=tuple(sorted(A)),
        shifts=shifts,
        pair_slots=np.asarray(pair_slots, dtype=np.int32),
        pair_diff=np.asarray(pair_diff, dtype=np.int32),
        valid=valid,
    )


# ---------------------------------------------------------------------------
# Fault tolerance: straggler / failure reassignment (paper section 6 future work)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ReassignPlan:
    """Recovery plan after device failures.

    extra_pairs[i]   — pairs device i recomputes that are already co-resident
                       in its quorum (zero extra communication).
    fetch_pairs[i]   — (pair, missing_block, source_device) entries where
                       device i holds one block and pulls the other from a
                       live holder (one extra block transfer each).

    Two cost views (DESIGN.md section 13): :attr:`n_recovered` counts
    *pairs* (every tier-1 and tier-2 entry is one recovered pair —
    coverage accounting), :attr:`weighted_load` totals the greedy *load
    model* (tier-2 entries cost ``FETCH_LOAD_WEIGHT`` because they also
    move a block).  The two used to be conflated; they answer different
    questions and are both exposed.
    """

    extra_pairs: Dict[int, List[Tuple[int, int]]]
    fetch_pairs: Dict[int, List[Tuple[Tuple[int, int], int, int]]]

    @property
    def n_recovered(self) -> int:
        """Pairs this plan reassigns across both tiers (each counted
        once — the coverage view)."""
        return (sum(len(v) for v in self.extra_pairs.values())
                + sum(len(v) for v in self.fetch_pairs.values()))

    @property
    def weighted_load(self) -> float:
        """Total extra load under the greedy cost model: 1.0 per tier-1
        pair, ``FETCH_LOAD_WEIGHT`` per tier-2 pair (compute + one block
        transfer) — the quantity the min-load assignment balances."""
        return (sum(len(v) for v in self.extra_pairs.values())
                + FETCH_LOAD_WEIGHT
                * sum(len(v) for v in self.fetch_pairs.values()))

    @property
    def fetched_blocks(self) -> List[Tuple[int, int, int]]:
        """The (block, source, target) transfers tier 2 executes, in
        deterministic plan order."""
        return [(missing, src, tgt)
                for tgt in sorted(self.fetch_pairs)
                for (_pair, missing, src) in self.fetch_pairs[tgt]]


def _capacity(weights: Optional[Sequence[float]], P: int) -> List[float]:
    """Validated per-device capacity weights (default: uniform 1.0)."""
    if weights is None:
        return [1.0] * P
    w = [float(v) for v in weights]
    if len(w) != P:
        raise ValueError(f"weights must have length P={P}, got {len(w)}")
    if any(v <= 0 for v in w):
        raise ValueError(f"weights must be positive, got {w}")
    return w


def reassign(schedule: PairSchedule, failed: Sequence[int],
             placement=None, *, weights: Optional[Sequence[float]] = None,
             pairs: Optional[Dict[int, List[Tuple[int, int]]]] = None
             ) -> ReassignPlan:
    """Reassign failed devices' pair lists to quorum peers.

    Two tiers (DESIGN.md sections 8 and 13):
      1. the pair is co-resident in a live quorum -> free reassignment.  The
         all-pairs property guarantees >= 1 co-resident quorum; it may be
         exactly the failed one, hence tier 2.
      2. otherwise a live device holding one block fetches the other from any
         live holder (each block lives in exactly k quorums, paper Eq. 13, so
         a block is lost only if all k of its holders fail simultaneously —
         then restart-from-checkpoint is the only correct response).

    Greedy min-load assignment in both tiers, fully deterministic: ties
    on load break by smallest device id (candidate lists are sorted), so
    a given (schedule, failed, placement, weights) always produces the
    same plan — the mid-sweep recovery of core/faults.py depends on plan
    stability.  ``weights`` are per-device capacity weights (Rocket's
    heterogeneity model): the greedy minimizes load *normalized by
    capacity*, so a 2x-capacity device absorbs ~2x the recovered pairs;
    None means uniform.

    ``placement`` supplies the residency sets (any core.placement.Placement,
    not just cyclic — reassignment itself only needs *sets*); the schedule
    must derive from the same placement or coverage claims break.
    ``pairs`` optionally overrides the per-failed-device pair lists
    (default: ``schedule.global_pairs_of``) — the fault-tolerant driver
    passes the *remaining* mid-sweep tiles, and a weighted-ownership
    assignment passes its own partition.
    """
    failed_set = set(failed)
    P = schedule.P
    if placement is None:
        quorums: Sequence[Sequence[int]] = cyclic_quorums(P)
    else:
        if getattr(placement, "P", P) != P:
            raise ValueError(f"placement {placement!r} does not match P={P}")
        quorums = [sorted(S) for S in placement.residency_sets]
    cap = _capacity(weights, P)
    pair_holders: Dict[Tuple[int, int], List[int]] = {}
    block_holders: Dict[int, List[int]] = {}
    for i, S in enumerate(quorums):
        if i in failed_set:
            continue
        sset = set(S)
        for x in sset:
            block_holders.setdefault(x, []).append(i)
            for y in sset:
                if x <= y:
                    pair_holders.setdefault((x, y), []).append(i)

    load = {i: float(schedule.n_pairs) for i in range(P) if i not in failed_set}

    def eff(c: int) -> float:
        return load[c] / cap[c]

    extra: Dict[int, List[Tuple[int, int]]] = {i: [] for i in load}
    fetch: Dict[int, List[Tuple[Tuple[int, int], int, int]]] = {i: [] for i in load}
    for f in sorted(failed_set):
        todo = (pairs.get(f, []) if pairs is not None
                else schedule.global_pairs_of(f))
        for (x, y) in todo:
            key = (min(x, y), max(x, y))
            cands = pair_holders.get(key, [])
            if cands:
                tgt = min(sorted(cands), key=lambda c: (eff(c), c))
                load[tgt] += 1.0
                extra[tgt].append(key)
                continue
            hx = block_holders.get(key[0], [])
            hy = block_holders.get(key[1], [])
            if not hx or not hy:
                lost = key[0] if not hx else key[1]
                raise RuntimeError(
                    f"block {lost} lost: all {schedule.k} holding quorums "
                    "failed; restore from checkpoint")
            # device holding one block pulls the other; a tier-2 pair costs
            # FETCH_LOAD_WEIGHT in the load model (compute + one transfer).
            # hx and hy are disjoint (a holder of both would be tier 1), so
            # the (eff, c) key is a strict total order over the candidates.
            cands2 = sorted([(c, key[1]) for c in hx]
                            + [(c, key[0]) for c in hy])
            tgt, missing = min(cands2, key=lambda t: (eff(t[0]), t[0]))
            src = min(sorted(block_holders[missing]),
                      key=lambda c: (eff(c), c))
            load[tgt] += FETCH_LOAD_WEIGHT
            fetch[tgt].append((key, missing, src))
    return ReassignPlan(
        extra_pairs={i: v for i, v in extra.items() if v},
        fetch_pairs={i: v for i, v in fetch.items() if v},
    )
