"""Quorum-cover routing for online query serving.

A copy of ``repro/serving/cover.py`` (numpy only) for the PyTorch port,
which imports nothing of the JAX package; the port's tests hold every
plan equal to the reference's for P <= 64.

The batch engine replicates every block into k = O(sqrt(P)) cyclic quorums
so that every *pair* of blocks is co-resident somewhere.  A query-vs-all
computation needs much less: a set of devices whose quorums jointly cover
all P blocks.  Because each block b lives in exactly k quorums (paper
Eq. 13 — devices {b - a mod P : a in A}), a cover of ~ceil(P/k) devices
exists in the best case, and the serving tier only has to fan a query out
to those devices instead of all P (DESIGN.md section 9).

Cover construction, cheapest-first:

  * **closed form from the cyclic structure** — the difference-cover
    property ``A - A = Z_P`` says the translates at ``C = -A mod P``
    always cover (``S_{-a_j} ∋ a_i - a_j``): a guaranteed size-k cover
    with zero search.  When A contains a run {0..m-1} (the ladder sets
    do), the *step cover* at devices {0, m, 2m, ...} does better:
    ~ceil(P/m) + 1 devices.
  * **greedy set-cover** over the P translates (O(P^2 k)).
  * **exact branch-and-bound** for P <= _EXACT_COVER_MAX_P, branching on
    the k holders of a least-covered block (depth <= |cover|, factor k).

``build_cover`` takes the smallest verified result.  NOTE a deviation from
the obvious ``ceil(P/k) + 1`` target: that bound is *not achievable in
general* — e.g. for P = 22 (k = 6) exhaustive search shows no 5-translate
cover of the optimal difference set exists; the exact minimum over all
P <= 64 stays within ``ceil(P/k) + 3`` (tests/test_cover.py pins this).

The **dedup mask** assigns every block to exactly one (cover device, slot)
so replicated blocks score each query exactly once; `mask_table` turns the
assignment into a [P, k] sharded operand (zero rows for devices outside
the cover), mirroring ``core.allpairs.pair_mask_table``.

Covers are built over any registered *placement* (core.placement,
DESIGN.md section 10): ``build_cover(P, placement)`` unions that
placement's residency sets — plane placements give plane covers, full
replication collapses to one device — and :func:`exact_cover_sets` runs
the branch-and-bound over arbitrary residency sets (the cyclic
:func:`exact_cover` wrapper keeps bit-identical historical results).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..core.placement import get_placement, resolve_placement

__all__ = [
    "CoverPlan",
    "build_cover",
    "build_degraded_cover",
    "closed_form_cover",
    "step_cover",
    "greedy_cover",
    "exact_cover",
    "exact_cover_sets",
    "is_cover",
]

# exact search is k^|cover| worst case; beyond this P the heuristics (which
# the exact search only ever improves by ~1 device) stand alone
_EXACT_COVER_MAX_P = 64


def _quorum(P: int, A: Sequence[int], i: int) -> frozenset:
    return frozenset((a + i) % P for a in A)


def is_cover(P: int, A: Sequence[int], devices: Sequence[int]) -> bool:
    """True iff the quorums of ``devices`` jointly cover all P blocks
    (the cover-validity predicate of DESIGN.md section 9.1)."""
    got: set = set()
    for i in devices:
        got |= _quorum(P, A, i)
    return len(got) == P


def closed_form_cover(P: int, A: Sequence[int]) -> List[int]:
    """The always-valid size-k cover ``C = -A mod P`` (the cyclic closed
    form of DESIGN.md section 9.1).

    For every residue r, the difference-cover property gives a_i - a_j = r
    (mod P), so quorum S_{-a_j} = A - a_j contains r.  No search, O(k).
    """
    return sorted({(-a) % P for a in A})


def step_cover(P: int, A: Sequence[int]) -> List[int] | None:
    """Cover by translates at multiples of m, when A hits every residue
    mod m — e.g. the ladder sets contain the run {0..r-1} (DESIGN.md
    section 9.1).

    For block b >= a with a = min{x in A : x ≡ b (mod m)}, b - a is a
    multiple of m below P, so b is in the quorum of a chosen translate;
    the wraparound cases (b < a) are patched greedily — that is the "+1"
    (occasionally +2) over ceil(P/m).  Returns None when only m = 1
    qualifies (every translate set trivially hits residues mod 1).
    """
    m = 0
    for cand in range(min(P, len(A)), 1, -1):
        if {a % cand for a in A} == set(range(cand)):
            m = cand
            break
    if m == 0:
        return None
    devices = [(j * m) % P for j in range(math.ceil(P / m))]
    covered: set = set()
    for i in devices:
        covered |= _quorum(P, A, i)
    missing = set(range(P)) - covered
    while missing:  # wraparound patch
        best = max(range(P), key=lambda i: len(missing & _quorum(P, A, i)))
        devices.append(best)
        missing -= _quorum(P, A, best)
    return sorted(set(devices))


def greedy_cover(P: int, A: Sequence[int]) -> List[int]:
    """Classic greedy set-cover over the P cyclic translates (DESIGN.md
    section 9.1)."""
    quorums = [_quorum(P, A, i) for i in range(P)]
    uncovered = set(range(P))
    cover: List[int] = []
    while uncovered:
        best = max(range(P), key=lambda i: (len(uncovered & quorums[i]), -i))
        cover.append(best)
        uncovered -= quorums[best]
    return sorted(cover)


def exact_cover_sets(residency: Sequence[Sequence[int]], ub: int, *,
                     holders: Optional[Dict[int, List[int]]] = None,
                     pin_first: Optional[int] = None) -> List[int] | None:
    """Minimal device cover of *arbitrary* residency sets by
    branch-and-bound, or None if nothing beats ``ub`` (DESIGN.md
    sections 9.1 and 10 "Threading").

    ``residency[i]`` is the block set device i holds (any placement, not
    just cyclic translates).  Branches on the holders of the smallest
    uncovered block; prunes on ``|cover| + ceil(|uncovered| / kmax) >=
    ub`` with kmax the largest residency.  ``pin_first`` roots the search
    at one device — only sound under a symmetry argument (for cyclic
    translates, some optimal cover contains device 0), so the default
    leaves the root open.  ``holders`` optionally fixes the per-block
    branch order (the cyclic wrapper uses the historical shift order so
    results stay bit-identical with the pre-generalization search).
    """
    sets = [frozenset(S) for S in residency]
    blocks = frozenset().union(*sets) if sets else frozenset()
    kmax = max((len(S) for S in sets), default=0)
    if holders is None:
        holders = {b: [i for i, S in enumerate(sets) if b in S]
                   for b in blocks}
    best: List[int] | None = None
    bound = ub

    def bb(cover: List[int], uncovered: frozenset) -> None:
        nonlocal best, bound
        if not uncovered:
            if len(cover) < bound:
                bound = len(cover)
                best = list(cover)
            return
        if len(cover) + math.ceil(len(uncovered) / kmax) >= bound:
            return
        b = min(uncovered)
        for i in holders[b]:
            if i in cover:  # pragma: no cover - holders of uncovered b aren't in cover
                continue
            cover.append(i)
            bb(cover, uncovered - sets[i])
            cover.pop()

    if pin_first is None:
        bb([], blocks)
    else:
        bb([pin_first], blocks - sets[pin_first])
    return sorted(best) if best is not None else None


def exact_cover(P: int, A: Sequence[int], ub: int) -> List[int] | None:
    """Minimal cover of the P cyclic translates of A, or None if nothing
    beats ``ub`` (DESIGN.md section 9.1).
    Thin wrapper over :func:`exact_cover_sets` pinning
    device 0 (sound by translational symmetry) and branching holders in
    the historical shift order, so cyclic results are unchanged."""
    sets = [_quorum(P, A, i) for i in range(P)]
    holders = {b: [(b - a) % P for a in sorted(A)] for b in range(P)}
    return exact_cover_sets(sets, ub, holders=holders, pin_first=0)


@dataclasses.dataclass(frozen=True)
class CoverPlan:
    """Query routing plan: which devices to visit, and who scores what.

    Attributes
    ----------
    P : quorum axis size.
    A : the placement's shift structure (sorted difference cover) the
        residency derives from — ``difference_set(P)`` for the default
        cyclic placement.
    placement : name of the placement the plan was built over.
    devices : sorted cover device ids; their quorums union to all P blocks.
    block_owner : np [P] int32 — the cover device assigned to score each
        block (the first cover device holding it): the dedup rule.
    slot_mask : np [P, k] float32 — per-device, per-slot scoring mask.
        Row i is all-zero for devices outside the cover; inside it,
        slot s is 1 iff block (i + A[s]) % P is assigned to device i.
        Summed over all devices every block scores exactly once.
    """

    P: int
    A: Tuple[int, ...]
    devices: Tuple[int, ...]
    block_owner: np.ndarray
    slot_mask: np.ndarray
    placement: str = "cyclic"

    @property
    def k(self) -> int:
        """Quorum size (slots per device) the slot mask is defined over."""
        return len(self.A)

    @property
    def n_cover(self) -> int:
        """Devices a query fans out to (~ceil(P/k) in the best case)."""
        return len(self.devices)

    def mask_table(self) -> np.ndarray:
        """[P, k] float32 mask rows, one per simulated device."""
        return np.asarray(self.slot_mask, np.float32)


_COVER_CACHE: dict = {}


def build_cover(P: int, placement=None) -> CoverPlan:
    """Build (and memo-cache) the smallest verified cover plan for P
    (DESIGN.md section 9.1).

    Pure function of (P, placement) — like the schedules — so elastic
    resize just recomputes it.  ``placement`` is a
    ``core.placement.Placement`` instance or spec name; None keeps the
    bit-exact default (the cyclic placement, whose shifts are
    ``difference_set(P)``).  Any shift-structured placement works: the
    residency sets the cover unions are the P translates of its shifts
    (for full replication the plan collapses to a single device).
    """
    if P < 1:
        raise ValueError(f"P must be >= 1, got {P}")
    plc = (get_placement("cyclic", P) if placement is None
           else resolve_placement(placement, P))
    key = (P, plc.name)
    if key in _COVER_CACHE:
        return _COVER_CACHE[key]
    if plc.shifts is None:
        raise NotImplementedError(
            f"placement {plc.name!r} has no shift structure; CoverPlan's "
            "slot mask is defined over shift slots")
    A = list(plc.shifts)
    k = len(A)

    candidates = [closed_form_cover(P, A), greedy_cover(P, A)]
    stepped = step_cover(P, A)
    if stepped is not None:
        candidates.append(stepped)
    best = min(candidates, key=len)
    if P <= _EXACT_COVER_MAX_P:
        exact = exact_cover(P, A, ub=len(best))
        if exact is not None:
            best = exact
    for c in candidates + [best]:
        assert is_cover(P, A, c), (P, A, c)

    devices = tuple(sorted(best))
    shifts = sorted(A)
    block_owner = np.full((P,), -1, np.int32)
    for i in devices:  # first cover device holding the block scores it
        for a in shifts:
            b = (a + i) % P
            if block_owner[b] < 0:
                block_owner[b] = i
    assert (block_owner >= 0).all(), (P, devices)

    slot_mask = np.zeros((P, k), np.float32)
    for i in devices:
        for s, a in enumerate(shifts):
            if block_owner[(a + i) % P] == i:
                slot_mask[i, s] = 1.0

    plan = CoverPlan(P=P, A=tuple(shifts), devices=devices,
                     block_owner=block_owner, slot_mask=slot_mask,
                     placement=plc.name)
    _COVER_CACHE[key] = plan
    return plan


def build_degraded_cover(P: int, placement=None,
                         dead: Sequence[int] = ()) -> CoverPlan:
    """A cover plan that visits no dead device (DESIGN.md section 13) —
    serving's half of failure handling: queries keep full-corpus answers
    while recovery runs, as long as every block still has a live holder.

    Same plan shape as :func:`build_cover` (and bit-identical to it when
    ``dead`` is empty): greedy set-cover restricted to live translates,
    improved by the exact search when P is small, then the same
    first-holder dedup rule over live cover devices.  Raises
    ``RuntimeError`` when some block's holders all died (the corpus is
    no longer coverable — restore from checkpoint / re-replicate first).
    Memoized on (P, placement, dead).
    """
    if P < 1:
        raise ValueError(f"P must be >= 1, got {P}")
    plc = (get_placement("cyclic", P) if placement is None
           else resolve_placement(placement, P))
    dead_set = frozenset(int(d) for d in dead)
    if not dead_set:
        return build_cover(P, plc)
    key = (P, plc.name, tuple(sorted(dead_set)))
    if key in _COVER_CACHE:
        return _COVER_CACHE[key]
    if plc.shifts is None:
        raise NotImplementedError(
            f"placement {plc.name!r} has no shift structure; CoverPlan's "
            "slot mask is defined over shift slots")
    A = list(plc.shifts)
    k = len(A)
    live = [i for i in range(P) if i not in dead_set]
    quorums = {i: _quorum(P, A, i) for i in live}
    reachable: set = set()
    for q in quorums.values():
        reachable |= q
    if reachable != set(range(P)):
        b = min(set(range(P)) - reachable)
        raise RuntimeError(
            f"block {b} lost: all holders are dead; no degraded cover "
            f"exists — restore from checkpoint / re-replicate first")
    # greedy over live translates only, then exact search when feasible
    uncovered = set(range(P))
    cover: List[int] = []
    while uncovered:
        best = max(live, key=lambda i: (len(uncovered & quorums[i]), -i))
        cover.append(best)
        uncovered -= quorums[best]
    best_cover = sorted(cover)
    if P <= _EXACT_COVER_MAX_P:
        residency = [quorums[i] if i in quorums else frozenset()
                     for i in range(P)]
        exact = exact_cover_sets(residency, ub=len(best_cover))
        if exact is not None:
            best_cover = exact
    assert is_cover(P, A, best_cover) and not (set(best_cover) & dead_set)

    devices = tuple(sorted(best_cover))
    shifts = sorted(A)
    block_owner = np.full((P,), -1, np.int32)
    for i in devices:
        for a in shifts:
            b = (a + i) % P
            if block_owner[b] < 0:
                block_owner[b] = i
    slot_mask = np.zeros((P, k), np.float32)
    for i in devices:
        for s, a in enumerate(shifts):
            if block_owner[(a + i) % P] == i:
                slot_mask[i, s] = 1.0
    plan = CoverPlan(P=P, A=tuple(shifts), devices=devices,
                     block_owner=block_owner, slot_mask=slot_mask,
                     placement=plc.name)
    _COVER_CACHE[key] = plan
    return plan
