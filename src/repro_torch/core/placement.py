"""Pluggable block-placement layer: blocks -> device residency + routing.

The paper's cyclic quorums are one point in a design space of all-pairs
data placements.  Hall, Kelly & Tian ("Optimal Data Distribution for
Big-Data All-to-All Comparison using Finite Projective and Affine
Planes", 2023) show plane-based distributions hit the sqrt(P) replication
optimum exactly where generic cyclic difference covers can pay up to
~2*sqrt(P).  This module makes the placement a first-class, swappable
object so the scheduler, engine, serving cover, and elastic rescale all
work over *any* registered placement (DESIGN.md section 10).

A :class:`Placement` maps P block ids onto P devices and answers three
questions:

  * **residency** — ``residency(i)`` is the set of blocks device i keeps
    resident; every unordered block pair (including self-pairs) must be
    co-resident on at least one device (the all-pairs property, paper
    Theorem 1).
  * **ownership** — ``owner_of(x, y)`` names the one canonical device
    that computes pair {x, y}: a partition of all C(P,2) + P unordered
    pairs with per-device load balanced to within one pair.
  * **route structure** — ``shifts`` is the cyclic difference cover
    realizing residency with ``lax.ppermute`` shifts (slot s of device i
    holds block ``(i + shifts[s]) % P``, exactly the layout
    ``core.allpairs.quorum_gather`` produces).  All placements
    registered here are shift-structured; a future non-cyclic placement
    returns ``shifts = None`` and supplies its own data plane.

Registered implementations (``tests/test_placement_conformance.py`` is
the executable interface contract — every registered placement must pass
it for every P where it is defined):

  * ``cyclic``     — :class:`CyclicQuorumPlacement`, the paper's relaxed
    (P,k)-difference sets (``quorum.difference_set``), defined for every
    P >= 1.  Bit-exact with the pre-placement behavior.
  * ``projective`` — :class:`ProjectivePlanePlacement` for
    P = q^2 + q + 1: the lines of PG(2, q) realized cyclically through a
    Singer difference set; replication is *exactly* q + 1, the
    theoretical optimum (k(k-1) + 1 = P with every difference covered
    exactly once — a perfect difference set, verified at construction).
  * ``affine``     — :class:`AffinePlanePlacement` for P = q^2 + q
    (prime-power q): the affine-parameter analog, replication exactly
    q + 1.  See the feasibility note below.
  * ``full``       — :class:`FullReplicationPlacement`: every block on
    every device (``shifts = 0..P-1``), the "all data everywhere" scheme
    the paper improves on, kept as the degenerate oracle; the engine
    routes it to ``allgather_allpairs``.

Affine feasibility note: with P co-equal blocks and devices, replication
q + 1 at P = q^2 + q requires an *almost perfect* cyclic difference
cover — q(q+1) ordered differences for q^2 + q - 1 nonzero residues,
i.e. a single collision.  These exist for q = 2 ({0,1,3} mod 6) and
q = 3 ({0,1,3,7} mod 12) but provably not for q = 4 or q = 5 (the
exact branch-and-bound search is exhaustive there; cf. the covering
number C(20,5,2) = 21 > 20), so ``supports`` reports exactly the
constructible P and ``auto`` falls back to cyclic elsewhere.

Selection: :func:`auto_placement` picks the smallest-replication
placement defined at P (ties prefer ``cyclic``, keeping default behavior
bit-exact), and the ``REPRO_PLACEMENT`` env var overrides it everywhere
a placement is chosen implicitly — mirroring ``REPRO_ALLPAIRS_MODE``.
``REPRO_PLACEMENT=plane`` prefers projective, then affine, then falls
back to cyclic (so a CI matrix can sweep P values where no plane
exists); any other name must be defined at P or selection raises.

A copy of ``repro/core/placement.py`` for the PyTorch port, which must import
nothing of the JAX package; keep the two in step (the port's tests
hold them equal).
"""

from __future__ import annotations

import abc
import functools
import math
from typing import Dict, List, Optional, Sequence, Tuple, Type

import numpy as np

from .quorum import (_prime_power_base, difference_set, is_difference_cover,
                     singer_difference_set)
from .scheduler import (CausalSchedule, PairSchedule, _canonical_pairs,
                        build_causal_schedule, build_schedule)

__all__ = [
    "Placement",
    "ShiftPlacement",
    "CyclicQuorumPlacement",
    "ProjectivePlanePlacement",
    "AffinePlanePlacement",
    "FullReplicationPlacement",
    "register_placement",
    "registered_placements",
    "weighted_owner_table",
    "get_placement",
    "supported_placements",
    "auto_placement",
    "plane_placement",
    "resolve_placement",
    "placement_from_env",
]


_REGISTRY: Dict[str, Type["Placement"]] = {}


def register_placement(cls: Type["Placement"]) -> Type["Placement"]:
    """Class decorator: add ``cls`` to the placement registry under
    ``cls.name`` (DESIGN.md section 10).  Registered placements are what
    the conformance suite sweeps and what ``REPRO_PLACEMENT`` / ``auto``
    select among."""
    assert cls.name and cls.name not in ("abstract", "plane", "auto"), cls
    _REGISTRY[cls.name] = cls
    return cls


def registered_placements() -> Dict[str, Type["Placement"]]:
    """Snapshot of the registry: name -> placement class (DESIGN.md
    section 10)."""
    return dict(_REGISTRY)


class Placement(abc.ABC):
    """A data placement of P blocks over P devices (see module docstring).

    Instances are cheap value objects hashed on ``(name, P)`` —
    :func:`get_placement` memoizes them so they are safe lru_cache keys
    for jitted-program caches (serving ``query_fn`` / ``update_fn``).
    """

    name: str = "abstract"

    def __init__(self, P: int):
        if P < 1:
            raise ValueError(f"P must be >= 1, got {P}")
        if not self.supports(P):
            raise ValueError(
                f"{type(self).__name__} ({self.name!r}) is not defined for "
                f"P={P}; check supports(P) or use auto_placement(P)")
        self.P = int(P)

    # -- definition domain ------------------------------------------------

    @classmethod
    @abc.abstractmethod
    def supports(cls, P: int) -> bool:
        """True iff this placement is defined (constructible) for P."""

    # -- residency --------------------------------------------------------

    @property
    def n_blocks(self) -> int:
        """Number of data blocks placed (equal to P for every registered
        placement: block i's canonical owner is device i)."""
        return self.P

    @abc.abstractmethod
    def residency(self, i: int) -> frozenset:
        """The set of global block ids resident on device ``i``."""

    @functools.cached_property
    def residency_sets(self) -> Tuple[frozenset, ...]:
        """``residency(i)`` for every device, as a tuple (memoized)."""
        return tuple(self.residency(i) for i in range(self.P))

    def block_holders(self, b: int) -> Tuple[int, ...]:
        """The devices holding block ``b`` (sorted)."""
        return tuple(i for i, S in enumerate(self.residency_sets) if b in S)

    @functools.cached_property
    def replication(self) -> int:
        """Copies of the most-replicated block — the storage headline."""
        counts = [0] * self.n_blocks
        for S in self.residency_sets:
            for b in S:
                counts[b] += 1
        return max(counts)

    @functools.cached_property
    def max_residency(self) -> int:
        """Largest per-device residency (blocks a device must store)."""
        return max(len(S) for S in self.residency_sets)

    # -- route structure --------------------------------------------------

    @property
    def shifts(self) -> Optional[Tuple[int, ...]]:
        """The cyclic difference cover realizing residency with ppermute
        shifts, or None for a placement with no cyclic route structure."""
        return None

    @property
    def full(self) -> bool:
        """True for full replication — the engine then routes the
        computation through ``allgather_allpairs`` instead of the quorum
        gather/compute/scatter pipeline."""
        return False

    def schedule(self) -> PairSchedule:
        """The SPMD all-pairs schedule over this placement's residency."""
        if self.shifts is None:
            raise NotImplementedError(
                f"placement {self.name!r} has no cyclic route structure; "
                "the shift-based engine cannot schedule it")
        return build_schedule(self.P, placement=self)

    def causal_schedule(self) -> CausalSchedule:
        """The causal (triangular) schedule over this placement."""
        if self.shifts is None:
            raise NotImplementedError(
                f"placement {self.name!r} has no cyclic route structure; "
                "the shift-based engine cannot schedule it")
        return build_causal_schedule(self.P, placement=self)

    # -- ownership --------------------------------------------------------

    @abc.abstractmethod
    def owner_of(self, x: int, y: int, *,
                 weights: Optional[Sequence[float]] = None) -> int:
        """Canonical owner device of unordered block pair {x, y}.

        Must be symmetric (``owner_of(x, y) == owner_of(y, x)``), the
        owner must hold both blocks, and per-device owned-pair counts
        must balance to within one pair (the conformance contract).

        ``weights`` is an optional length-P capacity-weight vector
        (measured device throughput, Rocket's heterogeneity model —
        DESIGN.md section 13): ownership then partitions the pairs
        *proportionally to capacity* via :func:`weighted_owner_table`,
        still assigning every pair to a device holding both blocks.
        None or a uniform vector is bit-identical to the unweighted
        partition.
        """

    # -- identity ---------------------------------------------------------

    def describe(self) -> str:
        """One-line summary for logs/selfchecks."""
        return (f"{self.name}(P={self.P}, replication={self.replication})")

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return f"{type(self).__name__}(P={self.P})"

    def __eq__(self, other) -> bool:
        return (isinstance(other, Placement)
                and other.name == self.name and other.P == self.P)

    def __hash__(self) -> int:
        return hash((self.name, self.P))


class ShiftPlacement(Placement):
    """Base for placements realized by a cyclic difference cover A:
    device i holds blocks ``{(i + a) % P : a in A}`` and the engine
    routes with the existing ppermute shifts.  Subclasses supply the
    cover via ``_cover()``."""

    @abc.abstractmethod
    def _cover(self) -> Tuple[int, ...]:
        """The verified difference cover (sorted, residues mod P)."""

    @functools.cached_property
    def shifts(self) -> Tuple[int, ...]:  # type: ignore[override]
        """The verified difference cover, sorted (the ppermute routes)."""
        A = tuple(sorted(a % self.P for a in self._cover()))
        assert is_difference_cover(A, self.P), (self.name, self.P, A)
        return A

    def residency(self, i: int) -> frozenset:
        """Cyclic translate residency: device i holds ``A + i mod P``."""
        return frozenset((i + a) % self.P for a in self.shifts)

    @functools.cached_property
    def replication(self) -> int:  # type: ignore[override]
        """k = |A|: every block lands in exactly k translates (Eq. 13)."""
        return len(self.shifts)

    @functools.cached_property
    def _canonical(self) -> Dict[int, Tuple[int, int]]:
        return _canonical_pairs(self.P, list(self.shifts))

    def owner_of(self, x: int, y: int, *,
                 weights: Optional[Sequence[float]] = None) -> int:
        """The engine-consistent canonical owner: the device whose quorum
        places the pair's canonical lower endpoint at slot ``a_lo`` of
        the per-difference rule (scheduler docstring), with the even-P
        d = P/2 orbit resolved by the keeper rule of
        ``core.allpairs.pair_mask_table`` (the generating device whose
        lower endpoint is the smaller block id keeps it) — so ownership
        here is exactly the pair the engine actually computes post-mask.

        With a non-uniform ``weights`` capacity vector the partition is
        :func:`weighted_owner_table`'s proportional assignment instead
        (DESIGN.md section 13); uniform weights (or None) keep the
        bit-exact historical partition.
        """
        P = self.P
        x, y = x % P, y % P
        if weights is not None:
            w = _validate_weights(weights, P)
            if len(set(w)) > 1:
                return int(weighted_owner_table(self, w)[x, y])
        d = (y - x) % P
        dd = min(d, (P - d) % P)
        a_lo, _ = self._canonical[dd]
        if dd == 0:
            j = x
        elif d == dd == (P - d) % P:      # even-P half orbit: keeper rule
            j = min(x, y)
        else:
            j = x if d == dd else y       # lower endpoint, canonical direction
        return (j - a_lo) % P


# ---------------------------------------------------------------------------
# Weighted ownership (DESIGN.md section 13)
# ---------------------------------------------------------------------------

def _validate_weights(weights: Sequence[float], P: int) -> Tuple[float, ...]:
    """Validated capacity-weight tuple: length P, all positive."""
    w = tuple(float(v) for v in weights)
    if len(w) != P:
        raise ValueError(f"weights must have length P={P}, got {len(w)}")
    if any(v <= 0 for v in w):
        raise ValueError(f"weights must be positive, got {w}")
    return w


@functools.lru_cache(maxsize=128)
def _weighted_owner_table(plc: "Placement",
                          weights: Tuple[float, ...]) -> np.ndarray:
    """The memoized table behind :func:`weighted_owner_table` (placements
    are hashable value objects, so (placement, weights) is a cache key)."""
    P = plc.P
    sets = plc.residency_sets
    total = P * (P + 1) // 2
    wsum = sum(weights)
    target = [total * v / wsum for v in weights]
    ceil_t = [math.ceil(t) for t in target]
    load = [0.0] * P
    table = np.full((P, P), -1, dtype=np.int32)
    cand_of: Dict[Tuple[int, int], List[int]] = {}
    for x in range(P):
        for y in range(x, P):
            # a weighted owner must hold >= 1 of the two blocks (the other
            # is a tier-2 fetch, DESIGN.md section 13); co-resident holders
            # win deficit ties so fetches only happen when capacity demands
            cands = sorted(i for i in range(P)
                           if x in sets[i] or y in sets[i])
            cand_of[(x, y)] = cands
            owner = max(cands, key=lambda c: (
                target[c] - load[c],
                1 if (x in sets[c] and y in sets[c]) else 0,
                -c))
            load[owner] += 1.0
            table[x, y] = table[y, x] = owner
    # repair pass: the greedy can overshoot a ceil target by one pair near
    # the end of the visit order; move pairs from over-ceil devices onto
    # under-ceil candidates until every load fits its ceil target
    for _ in range(2 * P):
        over = [c for c in range(P) if load[c] > ceil_t[c]]
        if not over:
            break
        moved = False
        for c in over:
            for (x, y), cands in sorted(cand_of.items()):
                if table[x, y] != c:
                    continue
                under = [d for d in cands if load[d] + 1 <= ceil_t[d]]
                if under:
                    d = max(under, key=lambda u: (target[u] - load[u], -u))
                    table[x, y] = table[y, x] = d
                    load[c] -= 1.0
                    load[d] += 1.0
                    moved = True
                    if load[c] <= ceil_t[c]:
                        break
        if not moved:  # pragma: no cover - no feasible move left
            break
    return table


def weighted_owner_table(placement: "Placement",
                         weights: Sequence[float]) -> np.ndarray:
    """[P, P] owner table partitioning all unordered block pairs
    proportionally to per-device capacity weights (DESIGN.md section 13
    — Rocket's heterogeneous-throughput direction).

    Deterministic deficit-greedy with a repair pass: pairs are visited
    in canonical ``(x, y)``, ``x <= y`` order and each is assigned to
    the candidate with the largest remaining capacity deficit
    ``target_c - load_c`` (``target_c = total * w_c / sum(w)``); ties
    prefer a co-resident holder, then the smallest device id.  A
    *candidate* is any device holding at least one of the two blocks:
    most pairs are co-resident on exactly one device (λ = 1 on the
    planes), so proportionality is unreachable over both-block holders
    alone — the missing block of a single-block owner rides the same
    tier-2 fetch path the failure recovery uses, which is exactly
    Rocket's "fast devices pull extra data" trade.  A final repair pass
    moves boundary pairs off over-target devices, so per-device loads
    satisfy ``load_c <= ceil(target_c)`` for every registered placement
    (the weighted conformance suite pins it at every P <= 64).  Uniform
    weights reproduce the unweighted ``owner_of`` partition
    bit-identically (the callers short-circuit before reaching here).
    The table is memoized on (placement, weights) — placements are
    hashable value objects.
    """
    w = _validate_weights(weights, placement.P)
    if len(set(w)) <= 1:
        # uniform: the historical partition, bit-exact by construction
        P = placement.P
        table = np.full((P, P), -1, dtype=np.int32)
        for x in range(P):
            for y in range(x, P):
                table[x, y] = table[y, x] = placement.owner_of(x, y)
        return table
    return _weighted_owner_table(placement, w)


# ---------------------------------------------------------------------------
# Registered placements
# ---------------------------------------------------------------------------

@register_placement
class CyclicQuorumPlacement(ShiftPlacement):
    """The paper's cyclic quorums from a relaxed (P,k)-difference set —
    the universal default (defined for every P; optimal k for P <= 36 by
    exact search, Singer where P = q^2+q+1, ~2*sqrt(P) ladder beyond).
    Bit-exact with the pre-placement-layer behavior: ``shifts`` is
    ``difference_set(P)`` itself."""

    name = "cyclic"

    @classmethod
    def supports(cls, P: int) -> bool:
        """Defined for every P >= 1 (the universal fallback)."""
        return P >= 1

    def _cover(self) -> Tuple[int, ...]:
        return tuple(difference_set(self.P))


def _plane_order_projective(P: int) -> Optional[int]:
    """q >= 2 with q^2 + q + 1 == P, else None."""
    q = (math.isqrt(4 * P - 3) - 1) // 2
    for qq in (q, q + 1):
        if qq >= 2 and qq * qq + qq + 1 == P:
            return qq
    return None


def _plane_order_affine(P: int) -> Optional[int]:
    """q >= 2 with q^2 + q == P, else None."""
    q = (math.isqrt(4 * P + 1) - 1) // 2
    for qq in (q, q + 1):
        if qq >= 2 and qq * qq + qq == P:
            return qq
    return None


def _is_perfect_difference_set(A: Tuple[int, ...], P: int) -> bool:
    """Every nonzero residue mod P is a difference of A *exactly once*
    (lambda = 1 — the planar/Singer property, not just a cover)."""
    seen = [0] * P
    for ai in A:
        for aj in A:
            if ai != aj:
                seen[(ai - aj) % P] += 1
    return all(c == 1 for c in seen[1:])


@functools.lru_cache(maxsize=None)
def _projective_cover(P: int) -> Optional[Tuple[int, ...]]:
    """A perfect (q+1)-element difference set mod P = q^2+q+1, or None.

    Singer construction for prime q (a genuinely plane-derived set, which
    may differ from ``difference_set(P)`` — e.g. P = 31); for prime-power
    q the prime-field Singer is unavailable, so fall back to the exact
    search (optimal => perfect here) when P is within its cap.
    """
    q = _plane_order_projective(P)
    if q is None or _prime_power_base(q) is None:
        return None
    A = singer_difference_set(q)
    if A is None:
        cand = difference_set(P)
        A = cand if len(cand) == q + 1 else None
    if A is None:
        return None
    A = tuple(sorted(a % P for a in A))
    return A if _is_perfect_difference_set(A, P) else None


@register_placement
class ProjectivePlanePlacement(ShiftPlacement):
    """Lines of the projective plane PG(2, q) as quorums, P = q^2+q+1.

    The Singer cycle makes the line set cyclic: the P translates of a
    perfect (P, q+1, 1)-difference set are exactly the P lines, every
    pair of blocks (points) is co-resident on exactly one device (line),
    and replication is exactly q + 1 — the sqrt(P) optimum of Hall,
    Kelly & Tian.  Defined for prime-power q with a constructible Singer
    set (q prime, or q = 4 via exact search): P in {7, 13, 21, 31, 57}
    for P <= 64.
    """

    name = "projective"

    @classmethod
    def supports(cls, P: int) -> bool:
        """True iff P = q^2+q+1 with a constructible Singer set."""
        return P >= 1 and _projective_cover(P) is not None

    @property
    def order(self) -> int:
        """The plane order q (replication is q + 1)."""
        return _plane_order_projective(self.P)

    def _cover(self) -> Tuple[int, ...]:
        return _projective_cover(self.P)


@functools.lru_cache(maxsize=None)
def _affine_cover(P: int) -> Optional[Tuple[int, ...]]:
    """An almost-perfect (q+1)-element difference cover mod P = q^2+q,
    or None when none exists (see module docstring feasibility note).

    ``difference_set`` runs the exact branch-and-bound for P <= 36, so a
    q+1-sized result there is a proof of constructibility and a larger
    result a proof of impossibility; beyond the exact cap no affine
    cover is attempted (the ladder fallback is never q+1-sized).
    """
    q = _plane_order_affine(P)
    if q is None or _prime_power_base(q) is None:
        return None
    A = tuple(difference_set(P))
    return A if len(A) == q + 1 else None


@register_placement
class AffinePlanePlacement(ShiftPlacement):
    """Affine-parameter placement, P = q^2 + q, replication exactly q+1.

    The affine analog of the Singer realization: an almost-perfect
    difference cover of size q + 1 mod q^2 + q (q(q+1) ordered
    differences for q^2+q-1 residues — one collision).  Constructible
    for q in {2, 3} (P = 6, 12); provably nonexistent for q in {4, 5}
    and not attempted beyond the exact-search cap, so those P fall back
    to ``cyclic`` under ``auto`` / ``plane`` selection.
    """

    name = "affine"

    @classmethod
    def supports(cls, P: int) -> bool:
        """True iff P = q^2+q with a constructible almost-perfect cover."""
        return P >= 1 and _affine_cover(P) is not None

    @property
    def order(self) -> int:
        """The plane order q (replication is q + 1)."""
        return _plane_order_affine(self.P)

    def _cover(self) -> Tuple[int, ...]:
        return _affine_cover(self.P)


@register_placement
class FullReplicationPlacement(ShiftPlacement):
    """Every block on every device — the "all data everywhere" scheme the
    paper improves on (section 1.1), kept as the degenerate oracle.

    Shift-structured with A = {0..P-1} so every generic consumer (covers,
    reassign, rescale, serving stacks) works unchanged; the batch engine
    special-cases ``full`` and routes through ``allgather_allpairs``.
    The serving cover collapses to a single device.
    """

    name = "full"

    @classmethod
    def supports(cls, P: int) -> bool:
        """Defined for every P >= 1 (the all-gather baseline)."""
        return P >= 1

    @property
    def full(self) -> bool:  # type: ignore[override]
        """True: the batch engine routes through allgather_allpairs."""
        return True

    def _cover(self) -> Tuple[int, ...]:
        return tuple(range(self.P))


# ---------------------------------------------------------------------------
# Selection: registry lookup, auto, env override
# ---------------------------------------------------------------------------

# auto tie-break order: cyclic first keeps default selection bit-exact with
# the pre-placement behavior wherever replication ties (it always does at
# plane-friendly P <= 36, where the exact search is optimal too)
_AUTO_ORDER = ("cyclic", "projective", "affine", "full")


def _selection_order() -> Tuple[str, ...]:
    """Registry names in selection order: the built-in tie-break order
    first, then any later-registered placements alphabetically — so a
    downstream ``@register_placement`` class really is swept by ``auto``
    / ``supported_placements`` without touching this module."""
    extra = sorted(name for name in _REGISTRY if name not in _AUTO_ORDER)
    return tuple(n for n in _AUTO_ORDER if n in _REGISTRY) + tuple(extra)


@functools.lru_cache(maxsize=512)
def get_placement(name: str, P: int) -> Placement:
    """Memoized placement instances — the canonical constructor
    (DESIGN.md section 10).  Raises ``ValueError`` for unknown names or
    P outside the definition domain."""
    cls = _REGISTRY.get(name)
    if cls is None:
        raise ValueError(
            f"unknown placement {name!r}; registered: {sorted(_REGISTRY)}")
    return cls(P)


def supported_placements(P: int) -> List[Placement]:
    """All registered placements defined at P, in selection order
    (DESIGN.md section 10)."""
    return [get_placement(name, P) for name in _selection_order()
            if _REGISTRY[name].supports(P)]


def auto_placement(P: int) -> Placement:
    """The smallest-replication placement defined at P, ties -> cyclic
    (DESIGN.md section 10 "Selection").

    Deliberately not memoized on P alone: the winner depends on the
    registry, so a placement registered after a first selection still
    takes effect (the per-placement construction underneath is cached).
    """
    best = None
    for rank, name in enumerate(_selection_order()):
        if _REGISTRY[name].supports(P):
            plc = get_placement(name, P)
            key = (plc.replication, rank)
            if best is None or key < best[0]:
                best = (key, plc)
    assert best is not None, P  # cyclic supports every P >= 1
    return best[1]


def plane_placement(P: int) -> Optional[Placement]:
    """The plane placement at P — projective first, then affine — or
    None when neither plane is defined at P (DESIGN.md section 10)."""
    for name in ("projective", "affine"):
        if _REGISTRY[name].supports(P):
            return get_placement(name, P)
    return None


def resolve_placement(spec, P: int) -> Placement:
    """Resolve a placement spec for P (DESIGN.md section 10 "Selection").

    ``spec`` may be a Placement instance (P must match), a registered
    name, ``"auto"`` (smallest replication), ``"plane"`` (projective ->
    affine -> cyclic fallback, so matrix sweeps can include plane-less
    P), or None/"" (same as ``"auto"``).
    """
    if isinstance(spec, Placement):
        if spec.P != P:
            raise ValueError(f"placement {spec.describe()} does not match P={P}")
        return spec
    name = (spec or "auto").strip().lower()
    if name == "auto":
        return auto_placement(P)
    if name == "plane":
        return plane_placement(P) or get_placement("cyclic", P)
    return get_placement(name, P)


def placement_from_env(P: int) -> Placement:
    """The placement selected by ``REPRO_PLACEMENT`` (default ``auto``;
    DESIGN.md section 10 "Selection").

    Mirrors ``core.sweep.env_mode_override``: read at selection time
    through the core/env.py registry (setting the env var after import
    works; already-compiled programs keep their baked-in placement), and
    unknown values raise instead of silently falling back.  With the
    variable unset, ``auto`` resolves to the cyclic construction at
    every P (the tie-break keeps default behavior bit-exact).
    """
    from . import env as env_mod
    return resolve_placement(env_mod.read_knob("REPRO_PLACEMENT"), P)
