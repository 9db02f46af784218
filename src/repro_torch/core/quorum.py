"""Relaxed (P,k)-difference sets and cyclic quorum sets.

This is the mathematical heart of the paper: a *relaxed (P,k)-difference set*
``A = {a_1..a_k} (mod P)`` is a set such that every residue ``d != 0 (mod P)``
can be written as ``a_i - a_j (mod P)`` for some ``a_i, a_j in A`` (paper
Definition 1).  The cyclic quorum set it generates, ``S_i = {a + i mod P}``,
satisfies the all-pairs property (paper Theorem 1): every unordered pair of
block indices ``(x, y)`` is co-resident in at least one quorum.

Three construction strategies (DESIGN.md section 3.1):
  * exact branch-and-bound (optimal k) for small P,
  * Singer difference sets (perfect, optimal) when ``P = q^2 + q + 1``
    for a prime power q,
  * a guaranteed ``~2*sqrt(P)`` "ladder" cover with greedy local improvement
    for everything else.
Every returned set is verified with :func:`is_difference_cover`; callers never
depend on optimality for correctness, only for the replication factor.

A copy of ``repro/core/quorum.py`` for the PyTorch port, which must import
nothing of the JAX package; keep the two in step (the port's tests
hold them equal).
"""

from __future__ import annotations

import functools
import math
from typing import List, Sequence, Tuple

__all__ = [
    "is_difference_cover",
    "difference_set",
    "cyclic_quorums",
    "quorum_size_lower_bound",
    "verify_all_pairs_property",
    "singer_difference_set",
    "ladder_difference_cover",
]


# ---------------------------------------------------------------------------
# Verification
# ---------------------------------------------------------------------------

def is_difference_cover(A: Sequence[int], P: int) -> bool:
    """True iff every residue mod P is a difference of two elements of A."""
    if P <= 0:
        return False
    seen = [False] * P
    A = list(A)
    for ai in A:
        for aj in A:
            seen[(ai - aj) % P] = True
    return all(seen)


def quorum_size_lower_bound(P: int) -> int:
    """Smallest k with k*(k-1) + 1 >= P (paper Eq. 11 / Maekawa)."""
    k = max(1, math.isqrt(P))
    while k * (k - 1) + 1 < P:
        k += 1
    return k


# ---------------------------------------------------------------------------
# Constructions
# ---------------------------------------------------------------------------

def _is_prime(n: int) -> bool:
    if n < 2:
        return False
    for p in range(2, math.isqrt(n) + 1):
        if n % p == 0:
            return False
    return True


def _prime_power_base(q: int) -> int | None:
    """Return prime p if q = p^m for some m >= 1, else None."""
    if q < 2:
        return None
    for p in range(2, math.isqrt(q) + 1):
        if q % p == 0:
            while q % p == 0:
                q //= p
            return p if q == 1 else None
    return q  # q itself prime


class _GF:
    """Tiny GF(q) arithmetic for prime q (enough for Singer sets with prime q)."""

    def __init__(self, q: int):
        assert _is_prime(q), "only prime fields implemented"
        self.q = q

    # GF(q^3) represented as polynomials (c0, c1, c2) over GF(q) modulo a
    # degree-3 irreducible polynomial found by search.
    @functools.cached_property
    def cubic_irreducible(self) -> Tuple[int, int, int]:
        """Coefficients (b0, b1, b2) of monic irreducible x^3 + b2 x^2 + b1 x + b0."""
        q = self.q
        for b2 in range(q):
            for b1 in range(q):
                for b0 in range(1, q):
                    # irreducible over GF(q) iff no root in GF(q) (degree 3)
                    if all((pow(x, 3, q) + b2 * x * x + b1 * x + b0) % q != 0
                           for x in range(q)):
                        return (b0, b1, b2)
        raise RuntimeError("no cubic irreducible found")  # pragma: no cover

    def mul3(self, u: Tuple[int, int, int], v: Tuple[int, int, int]) -> Tuple[int, int, int]:
        q = self.q
        b0, b1, b2 = self.cubic_irreducible
        # schoolbook multiply -> degree-4 poly
        c = [0] * 5
        for i, ui in enumerate(u):
            if ui:
                for j, vj in enumerate(v):
                    c[i + j] = (c[i + j] + ui * vj) % q
        # reduce x^4 then x^3 using x^3 = -(b2 x^2 + b1 x + b0)
        for deg in (4, 3):
            coef = c[deg]
            if coef:
                c[deg] = 0
                c[deg - 1] = (c[deg - 1] - coef * b2) % q
                c[deg - 2] = (c[deg - 2] - coef * b1) % q
                c[deg - 3] = (c[deg - 3] - coef * b0) % q
        return (c[0], c[1], c[2])


def singer_difference_set(q: int) -> List[int] | None:
    """Perfect (q^2+q+1, q+1, 1) Singer difference set, for prime q.

    Construction: GF(q^3)^* / GF(q)^* is cyclic of order P = q^2+q+1.  Pick a
    generator g of GF(q^3)^*; the exponents i (mod P) for which g^i lies in the
    2-dim GF(q)-subspace {c0 + c1*x} form a Singer difference set.
    Returns None if q is not prime (prime-power fields not implemented — the
    caller falls back to search/ladder).
    """
    if not _is_prime(q):
        return None
    P = q * q + q + 1
    gf = _GF(q)
    order = q ** 3 - 1

    def element_order(g: Tuple[int, int, int]) -> int:
        acc = g
        n = 1
        while acc != (1, 0, 0):
            acc = gf.mul3(acc, g)
            n += 1
            if n > order:  # pragma: no cover
                return -1
        return n

    # find a generator of GF(q^3)^* (search small elements; density of
    # generators is phi(order)/order, typically high)
    gen = None
    for c2 in range(q):
        for c1 in range(q):
            for c0 in range(q):
                g = (c0, c1, c2)
                if g == (0, 0, 0):
                    continue
                if element_order(g) == order:
                    gen = g
                    break
            if gen:
                break
        if gen:
            break
    if gen is None:  # pragma: no cover
        return None

    A: List[int] = []
    acc = (1, 0, 0)
    for i in range(order):
        if acc[2] == 0:  # in the 2-dim subspace {c0 + c1 x}
            A.append(i % P)
        if len(set(A)) >= q + 1 and i >= P:
            break
        acc = gf.mul3(acc, gen)
    A = sorted(set(A))[: q + 1]
    return A if len(A) == q + 1 and is_difference_cover(A, P) else None


def ladder_difference_cover(P: int) -> List[int]:
    """Guaranteed difference cover of size ~2*sqrt(P).

    A = {0..r-1} ∪ {q*r + r-1 : q = 1..ceil(P/r)-1}.  Any d = q*r + s
    (0 <= s < r) equals (q*r + r-1) - (r-1-s), both members of A.
    """
    if P == 1:
        return [0]
    r = max(1, math.isqrt(P))
    A = set(range(r))
    m = 1
    while m * r + r - 1 < P + r:  # cover every difference class
        A.add((m * r + r - 1) % P)
        m += 1
    A = sorted(A)
    assert is_difference_cover(A, P), (P, A)
    return A


def _branch_and_bound(P: int, limit_k: int) -> List[int] | None:
    """Exact minimal difference cover search (A always contains 0, then 1 wlog
    is NOT valid for difference covers in general, so only 0 is pinned).

    Prunes on: remaining capacity (adding e more elements covers at most
    e*(2*|A|) + e*(e-1) new differences).
    """
    target = P  # number of residues to cover (0 is always covered)

    best: List[int] | None = None

    def covered_count(mask: int) -> int:
        return bin(mask).count("1")

    full_mask = (1 << P) - 1

    def extend(A: List[int], mask: int, start: int, k: int) -> List[int] | None:
        if mask == full_mask:
            return list(A)
        if len(A) == k:
            return None
        remaining = k - len(A)
        missing = target - covered_count(mask)
        # each new element adds <= 2*|A| + 1 diffs now, and pairs among the
        # remaining elements add <= remaining*(remaining-1) more
        cap = 0
        sz = len(A)
        for t in range(remaining):
            cap += 2 * (sz + t) + 1
        if cap < missing:
            return None
        for nxt in range(start, P):
            new_mask = mask
            for a in A:
                new_mask |= 1 << ((nxt - a) % P)
                new_mask |= 1 << ((a - nxt) % P)
            new_mask |= 1  # self-difference
            A.append(nxt)
            r = extend(A, new_mask, nxt + 1, k)
            if r is not None:
                return r
            A.pop()
        return None

    k = quorum_size_lower_bound(P)
    while k <= limit_k:
        r = extend([0], 1, 1, k)
        if r is not None:
            return r
        k += 1
    return None


def _local_improve(A: List[int], P: int) -> List[int]:
    """Greedy element deletion while the set remains a difference cover."""
    A = list(A)
    improved = True
    while improved:
        improved = False
        for a in list(A):
            cand = [x for x in A if x != a]
            if is_difference_cover(cand, P):
                A = cand
                improved = True
                break
    return sorted(A)


# Exact search is exponential; cap the P for which we run it.  Above the cap we
# use Singer (when applicable) or ladder + local improvement.
_EXACT_SEARCH_MAX_P = 36

_CACHE: dict[int, List[int]] = {}


def difference_set(P: int) -> List[int]:
    """Return a verified relaxed (P,k)-difference set, minimizing k by strategy.

    Deterministic and memo-cached; O(ms) for the P values a launcher touches,
    so elastic re-derivation on pod resize is cheap (DESIGN.md section 8).
    """
    if P < 1:
        raise ValueError(f"P must be >= 1, got {P}")
    if P in _CACHE:
        return list(_CACHE[P])

    A: List[int] | None = None
    if P <= 2:
        A = list(range(P))
    if A is None and P <= _EXACT_SEARCH_MAX_P:
        A = _branch_and_bound(P, limit_k=quorum_size_lower_bound(P) + 3)
    if A is None:
        # Singer: P = q^2 + q + 1?
        q = math.isqrt(P)
        for qq in (q - 1, q, q + 1):
            if qq >= 2 and qq * qq + qq + 1 == P:
                A = singer_difference_set(qq)
                break
    if A is None:
        A = _local_improve(ladder_difference_cover(P), P)

    A = sorted(set(x % P for x in A))
    if not is_difference_cover(A, P):  # pragma: no cover - all paths verified
        raise AssertionError(f"constructed set is not a difference cover: P={P} A={A}")
    _CACHE[P] = list(A)
    return list(A)


# ---------------------------------------------------------------------------
# Quorums
# ---------------------------------------------------------------------------

def cyclic_quorums(P: int) -> List[List[int]]:
    """All P cyclic quorums S_i = {a + i mod P : a in A} (paper Eq. 15)."""
    A = difference_set(P)
    return [sorted((a + i) % P for a in A) for i in range(P)]


def verify_all_pairs_property(quorums: Sequence[Sequence[int]], P: int) -> bool:
    """Check paper Eq. 16: every unordered pair (incl. self-pairs) co-resident."""
    ok = [[False] * P for _ in range(P)]
    for S in quorums:
        for x in S:
            for y in S:
                ok[x][y] = True
    return all(ok[x][y] for x in range(P) for y in range(P))
