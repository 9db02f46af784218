"""Fault injection and fault-tolerant sweep execution (counterpart of
``repro/core/faults.py``, DESIGN.md section 13).

Every block is replicated in exactly k quorums (the paper's Eq. 13), which
is what makes an all-pairs sweep survivable.  The failure-detection
boundary is the **round**: the synchronization points
:func:`core.sweep.sweep_rounds` derives from each engine mode (batched:
one round; overlap: one per gather shift; scan: one per pair).  Between
rounds a host-side loop consults a deterministic, seeded
:class:`FaultPlan` and reacts:

  * **kill d** — device d's store and non-durable partials are gone.  The
    loop reassigns the dead device's remaining pair tiles
    (``core.scheduler.reassign``: a live co-resident peer, else a live
    holder of one block fetches the other), then **re-replicates** the
    under-replicated blocks from surviving holders
    (``launch.elastic.plan_replication_repair``) so the k-residency
    invariant holds again.  Partials the dead device computed since the
    last checkpoint are recomputed; durable partials (the
    ``REPRO_CKPT_EVERY`` round-boundary checkpoints through
    ``ckpt/checkpoint.py``) are not.
  * **slow d by f** — device d's virtual per-pair busy time is scaled by
    f from this round on (``RecoveryStats.busy_by_device``).
  * **drop** — one block message this round is lost and retransmitted.

When *all* holders of a block die, ``reassign`` refuses ("block lost")
and the loop restores from the latest complete checkpoint (blocks
re-seeded onto live devices, durable partials kept, only the non-durable
tail recomputed) and resumes.  The final output is **bit-exact**:
partials are pure functions of the block contents, and the fold runs in
canonical pair order, so neither the fault history nor the engine mode
can change a bit.

The workloads hold their blocks and partials as tensors on their device
(a partial crosses to numpy only at the checkpoint's npz boundary); the
schedule, the plan and the recovery are host-side.  The check is the
chaos selfcheck (``python -m repro_torch.core.faults [--device cpu]``):
kill a random live device every N rounds across every registered
placement x engine mode x P and the three workloads, asserting the
faulted output is bit-identical to the fault-free run, the fault-free
run matches a brute-force oracle, and the residency invariant holds
after every repair.
"""

from __future__ import annotations

import contextlib
import dataclasses
import struct
import tempfile
import time
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..ckpt.checkpoint import restore_or_none, save_checkpoint
from ..launch.elastic import plan_replication_repair
from ..obs import trace as obs_trace
from . import env as env_mod
from .comm import resolve_device
from .delta import dirty_tiles, owner_partition
from .knn import SENT_I64, lexsort_topk
from .placement import Placement, get_placement, registered_placements
from .scheduler import PairSchedule, reassign
from .sparse import _pair_key, threshold_with_gap
from .sweep import ENGINE_MODES, sweep_rounds

__all__ = [
    "FaultEvent",
    "FaultPlan",
    "RecoveryStats",
    "PairWorkload",
    "DenseReduceWorkload",
    "SparseJoinWorkload",
    "KnnGraphWorkload",
    "WORKLOADS",
    "run_fault_tolerant_sweep",
    "residency_invariant_ok",
    "chaos_selfcheck",
    "CHAOS_P",
]

# the chaos matrix: odd / even P, the projective planes 7 and 13, and the
# affine plane 12
CHAOS_P = (5, 7, 8, 12, 13)

_KINDS = ("kill", "slow", "drop")


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    """One injected fault: ``kill`` (device dies at the start of
    ``round``), ``slow`` (device runs ``factor`` x slower from this round
    on) or ``drop`` (one block transfer this round is lost and
    retransmitted)."""
    kind: str
    round: int
    device: int = -1          # -1 for drop (the link, not a device)
    factor: float = 1.0       # slow only

    def __post_init__(self):
        if self.kind not in _KINDS:
            raise ValueError(f"kind must be one of {_KINDS}, "
                             f"got {self.kind!r}")


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """A deterministic, seeded fault schedule the sweep consults at every
    round boundary.  Pure data: the same plan against the same workload
    gives the same recovery actions."""
    events: Tuple[FaultEvent, ...] = ()

    def events_at(self, rnd: int) -> List[FaultEvent]:
        """Events firing at the start of round ``rnd`` (kills first, so a
        killed device never services this round's transfers)."""
        order = {"kill": 0, "drop": 1, "slow": 2}
        return sorted((e for e in self.events if e.round == rnd),
                      key=lambda e: (order[e.kind], e.device))

    @property
    def n_kills(self) -> int:
        """Total device kills in the plan."""
        return sum(1 for e in self.events if e.kind == "kill")

    @classmethod
    def random_kills(cls, P: int, n_rounds: int, every: int = 2,
                     seed: int = 0, chaos: bool = True) -> "FaultPlan":
        """Kill a random live device every ``every`` rounds (never the last
        survivor), deterministically from ``seed`` (the reference's
        draws); with ``chaos`` also a message drop at each kill round and
        a slowdown of a random live device between kills."""
        if every < 1:
            raise ValueError(f"every must be >= 1, got {every}")
        rng = np.random.RandomState(seed)
        alive = list(range(P))
        events: List[FaultEvent] = []
        for rnd in range(n_rounds):
            # short sweeps (batched: one round) still get their one kill
            kill_here = ((rnd + 1) % every == 0
                         or (n_rounds < every and rnd == 0))
            if kill_here and len(alive) > 1:
                victim = alive[int(rng.randint(len(alive)))]
                alive.remove(victim)
                events.append(FaultEvent("kill", rnd, victim))
                if chaos:
                    events.append(FaultEvent("drop", rnd))
            elif chaos and rnd % every == 0 and alive:
                dev = alive[int(rng.randint(len(alive)))]
                events.append(FaultEvent(
                    "slow", rnd, dev, factor=float(1.25 + rng.rand())))
        return cls(events=tuple(events))


@dataclasses.dataclass
class RecoveryStats:
    """Counters the sweep accumulates while recovering (DESIGN.md
    sections 13, 14)."""
    rounds: int = 0
    n_kills: int = 0
    n_slow: int = 0
    n_drops: int = 0
    n_drop_retries: int = 0
    n_reassigned: int = 0          # pairs moved to new owners
    n_fetches: int = 0             # tier-2 / weighted-owner block pulls
    n_rereplicated: int = 0        # block copies restoring k-residency
    n_restores: int = 0            # checkpoint restores (block loss)
    n_recomputed: int = 0          # non-durable partials recomputed
    n_checkpoints: int = 0
    bytes_fetched: int = 0         # tier-2 fetch traffic
    bytes_rereplicated: int = 0    # repair-copy traffic
    # per-device work: pairs computed, deterministic virtual busy time
    # (rows_x * rows_y * slow factor per pair) and measured busy seconds
    pairs_by_device: Dict[int, int] = dataclasses.field(default_factory=dict)
    busy_by_device: Dict[int, float] = dataclasses.field(
        default_factory=dict)
    busy_s_by_device: Dict[int, float] = dataclasses.field(
        default_factory=dict)
    # recovery latency: seconds per phase (reassign / rereplicate /
    # restore / checkpoint)
    recovery_s: Dict[str, float] = dataclasses.field(default_factory=dict)

    def as_dict(self) -> Dict[str, Any]:
        """The counters as a plain dict (for JSON output)."""
        return dataclasses.asdict(self)


# ---------------------------------------------------------------------------
# Workloads: pure per-pair partials + a canonical fold
# ---------------------------------------------------------------------------
#
# Bit-exactness across fault histories and engine modes rests on two
# properties every workload keeps: (1) a pair's partial is a pure function
# of the two block contents (the same kernels on the same shapes: the same
# bits whoever computes or recomputes it), and (2) the fold consumes
# partials in canonical (x, y), x <= y order, never in completion order.
# Products run in f32 with TF32 off for the call.

@contextlib.contextmanager
def _exact_f32():
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def _product(bx: torch.Tensor, by: torch.Tensor) -> torch.Tensor:
    """[nx, ny] f32 dot scores of two blocks (TF32 off)."""
    with _exact_f32():
        return bx.float() @ by.float().T


class PairWorkload:
    """Base class: a corpus split into P blocks (tensors on ``device``,
    default the CUDA device) plus the hooks the fault-tolerant sweep
    needs: ``pair_partial`` (pure), ``fold`` (canonical-order combine)
    and ``check_oracle`` (an independent brute-force check).  The corpus
    is the reference's ``np.random.RandomState(seed + 101 * P)`` draw,
    bit for bit."""

    name = "abstract"

    def __init__(self, P: int, n_items: Optional[int] = None, dim: int = 8,
                 seed: int = 0, device=None):
        self.P = P
        self.device = resolve_device(device)
        self.n = int(n_items) if n_items is not None else 3 * P + 2
        rng = np.random.RandomState(seed + 101 * P)
        corpus = rng.randn(self.n, dim).astype(np.float32)
        self.corpus = torch.from_numpy(corpus).to(self.device)
        self.blocks: List[torch.Tensor] = [
            b.contiguous() for b in torch.tensor_split(self.corpus, P)]
        starts = np.cumsum([0] + [b.shape[0] for b in self.blocks])
        self.offsets = [int(s) for s in starts[:-1]]

    # -- the sweep-facing hooks -------------------------------------------
    def pair_partial(self, x: int, y: int, bx: torch.Tensor,
                     by: torch.Tensor) -> Any:
        """Pure partial result for block pair (x, y)."""
        raise NotImplementedError

    def fold(self, partials: Dict[Tuple[int, int], Any]) -> Any:
        """Combine all partials in canonical (x, y), x <= y order."""
        raise NotImplementedError

    def check_oracle(self, result: Any) -> None:
        """Assert ``result`` matches an independent brute-force oracle."""
        raise NotImplementedError

    def equal(self, a: Any, b: Any) -> bool:
        """Bitwise result equality."""
        raise NotImplementedError

    # -- checkpoint encoding ----------------------------------------------
    def encode_partial(self, partial: Any) -> Dict[str, torch.Tensor]:
        """A partial as a dict of tensors (for the checkpoint)."""
        raise NotImplementedError

    def decode_partial(self, enc: Dict[str, Any]) -> Any:
        """Inverse of :meth:`encode_partial`, onto this device."""
        raise NotImplementedError

    def _on(self, a, dtype) -> torch.Tensor:
        return torch.as_tensor(a, dtype=dtype).to(self.device)

    def canonical_pairs(self) -> List[Tuple[int, int]]:
        """All unordered block pairs in the canonical fold order."""
        return [(x, y) for x in range(self.P) for y in range(x, self.P)]


class DenseReduceWorkload(PairWorkload):
    """Global all-pairs reduction: the sum of every pairwise dot product,
    block pair by block pair, folded in canonical order.  A faulted run
    reproduces the fault-free float64 sum bit for bit; the full-Gram
    oracle agrees to float tolerance (another summation order)."""

    name = "dense"

    def pair_partial(self, x, y, bx, by):
        """Float64 sum of the pair's dot products (upper triangle within
        a block), a 0-d tensor."""
        s = _product(bx, by)
        if x == y:  # within a block: each unordered item pair once
            s = torch.triu(s)
        return s.sum(dtype=torch.float64)

    def fold(self, partials):
        """Accumulate the partial sums in canonical pair order (one copy
        to the host, then IEEE double adds in order)."""
        vals = torch.stack([partials[p].reshape(())
                            for p in self.canonical_pairs()]).cpu().tolist()
        acc = 0.0
        for v in vals:
            acc = acc + v
        return torch.tensor(acc, dtype=torch.float64, device=self.device)

    def check_oracle(self, result):
        """Against the full Gram matrix's upper-triangle sum, by row
        chunks."""
        c, want = self.corpus, 0.0
        cols = torch.arange(self.n, device=self.device)
        for i0 in range(0, self.n, 1024):
            g = _product(c[i0:i0 + 1024], c)
            keep = cols[None] >= torch.arange(i0, i0 + g.shape[0],
                                              device=self.device)[:, None]
            want += float(torch.where(keep, g, 0.0).sum(dtype=torch.float64))
        np.testing.assert_allclose(float(result), want, rtol=1e-5)

    def equal(self, a, b):
        """Bit-pattern equality of the float64 totals."""
        return struct.pack("<d", float(a)) == struct.pack("<d", float(b))

    def encode_partial(self, partial):
        return {"v": partial}

    def decode_partial(self, enc):
        return self._on(enc["v"], torch.float64).reshape(())


class SparseJoinWorkload(PairWorkload):
    """Thresholded similarity join: every global item pair (i, j), i < j,
    with dot score >= a gap-protected threshold (selectivity 0.15 of all
    N(N-1)/2 pairs, placed by ``core.sparse.threshold_with_gap`` on the
    device).  The output is the sorted [H, 2] int64 (i, j) tensor, so
    bit-exact equality is set equality."""

    name = "sparse"

    def __init__(self, P, n_items=None, dim=8, seed=0, device=None):
        super().__init__(P, n_items, dim, seed, device)
        upper = torch.ones(self.n, self.n, dtype=torch.bool,
                           device=self.device).triu_(1)
        self.threshold = threshold_with_gap(
            _product(self.corpus, self.corpus)[upper], selectivity=0.15)

    def pair_partial(self, x, y, bx, by):
        """Sorted global (i, j) rows of the pair's hits."""
        keep = _product(bx, by) >= self.threshold
        if x == y:
            keep = torch.triu(keep, diagonal=1)
        ii, jj = torch.nonzero(keep).T
        gi, gj = ii + self.offsets[x], jj + self.offsets[y]
        rows = torch.stack([torch.minimum(gi, gj), torch.maximum(gi, gj)],
                           dim=1)
        return rows[torch.argsort(_pair_key(rows))]

    def fold(self, partials):
        """Concatenate and sort all rows into one join result."""
        allr = torch.cat([partials[p] for p in self.canonical_pairs()])
        return allr[torch.argsort(_pair_key(allr))]

    def check_oracle(self, result):
        """Against ``core.sparse.brute_force_join``, exactly."""
        from .sparse import brute_force_join
        iu, ju, _ = brute_force_join(self.corpus.cpu().numpy(),
                                     self.threshold, "dot")
        want = np.stack([iu.astype(np.int64), ju.astype(np.int64)], axis=1)
        np.testing.assert_array_equal(result.cpu().numpy(), want)

    def equal(self, a, b):
        """Exact equality of the sorted index tensors."""
        return a.shape == b.shape and bool(torch.equal(a, b))

    def encode_partial(self, partial):
        return {"ij": partial}

    def decode_partial(self, enc):
        return self._on(enc["ij"], torch.int64).reshape(-1, 2)


class KnnGraphWorkload(PairWorkload):
    """All-pairs k-nearest-neighbour graph: per item, the top-k other
    items by dot score under the order (-score, index), merged from
    per-pair candidate lists in canonical order.  The output is the
    [N, topk] int64 neighbour index tensor (the int64-max sentinel where
    a row has fewer candidates)."""

    name = "knn"
    topk = 3

    def _row_topk(self, scores, idx):
        """[n, topk] best by (-score, index); non-finite candidates become
        (-inf, sentinel), as the reference's per-row loop leaves them."""
        s, i = lexsort_topk(scores, idx, self.topk)
        fin = torch.isfinite(s)
        return (torch.where(fin, s, float("-inf")),
                torch.where(fin, i, SENT_I64))

    def pair_partial(self, x, y, bx, by):
        """Per-row top-k candidates of each side of the block pair, from
        one product (the y side reads its transpose)."""
        s = _product(bx, by)
        if x == y:
            s.fill_diagonal_(float("-inf"))
        dev = s.device
        iy = (torch.arange(by.shape[0], device=dev)
              + self.offsets[y]).expand(s.shape)
        xs, xi = self._row_topk(s, iy)
        if x == y:
            return {"xs": xs, "xi": xi}
        ix = (torch.arange(bx.shape[0], device=dev)
              + self.offsets[x]).expand(s.shape[::-1])
        ys, yi = self._row_topk(s.T, ix)
        return {"xs": xs, "xi": xi, "ys": ys, "yi": yi}

    def _merge(self, s_a, i_a, s_b, i_b):
        return self._row_topk(torch.cat([s_a, s_b], dim=1),
                              torch.cat([i_a, i_b], dim=1))

    def _fold_parts(self, part_of):
        topk = self.topk
        best_s = torch.full((self.n, topk), float("-inf"),
                            device=self.device)
        best_i = torch.full((self.n, topk), SENT_I64, dtype=torch.int64,
                            device=self.device)
        for (x, y) in self.canonical_pairs():
            part = part_of(x, y)
            sides = ((x, "xs", "xi"),) + (((y, "ys", "yi"),) if x != y
                                          else ())
            for b, ps, pi in sides:
                o, nb = self.offsets[b], self.blocks[b].shape[0]
                best_s[o:o + nb], best_i[o:o + nb] = self._merge(
                    best_s[o:o + nb], best_i[o:o + nb], part[ps], part[pi])
        return best_i

    def fold(self, partials):
        """Merge per-pair candidates into the [N, topk] index tensor."""
        return self._fold_parts(lambda x, y: partials[(x, y)])

    def check_oracle(self, result):
        """A blockwise recompute (the same float ops, so the same ranking
        even at near-ties), plus ``core.knn.brute_force_knn``."""
        want = self._fold_parts(
            lambda x, y: self.pair_partial(x, y, self.blocks[x],
                                           self.blocks[y]))
        assert torch.equal(result, want)
        from .knn import brute_force_knn
        ref = brute_force_knn(self.corpus.cpu().numpy(), self.topk, "dot")
        np.testing.assert_array_equal(result.cpu().numpy(),
                                      ref.indices.astype(np.int64))

    def equal(self, a, b):
        """Exact equality of the neighbour index tensors."""
        return bool(torch.equal(a, b))

    def encode_partial(self, partial):
        return dict(partial)

    def decode_partial(self, enc):
        return {k: self._on(v, torch.float32 if k.endswith("s")
                            else torch.int64) for k, v in enc.items()}


WORKLOADS = (DenseReduceWorkload, SparseJoinWorkload, KnnGraphWorkload)


# ---------------------------------------------------------------------------
# The fault-tolerant sweep
# ---------------------------------------------------------------------------

class _ResidencyView:
    """A placement stand-in carrying the cluster's *current* residency
    sets (they drift after repairs), for reassign()."""

    def __init__(self, P: int, sets: Sequence[set]):
        self.P = P
        self.residency_sets = tuple(frozenset(s) for s in sets)


def residency_invariant_ok(placement: Placement,
                           residency: Sequence[set],
                           alive: Sequence[bool]) -> bool:
    """True iff every block has ``min(placement copy count, live
    devices)`` live replicas, the invariant re-replication restores after
    each failure."""
    P = placement.P
    orig = [0] * P
    for S in placement.residency_sets:
        for b in S:
            orig[b] += 1
    n_live = sum(1 for a in alive if a)
    for b in range(P):
        have = sum(1 for i in range(P) if alive[i] and b in residency[i])
        if have < min(orig[b], n_live):
            return False
    return True


def _ckpt_every_default() -> int:
    val = env_mod.read_knob("REPRO_CKPT_EVERY")
    return 1 if val is None else int(val)


def _nbytes(t: torch.Tensor) -> int:
    return int(t.numel() * t.element_size())


def run_fault_tolerant_sweep(workload: PairWorkload, placement: Placement,
                             mode: str, plan: Optional[FaultPlan] = None,
                             *, ckpt_dir: Optional[str] = None,
                             ckpt_every: Optional[int] = None,
                             weights: Optional[Sequence[float]] = None
                             ) -> Tuple[Any, RecoveryStats]:
    """Execute ``workload`` over ``placement`` in engine ``mode``'s round
    structure, surviving the faults ``plan`` injects (DESIGN.md 13).

    A host-side simulated cluster: device stores hold the workload's
    block tensors per the placement's residency, each pair's partial is
    computed by its owner (``weights`` switches ownership to
    :func:`core.placement.weighted_owner_table`), and at every round
    boundary the sweep consults ``plan``, reassigns a dead device's
    remaining tiles, executes tier-2 fetches, re-replicates lost blocks
    back to the k-residency invariant (asserted), and checkpoints the
    partials every ``ckpt_every`` rounds (default ``REPRO_CKPT_EVERY``,
    else 1) when ``ckpt_dir`` is given.  Block loss restores from the
    latest checkpoint (durable partials kept, the non-durable tail
    recomputed), or re-seeds from the pristine blocks when there is no
    checkpoint directory.  Returns ``(result, RecoveryStats)``; the
    result is bit-identical to the fault-free run in any mode.
    """
    if mode not in ENGINE_MODES:
        raise ValueError(f"mode must be one of {ENGINE_MODES}, got {mode!r}")
    plc = placement
    P = plc.P
    if workload.P != P:
        raise ValueError(f"workload P={workload.P} != placement P={P}")
    schedule: PairSchedule = plc.schedule()
    rounds = sweep_rounds(schedule, mode)
    every = _ckpt_every_default() if ckpt_every is None else int(ckpt_every)
    if every < 1:
        raise ValueError(f"ckpt_every must be >= 1, got {every}")
    stats = RecoveryStats()
    tr = obs_trace.get_tracer()
    slow = [1.0] * P  # current slowdown factor per device
    dev = workload.device

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    @contextlib.contextmanager
    def phase(name: str):
        # time one recovery phase into stats.recovery_s (+ the tracer)
        t0 = time.perf_counter()
        try:
            yield
        finally:
            sync()
            dt = time.perf_counter() - t0
            stats.recovery_s[name] = stats.recovery_s.get(name, 0.0) + dt
            if tr:
                tr.record("faults." + name, dt, placement=plc.name, P=P,
                          mode=mode)

    # canonical pair -> round, via the pair's difference class slot
    sidx_of_diff = {int(d): s for s, d in enumerate(schedule.pair_diff)}
    round_of_sidx = {s: r for r, grp in enumerate(rounds) for s in grp}
    all_pairs = workload.canonical_pairs()

    def pair_round(p: Tuple[int, int]) -> int:
        d = (p[1] - p[0]) % P
        dd = min(d, P - d) if P > 1 else 0
        return round_of_sidx[sidx_of_diff[dd]]

    # ownership: the shared exactly-once partition (core/delta.py)
    owner_map = owner_partition(plc, all_pairs, weights=weights)

    orig_count = [0] * P
    for S in plc.residency_sets:
        for b in S:
            orig_count[b] += 1

    alive = [True] * P
    lost_res: Dict[int, List[int]] = {}  # residency at death, per victim
    res_sets: List[set] = [set(plc.residency(i)) for i in range(P)]
    stores: List[Dict[int, torch.Tensor]] = [
        {b: workload.blocks[b] for b in res_sets[i]} for i in range(P)]
    partials: Dict[Tuple[int, int], Any] = {}
    computed_by: Dict[Tuple[int, int], int] = {}
    durable: set = set()
    drops_pending = 0

    def transfer(src: int) -> None:
        """Account one block message; a pending drop is a retransmit."""
        nonlocal drops_pending
        if drops_pending > 0:
            drops_pending -= 1
            stats.n_drop_retries += 1

    def get_block(d: int, b: int) -> torch.Tensor:
        if b in stores[d]:
            return stores[d][b]
        holders = sorted(i for i in range(P) if alive[i] and b in stores[i])
        if not holders:
            raise RuntimeError(f"block {b} lost: no live holder")
        src = holders[0]
        transfer(src)
        stats.n_fetches += 1
        stats.bytes_fetched += _nbytes(stores[src][b])
        return stores[src][b]

    def apply_reassign(rplan) -> None:
        # tier 1 moves the pair; tier 2 moves it to a one-block holder
        # whose missing block get_block() pulls at compute time
        for tgt, prs in sorted(rplan.extra_pairs.items()):
            for p in prs:
                owner_map[p] = tgt
                stats.n_reassigned += 1
        for tgt, entries in sorted(rplan.fetch_pairs.items()):
            for (p, _missing, _src) in entries:
                owner_map[p] = tgt
                stats.n_reassigned += 1

    def rereplicate(dead: List[int]) -> None:
        rplan = plan_replication_repair(plc, dead, residency=res_sets)
        for (b, src, tgt) in rplan.actions:
            transfer(src)
            stats.bytes_rereplicated += _nbytes(stores[src][b])
            stores[tgt][b] = stores[src][b]
            res_sets[tgt].add(b)
        stats.n_rereplicated += rplan.n_copies
        assert residency_invariant_ok(plc, res_sets, alive)

    def restore_from_checkpoint(dead: List[int]) -> None:
        """Block loss: rebuild from the latest durable state, without a
        full restart."""
        nonlocal partials, computed_by, durable
        stats.n_restores += 1
        if tr:
            tr.count("ckpt.restores")
        ck = (restore_or_none(ckpt_dir, device=dev)
              if ckpt_dir is not None else None)
        if ck is not None:
            tree, _step = ck
            block_data = {int(b): a.to(torch.float32)
                          for b, a in tree.get("blocks", {}).items()}
            partials = {
                (int(k.split("_")[0]), int(k.split("_")[1])):
                    workload.decode_partial(v)
                for k, v in tree.get("partials", {}).items()}
        else:
            # no durable state yet: re-seed from the pristine input blocks
            # (stable storage), recompute everything
            block_data = {b: workload.blocks[b] for b in range(P)}
            partials = {}
        durable = set(partials)
        computed_by = {}
        n_live = sum(1 for a in alive if a)
        live = [i for i in range(P) if alive[i]]
        for i in range(P):
            res_sets[i] = set(plc.residency(i)) if alive[i] else set()
            stores[i] = ({b: block_data[b] for b in res_sets[i]}
                         if alive[i] else {})
        # blocks whose placement holders all died: seed them onto the
        # least-loaded live devices up to the invariant count
        for b in range(P):
            holders = [i for i in live if b in res_sets[i]]
            want = min(orig_count[b], n_live)
            while len(holders) < want:
                tgt = min((i for i in live if b not in res_sets[i]),
                          key=lambda i: (len(res_sets[i]), i))
                res_sets[tgt].add(b)
                stores[tgt][b] = block_data[b]
                holders.append(tgt)
                stats.n_rereplicated += 1
        assert residency_invariant_ok(plc, res_sets, alive)
        # every pending pair owned by a dead device gets a live owner
        todo = {f: [p for p in all_pairs
                    if p not in partials and owner_map[p] == f]
                for f in dead}
        rplan = reassign(schedule, dead, placement=_ResidencyView(
            P, res_sets), weights=weights, pairs=todo)
        apply_reassign(rplan)

    def on_kills(victims: List[int], dead: List[int]) -> None:
        """One recovery for every device that died at this boundary (a
        correlated failure is one batch: what can defeat k-replication
        and force the checkpoint path)."""
        todo: Dict[int, List[Tuple[int, int]]] = {}
        for victim in victims:
            # a dead device's lost work is a dirty set: every pair it can
            # have owned or computed has >= 1 endpoint among the blocks
            # it held (core/delta.py's enumerator is the recovery scan)
            universe = dirty_tiles(plc, lost_res[victim], P=P)
            pending = [p for p in universe
                       if p not in partials and owner_map.get(p) == victim]
            lost_done = sorted(p for p in universe
                               if computed_by.get(p) == victim
                               and p not in durable)
            for p in lost_done:
                del partials[p]
                del computed_by[p]
            stats.n_recomputed += len(lost_done)
            todo[victim] = pending + lost_done
        try:
            with phase("reassign"):
                rplan = reassign(schedule, dead, placement=_ResidencyView(
                    P, res_sets), weights=weights, pairs=todo)
                apply_reassign(rplan)
            with phase("rereplicate"):
                rereplicate(dead)
        except RuntimeError:
            with phase("restore"):
                restore_from_checkpoint(dead)

    for rnd in range(len(rounds)):
        rnd_t0 = time.perf_counter()
        drops_pending = 0
        victims: List[int] = []
        for ev in (plan.events_at(rnd) if plan is not None else []):
            if ev.kind == "slow":
                if alive[ev.device]:
                    stats.n_slow += 1
                    slow[ev.device] *= float(ev.factor)
            elif ev.kind == "drop":
                drops_pending += 1
                stats.n_drops += 1
            elif ev.kind == "kill" and alive[ev.device]:
                alive[ev.device] = False
                lost_res[ev.device] = sorted(res_sets[ev.device])
                stores[ev.device] = {}
                res_sets[ev.device] = set()
                stats.n_kills += 1
                victims.append(ev.device)
        if victims:
            if not any(alive):
                raise RuntimeError("all devices dead: unrecoverable")
            on_kills(victims, [i for i in range(P) if not alive[i]])
        # compute everything due by this round (incl. recovery recompute)
        for p in all_pairs:
            if p in partials or pair_round(p) > rnd:
                continue
            o = owner_map[p]
            assert alive[o], (p, o)
            bx = get_block(o, p[0])
            by = get_block(o, p[1])
            t0 = time.perf_counter()
            partials[p] = workload.pair_partial(p[0], p[1], bx, by)
            sync()
            dt = time.perf_counter() - t0
            computed_by[p] = o
            stats.pairs_by_device[o] = stats.pairs_by_device.get(o, 0) + 1
            # virtual cost: the pair's item count, times the device's
            # slowdown (deterministic)
            cost = float(bx.shape[0] * by.shape[0]) * slow[o]
            stats.busy_by_device[o] = stats.busy_by_device.get(o, 0.0) + cost
            stats.busy_s_by_device[o] = (
                stats.busy_s_by_device.get(o, 0.0) + dt * slow[o])
        stats.rounds += 1
        if ckpt_dir is not None and (rnd + 1) % every == 0:
            with phase("checkpoint"):
                tree: Dict[str, Any] = {
                    "round": np.int64(rnd + 1),
                    "blocks": {str(b): workload.blocks[b]
                               for b in range(P)},
                }
                if partials:
                    tree["partials"] = {
                        f"{p[0]}_{p[1]}": workload.encode_partial(v)
                        for p, v in partials.items()}
                save_checkpoint(ckpt_dir, rnd + 1, tree)
            durable = set(partials)
            stats.n_checkpoints += 1
            if tr:
                tr.count("ckpt.saves")
        if tr:
            tr.record("faults.round", time.perf_counter() - rnd_t0,
                      round=rnd, mode=mode, placement=plc.name, P=P,
                      kills=len(victims))

    assert len(partials) == len(all_pairs)
    return workload.fold(partials), stats


# ---------------------------------------------------------------------------
# Chaos selfcheck
# ---------------------------------------------------------------------------

def _chaos_placements(P: int) -> List[Placement]:
    return [get_placement(name, P)
            for name, cls in sorted(registered_placements().items())
            if cls.supports(P)]


def chaos_selfcheck(Ps: Sequence[int] = CHAOS_P,
                    modes: Sequence[str] = ENGINE_MODES,
                    placements: Optional[Sequence[str]] = None,
                    kill_every: Optional[int] = None,
                    seed: Optional[int] = None,
                    verbose: bool = True, device=None) -> int:
    """The chaos check (DESIGN.md section 13), on the CUDA device unless
    ``device`` says otherwise: for every registered placement x engine
    mode x P in ``Ps`` and the three workloads, kill a random live device
    every ``kill_every`` rounds (default ``REPRO_FAULT_KILL_EVERY``, else
    2; seed ``REPRO_FAULT_SEED``, else 0) with drops and slowdowns mixed
    in, and assert: the faulted output is bit-identical to the fault-free
    run, the fault-free run matches the brute-force oracle, and the
    planned kills fired.  Returns the number of faulted cases."""
    device = resolve_device(device)
    if kill_every is None:
        val = env_mod.read_knob("REPRO_FAULT_KILL_EVERY")
        kill_every = 2 if val is None else int(val)
    if seed is None:
        val = env_mod.read_knob("REPRO_FAULT_SEED")
        seed = 0 if val is None else int(val)
    n_cases = 0
    for P in Ps:
        for plc in _chaos_placements(P):
            if placements is not None and plc.name not in placements:
                continue
            for wl_cls in WORKLOADS:
                wl = wl_cls(P, seed=seed, device=device)
                baseline, base_stats = run_fault_tolerant_sweep(
                    wl, plc, "batched", plan=None)
                assert base_stats.n_kills == 0
                wl.check_oracle(baseline)
                for mode in modes:
                    n_rounds = len(sweep_rounds(plc.schedule(), mode))
                    fplan = FaultPlan.random_kills(
                        P, n_rounds, every=kill_every,
                        seed=seed + 7 * P + len(mode))
                    with tempfile.TemporaryDirectory() as d:
                        out, stats = run_fault_tolerant_sweep(
                            wl, plc, mode, fplan,
                            ckpt_dir=str(Path(d) / "ckpt"))
                    assert stats.n_kills == fplan.n_kills, (
                        plc.name, P, mode, wl.name)
                    assert wl.equal(out, baseline), (
                        plc.name, P, mode, wl.name)
                    n_cases += 1
                    if verbose:
                        print(f"  chaos {wl.name:6s} {plc.name:10s} "
                              f"P={P:<3d} {mode:7s}: kills="
                              f"{stats.n_kills} reassigned="
                              f"{stats.n_reassigned} rerepl="
                              f"{stats.n_rereplicated} restores="
                              f"{stats.n_restores} bit-exact OK")
    if verbose:
        print(f"chaos selfcheck OK ({n_cases} faulted cases, "
              f"P in {tuple(Ps)})")
    return n_cases


def _main(argv: Optional[Sequence[str]] = None) -> int:
    """CLI: ``python -m repro_torch.core.faults [--P 5 8] [--modes scan]
    [--placements cyclic] [--kill-every 2] [--seed 0] [--quiet]
    [--device cpu]``."""
    import argparse
    ap = argparse.ArgumentParser(
        description="chaos selfcheck: fault-injected sweeps must be "
                    "bit-exact vs fault-free runs")
    ap.add_argument("--P", type=int, nargs="*", default=list(CHAOS_P))
    ap.add_argument("--modes", nargs="*", default=list(ENGINE_MODES),
                    choices=list(ENGINE_MODES))
    ap.add_argument("--placements", nargs="*", default=None)
    ap.add_argument("--kill-every", type=int, default=None)
    ap.add_argument("--seed", type=int, default=None)
    ap.add_argument("--quiet", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    args = ap.parse_args(argv)
    chaos_selfcheck(Ps=args.P, modes=args.modes,
                    placements=args.placements,
                    kill_every=args.kill_every, seed=args.seed,
                    verbose=not args.quiet, device=args.device)
    return 0


if __name__ == "__main__":  # pragma: no cover
    raise SystemExit(_main())
