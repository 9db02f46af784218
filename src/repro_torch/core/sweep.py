"""The pair-sweep runtime of the port: schedule -> gather -> pair compute
-> emit, over the comm layer.

Port of ``repro/core/sweep.py`` (DESIGN.md section 12).  Every per-device
tensor carries a leading axis over the devices this process holds
(:mod:`repro_torch.core.comm`: all P in one process, or one per rank), so
the gathered quorum stack is ``[L, k, block, ...]`` (``L =
len(comm.local)``; written ``[P, ...]`` below, as in one process) and a
pair's compute runs for all L devices at once:

  * data plane — :func:`quorum_gather` pulls the k resident blocks with
    k-1 cyclic shifts; :func:`quorum_scatter` routes per-slot partials back
    to the block owners with the inverse shifts and folds them under a
    caller-chosen monoid.  Payloads may be tuples / lists / dicts of
    tensors.
  * execution modes — ``batched`` (one step over every work item),
    ``overlap`` (each item computes at its ready slot, each slot is
    scattered on its own), ``scan`` (one item at a time, the low-memory
    oracle); :func:`select_mode` is the ``mode="auto"`` heuristic and
    :func:`validate_mode` the argument contract, as in the reference.
  * emitter protocol — :class:`SweepEmitter`, run under any mode by
    :func:`pair_sweep`.

``mark_varying`` is the identity: there is no varying-axis tracking
outside ``shard_map``.
"""

from __future__ import annotations

import abc
from typing import Any, Callable, List, Sequence, Tuple

import numpy as np
import torch

from ..kernels.ref import IDX_SENTINEL, NEG_INF
from ..kernels.ref import sort_by_score_index as _sort2
from ..kernels.ref import topk_by_score_index
from ..obs import trace as obs_trace
from . import env as env_mod
from .comm import Comm, tree_map
from .scheduler import PairSchedule

__all__ = [
    "agreed",
    "ENGINE_MODES",
    "SweepEmitter",
    "pair_sweep",
    "slot_items",
    "ready_order",
    "pair_ready_order",
    "sweep_rounds",
    "quorum_gather",
    "quorum_scatter",
    "pair_mask_table",
    "mark_varying",
    "auto_batch_bytes",
    "env_mode_override",
    "validate_mode",
    "select_mode",
    "resolve_sweep_placement",
    "topk_by_score",
    "merge_topk",
]

ENGINE_MODES = ("batched", "overlap", "scan")

# auto-mode switches away from `batched` when the workload's working set
# (bytes per device) would exceed this budget (REPRO_BATCH_BYTES_LIMIT)
_DEFAULT_BATCH_BYTES = 1 << 28


def auto_batch_bytes() -> int:
    """The auto-mode byte budget, read from ``REPRO_BATCH_BYTES_LIMIT`` at
    selection time (DESIGN.md section 4)."""
    val = env_mod.read_knob("REPRO_BATCH_BYTES_LIMIT")
    return _DEFAULT_BATCH_BYTES if val is None else int(val)


def env_mode_override() -> str | None:
    """The validated ``REPRO_ALLPAIRS_MODE`` forced mode, or None if unset
    (one environment steers both packages)."""
    return env_mod.read_knob("REPRO_ALLPAIRS_MODE")


def validate_mode(mode: str, batch_fn) -> None:
    """The shared mode/kernel argument contract (DESIGN.md section 12.1):
    ``mode`` must be an engine mode or ``auto``, and a fused ``batch_fn``
    only replaces the batched inner step."""
    if mode not in ENGINE_MODES + ("auto",):
        raise ValueError(f"mode must be one of {ENGINE_MODES + ('auto',)}, "
                         f"got {mode!r}")
    if batch_fn is not None and mode not in ("batched", "auto"):
        raise ValueError(
            f"batch_fn only replaces the batched inner step (got "
            f"mode={mode!r}); drop it or use mode='batched'")


def select_mode(schedule: PairSchedule, working_set_bytes: int,
                batch_fn) -> str:
    """The single ``mode="auto"`` heuristic (DESIGN.md sections 4, 12.1):
    the environment override first (conflicting with a fused ``batch_fn``
    raises), then ``batched`` for a fused kernel or while the per-device
    working set fits :func:`auto_batch_bytes`, ``overlap`` when k >= 3,
    ``scan`` as the low-memory last resort."""
    env = env_mode_override()
    if env is not None:
        if batch_fn is not None and env != "batched":
            raise ValueError(
                f"REPRO_ALLPAIRS_MODE={env} conflicts with a fused batch_fn "
                "(the kernel only replaces the batched inner step)")
        return env
    if batch_fn is not None:
        return "batched"
    if working_set_bytes <= auto_batch_bytes():
        return "batched"
    if schedule.k >= 3:
        return "overlap"
    return "scan"


def resolve_sweep_placement(schedule, axis_size, placement):
    """Validate P-consistency of ``schedule`` / ``axis_size`` /
    ``placement``; with neither schedule nor placement, consult
    ``REPRO_PLACEMENT`` at ``axis_size``.  Returns ``(schedule,
    placement)`` (DESIGN.md sections 10, 12.1)."""
    if placement is not None:
        if axis_size is not None and placement.P != axis_size:
            raise ValueError(
                f"placement is for P={placement.P} but axis_size={axis_size}")
        if schedule is not None and schedule.P != placement.P:
            raise ValueError(
                f"placement is for P={placement.P} but schedule.P="
                f"{schedule.P}")
    if schedule is not None and axis_size is not None \
            and schedule.P != axis_size:
        raise ValueError(f"schedule is for P={schedule.P} but "
                         f"axis_size={axis_size}")
    if placement is None and schedule is None:
        if axis_size is None:
            raise ValueError("need schedule, placement, or axis_size")
        from .placement import placement_from_env
        placement = placement_from_env(axis_size)
    return schedule, placement


# ---------------------------------------------------------------------------
# Data plane: cyclic-shift gather / scatter, masks (DESIGN.md section 2)
# ---------------------------------------------------------------------------

def _leaves(tree) -> list:
    out: list = []
    tree_map(out.append, tree)
    return out


def _device_nbytes(tree) -> int:
    """Payload bytes per device of a pytree whose leaves carry the leading
    per-device axis (divided by its length, not by the global P)."""
    leaves = _leaves(tree)
    return sum(obs_trace.nbytes_of(leaf) for leaf in leaves) \
        // leaves[0].shape[0]


def quorum_gather(x, schedule: PairSchedule, comm: Comm,
                  *, overlap_fn: Callable[[int, Any], Any] | None = None):
    """Gather every device's quorum blocks (DESIGN.md section 2, phase 1).

    ``x``: the blocks ``[P, block, ...]`` (device i holds block i), or a
    pytree of them — every leaf rides the same shifts.  Returns the stacked
    quorum ``[P, k, block, ...]``: slot s of device i holds global block
    ``(i + shifts[s]) % P``.  With ``overlap_fn(slot, blk)``, calls it as
    each ``[P, block, ...]`` slot lands and returns the list of its
    results instead.
    """
    P = schedule.P
    shifts = [int(s) for s in schedule.shifts]
    tr = obs_trace.get_tracer()
    if tr:
        nz = sum(1 for a in shifts if a % P != 0)
        tr.count("comm.ppermute.gather_hops", nz)
        tr.count("comm.ppermute.gather_bytes", nz * _device_nbytes(x))
    span = tr.span("sweep.gather", P=P, k=len(shifts)) if tr \
        else obs_trace.NOOP.span("")
    with span:
        blocks, results = [], []
        for slot, a in enumerate(shifts):
            blk = x if a == 0 else tree_map(
                lambda leaf, a=a: comm.ppermute(leaf, a), x)
            if overlap_fn is not None:
                results.append(overlap_fn(slot, blk))
            else:
                blocks.append(blk)
        if overlap_fn is not None:
            return results
        return tree_map(lambda *leaves: torch.stack(leaves, dim=1), *blocks)


def quorum_scatter(partials, schedule: PairSchedule, comm: Comm,
                   *, reduce_fn: Callable[[Any, Any], Any] = torch.add):
    """Route per-slot partials back to the block owners and reduce
    (DESIGN.md section 2, phase 3).

    ``partials``: a stacked ``[P, k, block, ...]`` tensor, or a length-k
    sequence of per-slot ``[P, block, ...]`` partials (each may be a
    pytree); slot s of device i is a partial for global block
    ``(i + shifts[s]) % P``.  Each slot is shifted home on its own and the
    arrivals fold with ``reduce_fn`` (default: sum).  Returns the reduced
    ``[P, block, ...]`` result, device i's row for block i.
    """
    P = schedule.P
    shifts = [int(s) for s in schedule.shifts]
    tr = obs_trace.get_tracer()
    span = tr.span("sweep.scatter", P=P, k=len(shifts)) if tr \
        else obs_trace.NOOP.span("")
    with span:
        acc = None
        for slot, a in enumerate(shifts):
            part = partials[:, slot] if isinstance(partials, torch.Tensor) \
                else partials[slot]
            if a == 0:
                arrived = part
            else:
                if tr:
                    tr.count("comm.ppermute.scatter_hops")
                    tr.count("comm.ppermute.scatter_bytes",
                             _device_nbytes(part))
                arrived = tree_map(lambda leaf: comm.ppermute(leaf, -a), part)
            acc = arrived if acc is None else reduce_fn(acc, arrived)
        return acc


def pair_mask_table(schedule: PairSchedule) -> np.ndarray:
    """[P, n_pairs] float mask deduplicating the d = P/2 orbit for even P
    (DESIGN.md section 3.2): of the two devices generating each such pair,
    the one whose lower endpoint is the orbit's canonical (smaller) block
    keeps it.  All other entries are 1."""
    P, n = schedule.P, schedule.n_pairs
    mask = np.ones((P, n), dtype=np.float32)
    if P % 2 == 0 and P > 1:
        d_half = P // 2
        idx = np.nonzero(schedule.pair_diff == d_half)[0]
        if idx.size:
            s = int(idx[0])
            a_lo = int(schedule.shifts[schedule.pair_slots[s, 0]])
            for i in range(P):
                lo = (i + a_lo) % P
                hi = (lo + d_half) % P
                mask[i, s] = 1.0 if lo == min(lo, hi) else 0.0
    return mask


def agreed(comm: Comm, values, what: str):
    """``values`` (an int or a sequence of ints), figures every process
    computes from the same inputs (SPMD), checked equal on every process
    (gathered through ``comm.all_rows``) before they act on them
    together; a disagreement raises instead of letting the processes
    issue different collectives."""
    row = torch.as_tensor(values, dtype=torch.int64).reshape(1, -1)
    got = comm.all_rows(row.to(comm.device)).cpu()
    if not bool((got == got[0]).all()):
        raise RuntimeError(f"the processes disagree on {what}: "
                           f"{got.tolist()}")
    return values


def mark_varying(x, *_):
    """The identity: outside ``shard_map`` nothing tracks which values vary
    over the device axis (kept so the reference's call sites port as
    they are)."""
    return x


# ---------------------------------------------------------------------------
# Work items (DESIGN.md section 12.1)
# ---------------------------------------------------------------------------

def ready_order(lo: Sequence[int], hi: Sequence[int],
                k: int) -> List[List[int]]:
    """Work items grouped by *ready slot* for the overlap mode: an item on
    slots (lo, hi) can compute once slot max(lo, hi) has landed."""
    out: List[List[int]] = [[] for _ in range(k)]
    for idx in range(len(lo)):
        out[max(int(lo[idx]), int(hi[idx]))].append(idx)
    return out


def pair_ready_order(schedule: PairSchedule) -> list[list[int]]:
    """:func:`ready_order` over the schedule's slot pairs."""
    return ready_order(schedule.pair_slots[:, 0], schedule.pair_slots[:, 1],
                       schedule.k)


def sweep_rounds(schedule: PairSchedule, mode: str) -> List[List[int]]:
    """Pair indices grouped into the mode's synchronization rounds
    (DESIGN.md section 13): one round for ``batched``, the non-empty
    ready-slot groups for ``overlap``, one pair per round for ``scan``."""
    if mode not in ENGINE_MODES:
        raise ValueError(f"mode must be one of {ENGINE_MODES}, got {mode!r}")
    n = schedule.n_pairs
    if mode == "batched":
        return [list(range(n))] if n else []
    if mode == "scan":
        return [[i] for i in range(n)]
    return [grp for grp in pair_ready_order(schedule) if grp]


def slot_items(k: int) -> Tuple[np.ndarray, np.ndarray]:
    """The per-slot work-item list (``lo == hi == arange(k)``) of emitters
    that sweep a resident stack slot by slot (the serving engines)."""
    slots = np.arange(k, dtype=np.int32)
    return slots, slots


# ---------------------------------------------------------------------------
# Emitter protocol + driver (DESIGN.md section 12.1)
# ---------------------------------------------------------------------------

class SweepEmitter(abc.ABC):
    """The workload plug-in seam of the pair-sweep runtime.

    An emitter owns the per-item compute and the carry it folds results
    into; :func:`pair_sweep` owns mode dispatch and the data plane.  Every
    tensor it sees carries the leading ``[P]`` device axis.  Per mode:

      * ``batched`` — :meth:`prepare`, then :meth:`batch` computes every
        item in one step (through ``self.batch_fn`` when a fused kernel is
        attached);
      * ``scan`` — :meth:`prepare`, then :meth:`scan_emit` folds the items
        of :meth:`scan_items` one at a time into :meth:`scan_init`'s carry,
        then :meth:`scan_finalize`;
      * ``overlap`` — :meth:`overlap_begin` builds a state object,
        :meth:`overlap_slot` sees each slot as it lands,
        :meth:`overlap_emit` runs each item at its ready slot, and
        :meth:`overlap_finalize` folds the state into the output.

    All three modes give the same result (to float tolerance).
    """

    #: optional fused-kernel hook replacing the batched inner step
    batch_fn = None

    def items(self) -> Tuple[np.ndarray, np.ndarray]:
        """(lo, hi) slot indices of each work item — by default the
        schedule's per-difference slot pairs."""
        return (self.schedule.pair_slots[:, 0],
                self.schedule.pair_slots[:, 1])

    def prepare(self, quorum) -> None:
        """Optional hook run after the gather in batched / scan modes."""

    @abc.abstractmethod
    def batch(self, quorum):
        """Compute every work item in one step over the gathered
        ``[P, k, block, ...]`` stack; returns the sweep output."""

    @abc.abstractmethod
    def scan_init(self):
        """The carry the serial sweep starts from."""

    @abc.abstractmethod
    def scan_items(self):
        """Per-item arrays (leading axis = item) the serial sweep walks."""

    @abc.abstractmethod
    def scan_emit(self, carry, quorum, item):
        """Fold one work item into the carry."""

    def scan_finalize(self, carry):
        """Turn the final carry into the sweep output (default: itself)."""
        return carry

    @abc.abstractmethod
    def overlap_begin(self):
        """Build the state object the overlap sweep mutates."""

    def overlap_slot(self, state, slot: int, blk) -> None:
        """Optional hook observing each ``[P, block, ...]`` slot as it
        lands."""

    @abc.abstractmethod
    def overlap_emit(self, state, idx: int, bi, bj) -> None:
        """Run work item ``idx`` on its two landed slots, folding the
        result into ``state``."""

    @abc.abstractmethod
    def overlap_finalize(self, state):
        """Fold the overlap state into the sweep output."""

    # -- delta maintenance (DESIGN.md section 16) -------------------------
    # Patch rules over *standing* (folded) outputs, consumed by
    # core/delta.py's DeltaIndex: retract a dirty tile's stale
    # contribution, fold its fresh one.  Static, so a caller uses them
    # without building an emitter; they act on tensors.

    @staticmethod
    def delta_retract(standing, stale, ctx=None):
        """Remove a stale contribution from a standing output.  Emitters
        with an invertible (or patchable) output monoid override this;
        the base protocol has no delta rule."""
        raise NotImplementedError(
            "this emitter does not support delta maintenance "
            "(no delta_retract rule; see DESIGN.md section 16)")

    @staticmethod
    def delta_fold(standing, fresh, ctx=None):
        """Fold a fresh contribution into a standing output.  Emitters
        with a delta-maintainable output monoid override this; the base
        protocol has no delta rule."""
        raise NotImplementedError(
            "this emitter does not support delta maintenance "
            "(no delta_fold rule; see DESIGN.md section 16)")


def pair_sweep(emitter: SweepEmitter, *, schedule: PairSchedule,
               comm: Comm, mode: str, x=None, stack=None):
    """Run one emitter over the schedule under a concrete engine mode —
    the single home of the schedule -> gather -> pair-compute -> emit
    loop.  Exactly one of ``x`` (``[P, block, ...]`` blocks, gathered here)
    or ``stack`` (an already-resident ``[P, k, block, ...]`` stack) is
    given.  Returns whatever the emitter's finalize step produces."""
    tr = obs_trace.get_tracer()
    if not tr:
        return _pair_sweep_impl(emitter, schedule=schedule, comm=comm,
                                mode=mode, x=x, stack=stack)
    lo, _hi = emitter.items()
    with tr.span("sweep.pair_compute", mode=mode, P=schedule.P,
                 k=schedule.k, n_items=int(len(lo))):
        tr.count("sweep.pair_tiles", int(len(lo)))
        return _pair_sweep_impl(emitter, schedule=schedule, comm=comm,
                                mode=mode, x=x, stack=stack)


def _pair_sweep_impl(emitter: SweepEmitter, *, schedule: PairSchedule,
                     comm: Comm, mode: str, x=None, stack=None):
    if (x is None) == (stack is None):
        raise ValueError("need exactly one of x / stack")
    if mode not in ENGINE_MODES:
        raise ValueError(f"mode must be one of {ENGINE_MODES}, got {mode!r}")
    if mode == "overlap":
        lo, hi = emitter.items()
        ready = ready_order(lo, hi, schedule.k)
        state = emitter.overlap_begin()
        landed: list = []

        def on_land(slot: int, blk) -> None:
            landed.append(blk)
            emitter.overlap_slot(state, slot, blk)
            for idx in ready[slot]:
                emitter.overlap_emit(state, idx, landed[int(lo[idx])],
                                     landed[int(hi[idx])])

        if stack is None:
            quorum_gather(x, schedule, comm, overlap_fn=on_land)
        else:
            for slot in range(schedule.k):
                on_land(slot, tree_map(lambda leaf: leaf[:, slot], stack))
        return emitter.overlap_finalize(state)

    quorum = stack if stack is not None else quorum_gather(x, schedule, comm)
    emitter.prepare(quorum)
    if mode == "batched":
        return emitter.batch(quorum)
    items = emitter.scan_items()
    carry = emitter.scan_init()
    for t in range(len(_leaves(items)[0])):
        carry = emitter.scan_emit(carry, quorum,
                                  tree_map(lambda a: a[t], items))
    return emitter.scan_finalize(carry)


# ---------------------------------------------------------------------------
# Shared top-k selection monoid (DESIGN.md sections 9.2, 12.2)
# ---------------------------------------------------------------------------

def topk_by_score(vals: torch.Tensor, idx: torch.Tensor, topk: int):
    """Top-k along the last axis by the (-score, index) total order; pads
    with (NEG_INF, IDX_SENTINEL) when there are fewer than ``topk``
    candidates."""
    n = vals.shape[-1]
    idx = idx.to(torch.int32)
    if n < topk:
        pad = (0, topk - n)
        vals = torch.nn.functional.pad(vals, pad, value=NEG_INF)
        idx = torch.nn.functional.pad(idx, pad, value=IDX_SENTINEL)
    return topk_by_score_index(vals, idx, topk)


def merge_topk(va, ia, vb, ib, topk: int):
    """Merge two candidate lists under the (-score, index) order,
    demoting repeated (score, index) copies to sentinels — the associative,
    commutative monoid of the k-NN scatter (DESIGN.md section 9.2)."""
    vals = torch.cat([va, vb], dim=-1)
    idx = torch.cat([ia, ib], dim=-1).to(torch.int32)
    sv, si = _sort2(-vals, idx)
    dup = torch.cat(
        [torch.zeros_like(si[..., :1], dtype=torch.bool),
         (si[..., 1:] == si[..., :-1]) & (sv[..., 1:] == sv[..., :-1])],
        dim=-1)
    sv = torch.where(dup, torch.full_like(sv, -NEG_INF), sv)
    si = torch.where(dup, torch.full_like(si, IDX_SENTINEL), si)
    sv, si = _sort2(sv, si)
    return -sv[..., :topk], si[..., :topk]
