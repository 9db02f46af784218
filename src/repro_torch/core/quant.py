"""Quantized int8 / bf16 scoring with error-bounded exact rescoring
(counterpart of ``repro/core/quant.py``, DESIGN.md section 17).

Each quorum block is stored int8 (per-block symmetric scale) or bf16, which
shrinks the resident bytes per device and the gather payload, while every
workload still returns the f32 answer through a certified error bound and
an exact rescoring pass:

  * :func:`quantize_corpus` builds a :class:`QuantizedCorpus` — the codes
    plus the per-block ``scale`` / ``delta`` and per-row ``l1`` / ``sq``
    side arrays, which ride ``quorum_gather`` / ``quorum_scatter`` with
    the codes as one :class:`QuantBlocks` tuple.
  * The quantized tile score obeys ``|score_q - score_f32| <= eps(i, j)``
    (``kernels/ref.py:quant_eps_tile``; DESIGN.md section 17.2), for dot
    and, through the exact stored ``sq`` norms, for l2.
  * :func:`quant_similarity_join` emits the widened band ``score_q >=
    threshold - eps`` (kernel B7) and rescores every emitted pair in f32;
    :func:`quant_knn_graph` (kernel B8) and :func:`serving_query` keep
    quantized top-M lists, certify the k-th / M-th margin against the
    bound, double M until every row is certified, and rescore the
    candidates.  All three match their f32 oracles.

The reference rescores and certifies on the host, row by row; the port
does both on the device, vectorised over the pending rows, with the same
rule.  The f32 rows it rescores come from :class:`RescoreRows`: in one
process the padded corpus stays on the device; a rank of
``DistributedComm`` keeps it on the host and moves only the rows each
pass rescores, so its device holds its quantized quorum and no f32
corpus.  Decisions every device must share (escalation, another M pass)
read every device's figures through ``comm.all_rows``.  ``REPRO_QUANT``
(core/env.py) selects the mode (``off`` / ``int8`` / ``bf16``) wherever a
workload's ``quant=None`` defers to the environment.  Every per-device
tensor carries the comm layer's leading axis over the L devices this
process holds (L = P in one process, 1 a rank; written ``[P, ...]``
below, as in one process).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, NamedTuple, Optional, Sequence

import numpy as np
import torch

from ..kernels import ref as kref
from ..kernels.ref import FP_REL, IDX_SENTINEL, NEG_INF, QUERY_METRICS
from . import env as env_mod
from . import sweep as sweep_mod
from .comm import (Comm, DistributedComm, SingleProcessComm, pad_blocks,
                   run_main)
from .knn import (KNN_METRICS, KnnEmitter, KnnResult, _merge_lists,
                  local_row_span)
from .scheduler import PairSchedule
from .sparse import (JOIN_METRICS, MAX_ROWS_F32_EXACT, JoinResult,
                     SparseHits, ThresholdJoinEmitter, _pair_meta,
                     default_capacity)
from .sweep import (ENGINE_MODES, agreed, pair_mask_table, quorum_gather,
                    quorum_scatter)
from ..serving.cover import build_cover
from ..serving.engine import (QueryTopKEmitter, _query_geometry,
                              quantize_pow2, tree_merge_topk)

__all__ = [
    "QUANT_DTYPES",
    "QuantBlocks",
    "QuantizedCorpus",
    "quant_from_env",
    "quantize_corpus",
    "quant_itemsize",
    "corpus_bytes_per_device",
    "eps_pairs",
    "eps_rows_upper",
    "eps_queries",
    "QuantThresholdEmitter",
    "QuantKnnEmitter",
    "QuantQueryEmitter",
    "quorum_allpairs_threshold_q",
    "quorum_allpairs_knn_q",
    "quorum_query_topk_q",
    "quant_similarity_join",
    "quant_knn_graph",
    "QuantServing",
    "RescoreRows",
    "serving_query",
]

#: the quantized storage modes (``REPRO_QUANT`` minus ``off``)
QUANT_DTYPES = ("int8", "bf16")

# elements of the [rows, M, d] candidate gather per rescoring chunk
_RESCORE_ELEMS = 1 << 27


class QuantBlocks(NamedTuple):
    """The quantized working set as one tuple: the unit ``quorum_gather``
    stacks leaf by leaf, so the side arrays ride the codes' shifts.  Per
    device (leading ``[P]`` axis; ``[P, k, ...]`` once gathered):

    q     : [block, d] codes (int8 or bfloat16)
    scale : [] float32 per-block dequant scale (1.0 for bf16)
    delta : [] float32 per-block worst-case elementwise error
    l1    : [block] float32 L1 norms of the ORIGINAL rows
    sq    : [block] float32 exact squared L2 norms of the original rows
    """

    q: torch.Tensor
    scale: torch.Tensor
    delta: torch.Tensor
    l1: torch.Tensor
    sq: torch.Tensor


def quant_from_env() -> str:
    """The ``REPRO_QUANT`` value, ``"off"`` when unset — consulted by
    every workload whose ``quant=None`` defers to the environment."""
    val = env_mod.read_knob("REPRO_QUANT")
    return "off" if val is None else str(val)


def quant_itemsize(mode: str) -> int:
    """Bytes per stored element: 1 for int8, 2 for bf16, 4 for ``off``."""
    sizes = {"int8": 1, "bf16": 2, "off": 4}
    if mode not in sizes:
        raise ValueError(f"quant mode must be one of {('off',) + QUANT_DTYPES}"
                         f", got {mode!r}")
    return sizes[mode]


def _check_quant(mode: str) -> None:
    if mode not in QUANT_DTYPES:
        raise ValueError(f"quant must be one of {QUANT_DTYPES}, got {mode!r}")


def row_sum(t: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis in numpy's pairwise order (``np.add.reduce``
    on a contiguous float32 row: eight running lanes per 128-wide leaf,
    halves above that), so the port's row norms equal the reference's
    element for element on any device."""
    n = t.shape[-1]
    if n > 128:
        half = n // 2
        half -= half % 8
        return row_sum(t[..., :half]) + row_sum(t[..., half:])
    if n < 8:
        res = torch.zeros(t.shape[:-1], dtype=t.dtype, device=t.device)
        for i in range(n):
            res = res + t[..., i]
        return res
    m = n - n % 8
    r = t[..., :8]
    for i in range(8, m, 8):
        r = r + t[..., i:i + 8]
    res = (((r[..., 0] + r[..., 1]) + (r[..., 2] + r[..., 3]))
           + ((r[..., 4] + r[..., 5]) + (r[..., 6] + r[..., 7])))
    for i in range(m, n):
        res = res + t[..., i]
    return res


@dataclasses.dataclass(frozen=True)
class QuantizedCorpus:
    """A quantized corpus (:func:`quantize_corpus`), on the device of the
    rows it was made from.

    ``q`` is the [nblocks * block, d] code matrix (int8 or bfloat16),
    ``scale`` / ``delta`` the [nblocks] float32 per-block dequant scales and
    elementwise error bounds, ``l1`` / ``sq`` the [nblocks * block] float32
    L1 norms and exact squared norms of the *original* rows.
    """

    mode: str
    q: torch.Tensor
    scale: torch.Tensor
    delta: torch.Tensor
    l1: torch.Tensor
    sq: torch.Tensor
    block: int
    n_valid: int

    def blocks(self) -> QuantBlocks:
        """The per-device :class:`QuantBlocks` (device i holds block i)."""
        P = self.scale.shape[0]
        return QuantBlocks(q=self.q.reshape(P, self.block, -1),
                           scale=self.scale, delta=self.delta,
                           l1=self.l1.reshape(P, self.block),
                           sq=self.sq.reshape(P, self.block))


def quantize_corpus(x, nblocks: int, block: int,
                    mode: str) -> QuantizedCorpus:
    """Quantize a padded [nblocks * block, d] float32 matrix (numpy or
    tensor; the result stays on its device) per block, as the reference
    does element for element (DESIGN.md section 17.1).

    int8: ``scale = maxabs / 127``, ``q = clip(round_half_even(x / scale),
    -127, 127)``, ``delta = scale / 2``; all-zero blocks (padding) get
    scale 1 and delta 0.  bf16: the round-to-nearest-even cast, ``scale =
    1``, ``delta = maxabs * 2^-8``.  ``l1`` / ``sq`` are the original
    rows' norms, summed in numpy's order (:func:`row_sum`).
    """
    _check_quant(mode)
    x = torch.as_tensor(x, dtype=torch.float32)
    total, d = x.shape
    if total != nblocks * block:
        raise ValueError(f"expected [{nblocks * block}, d] padded rows, got "
                         f"{tuple(x.shape)}")
    xb = x.reshape(nblocks, block, d)
    maxabs = xb.abs().amax(dim=(1, 2))                       # [nblocks]
    one = torch.ones_like(maxabs)
    if mode == "int8":
        scale = torch.where(maxabs > 0, maxabs / 127.0, one)
        q = torch.clamp(torch.round(xb / scale[:, None, None]), -127, 127)
        q = q.to(torch.int8).reshape(total, d)
        delta = torch.where(maxabs > 0, scale / 2.0, torch.zeros_like(one))
    else:
        q = x.to(torch.bfloat16)
        scale = one
        delta = maxabs * np.float32(2.0 ** -8)
    return QuantizedCorpus(mode=mode, q=q, scale=scale, delta=delta,
                           l1=row_sum(x.abs()), sq=row_sum(x * x),
                           block=block, n_valid=total)


def corpus_bytes_per_device(N: int, d: int, P: int, k: int,
                            mode: str) -> int:
    """Resident working-set bytes per device for an N x d corpus in P
    blocks with k resident slots (DESIGN.md section 17.1): ``k * block * d
    * 4`` for f32 (``off``); quantized, each block adds its codes plus
    the side arrays that ride the gather, ``k * (block * d * itemsize + 8
    + 8 * block)``."""
    block = -(-N // P)
    if mode == "off":
        return k * block * d * 4
    return k * (block * d * quant_itemsize(mode) + 8 + 8 * block)


# ---------------------------------------------------------------------------
# Certified error bounds (DESIGN.md section 17.2), in float64
# ---------------------------------------------------------------------------

def _eps_terms(delta_r, l1_r, delta_c, l1_c, dim: int):
    # quantization cross terms plus the f32 accumulation allowance
    return (delta_r * l1_c + delta_c * l1_r
            + 3.0 * dim * delta_r * delta_c
            + FP_REL * (l1_r * l1_c + 1.0))


def eps_pairs(qc: QuantizedCorpus, ai, aj, metric: str) -> torch.Tensor:
    """Per-pair bound ``|score_q(i, j) - score_f32(i, j)| <= eps`` for
    global row-id vectors ``ai`` / ``aj`` — the twin of
    ``kernels/ref.py:quant_eps_tile``; l2 doubles it.  float64."""
    ai = torch.as_tensor(ai, device=qc.l1.device).long()
    aj = torch.as_tensor(aj, device=qc.l1.device).long()
    return _eps_pair_rows(qc.delta.double(), qc.block, qc.q.shape[1], ai,
                          qc.l1[ai], aj, qc.l1[aj], metric)


def _eps_pair_rows(delta, block: int, dim: int, ai, l1_i, aj, l1_j,
                   metric: str) -> torch.Tensor:
    """:func:`eps_pairs` from every block's float64 ``delta`` and the two
    rows' L1 norms."""
    # float64 deltas against float32 norms, promoting as the reference's
    # numpy does (the FP_REL term stays float32)
    eps = _eps_terms(delta[ai // block], l1_i, delta[aj // block], l1_j, dim)
    return 2.0 * eps if metric == "l2" else eps


def eps_rows_upper(qc: QuantizedCorpus, metric: str,
                   n: Optional[int] = None,
                   maxima: Optional[tuple] = None) -> torch.Tensor:
    """Per-row bound over *any* partner row (the k-NN certification
    margin): the partner's delta and L1 norm are the corpus maxima, which
    is safe because all-zero padding blocks carry delta 0 and l1 0.
    float64 [n], for the first n rows of ``qc``.  ``maxima`` gives
    (max_l1, max_delta) where ``qc`` holds only some devices' blocks
    (:func:`corpus_maxima`)."""
    n = qc.n_valid if n is None else int(n)
    dim = qc.q.shape[1]
    if maxima is None:
        max_l1 = float(qc.l1[:n].max()) if n else 0.0
        max_delta = float(qc.delta.max())
    else:
        max_l1, max_delta = maxima
    bi = torch.arange(n, device=qc.l1.device) // qc.block
    eps = _eps_terms(qc.delta.double()[bi], qc.l1[:n].double(), max_delta,
                     max_l1, dim)
    return 2.0 * eps if metric == "l2" else eps


def eps_queries(qc: QuantizedCorpus, queries, metric: str,
                n: Optional[int] = None,
                maxima: Optional[tuple] = None) -> torch.Tensor:
    """Per-query bound for f32 queries against the quantized corpus (only
    the corpus side is quantized): ``max_delta * |q|_1 + FP_REL * (|q|_1 *
    max_l1 + 1)``, l2 doubled.  float64 [Q].  ``maxima`` gives (max_l1,
    max_delta) where ``qc`` holds only some devices' blocks
    (:func:`corpus_maxima`)."""
    n = qc.n_valid if n is None else int(n)
    queries = torch.as_tensor(queries, dtype=torch.float32,
                              device=qc.l1.device)
    if maxima is None:
        max_l1 = float(qc.l1[:n].max()) if n else 0.0
        max_delta = float(qc.delta.max())
    else:
        max_l1, max_delta = maxima
    l1_q = row_sum(queries.abs()).double()
    eps = max_delta * l1_q + FP_REL * (l1_q * max_l1 + 1.0)
    return 2.0 * eps if metric == "l2" else eps


def corpus_maxima(qc: QuantizedCorpus, n: int, comm: Comm) -> tuple:
    """(max L1 norm over the first ``n`` rows of ``qc``, max block delta)
    over every device: ``qc`` holds this process's blocks, and each
    device's two maxima are gathered, so every process takes the same
    bounds.  (0, 0) rows of a device without valid rows change
    nothing: both are >= 0."""
    l1 = qc.l1[:n].max() if n else torch.zeros((), device=qc.l1.device)
    mine = torch.stack([l1, qc.delta.max()]).reshape(1, 2)
    both = comm.all_rows(mine).amax(dim=0)
    return float(both[0]), float(both[1])


class RescoreRows:
    """The f32 rows the exact rescoring reads: the padded [P * block, d]
    corpus, its squared norms and L1 norms by global row id.

    With every device in this process (``SingleProcessComm``) the rows
    stay on ``comm.device`` and the norms are the quantized corpus's
    exact ``sq`` / ``l1`` (the rescoring as it always was).  A rank of
    ``DistributedComm`` keeps the rows on the host, as the reference
    rescores on the host: :meth:`take` moves only the rows a pass asks
    for, and the norms are formed on the host from them with the same
    float32 operations (:func:`row_sum`), so they are the same bits.
    """

    def __init__(self, rows: torch.Tensor, comm: Comm,
                 sq: Optional[torch.Tensor] = None,
                 l1: Optional[torch.Tensor] = None):
        self.device = comm.device
        self.resident = len(comm.local) == comm.P
        self.rows = rows.to(self.device if self.resident else "cpu")
        self.sq = row_sum(self.rows * self.rows) if sq is None else sq
        self._l1 = l1

    def _host_ids(self, ids: torch.Tensor) -> torch.Tensor:
        return ids if self.resident else ids.cpu()

    def _dev(self, t: torch.Tensor) -> torch.Tensor:
        return t if self.resident else t.to(self.device)

    def take(self, ids: torch.Tensor) -> torch.Tensor:
        """``rows[ids]`` on the device (any shape of int64 ids)."""
        return self._dev(self.rows[self._host_ids(ids)])

    def norms(self, ids: torch.Tensor) -> torch.Tensor:
        """Squared L2 norms ``sq[ids]`` on the device."""
        return self._dev(self.sq[self._host_ids(ids)])

    def l1(self, ids: torch.Tensor) -> torch.Tensor:
        """L1 norms of ``rows[ids]`` on the device."""
        if self._l1 is not None:
            return self._l1[ids]
        return self._dev(row_sum(self.rows[self._host_ids(ids)].abs()))

    def update(self, r0: int, block_rows: torch.Tensor) -> None:
        """Overwrite rows ``r0 : r0 + len(block_rows)`` and their norms."""
        blk = block_rows.to(self.rows.device)
        self.rows[r0:r0 + blk.shape[0]] = blk
        self.sq[r0:r0 + blk.shape[0]] = row_sum(blk * blk)


# ---------------------------------------------------------------------------
# Emitters (DESIGN.md section 17.3)
# ---------------------------------------------------------------------------

def _q_dots(bi: QuantBlocks, bj: QuantBlocks) -> torch.Tensor:
    """Dequantized dots of one tile for every device, [P, block, block]:
    the f32 product of the codes times ``s_lo * s_hi``."""
    return (bi.q.float() @ bj.q.float().transpose(-1, -2)) \
        * (bi.scale * bj.scale)[:, None, None]


def _kernel_sd(qb: QuantBlocks) -> torch.Tensor:
    """The [P, k, 2] (scale, delta) operand the kernels take."""
    return torch.stack([qb.scale, qb.delta], dim=-1)


def _plain_threshold_q(qb: QuantBlocks, lo, hi, meta, **kw):
    return kref.pairwise_threshold_q(qb.q, qb.scale, qb.delta, qb.l1, qb.sq,
                                     lo, hi, meta, **kw)


def _plain_topk_q(qb: QuantBlocks, lo, hi, meta, **kw):
    return kref.pairwise_topk_q(qb.q, qb.scale, qb.sq, lo, hi, meta, **kw)


class QuantThresholdEmitter(ThresholdJoinEmitter):
    """Widened-band threshold compaction over quantized tiles.

    :class:`~repro_torch.core.sparse.ThresholdJoinEmitter` with the
    dequantized tile score and the certified band ``score_q >= threshold
    - eps`` as the keep test: every true hit is inside the band, so the
    f32 rescoring recovers the exact join.  No norm-bound prefilter (a
    pruned tile holding a true hit would break soundness).  The batched
    step is ``kernels/ref.py:pairwise_threshold_q`` or, through
    ``batch_fn``, kernel B7.
    """

    def __init__(self, schedule: PairSchedule, mask, thr: float,
                 capacity: int, metric: str, block: int, meta, nv,
                 batch_fn=None):
        super().__init__(schedule, mask, thr, capacity, metric, block, False,
                         meta, nv, batch_fn=batch_fn or functools.partial(
                             _plain_threshold_q, threshold=thr,
                             capacity=capacity, block_rows=block,
                             metric=metric))

    def _tile(self, bi: QuantBlocks, bj: QuantBlocks):
        """One quantized tile's scores [P, block, block] and the band each
        entry must reach, ``thr - eps``."""
        s = _q_dots(bi, bj)
        if self.metric == "l2":
            s = (2.0 * s - bj.sq[:, None, :]) - bi.sq[:, :, None]
        eps = kref.quant_eps_tile(bi.delta, bj.delta, bi.l1, bj.l1,
                                  dim=bi.q.shape[-1], metric=self.metric)
        return s, self.thr - eps


class QuantKnnEmitter(KnnEmitter):
    """Per-row quantized top-M selection over the scheduled pairs —
    :class:`~repro_torch.core.knn.KnnEmitter` with the dequantized tile
    score and the exact stored norms; the driver certifies the lists and
    rescores the candidates.  The batched step is
    ``kernels/ref.py:pairwise_topk_q`` or, through ``batch_fn``, kernel
    B8."""

    def __init__(self, schedule: PairSchedule, mask, topk: int, metric: str,
                 block: int, meta, batch_fn=None):
        super().__init__(schedule, mask, topk, metric, block, meta,
                         batch_fn=batch_fn or functools.partial(
                             _plain_topk_q, topk=topk, block_rows=block,
                             metric=metric))

    def _tile(self, bi: QuantBlocks, bj: QuantBlocks):
        """Dequantized dots [P, block, block] and the stored squared
        norms."""
        return _q_dots(bi, bj), bi.sq, bj.sq


def _gather_payload_bytes(block: int, d: int, mode: str) -> int:
    """Per-shift payload of one :class:`QuantBlocks` per device: codes,
    the scale / delta scalars and the l1 / sq rows."""
    return block * d * quant_itemsize(mode) + 8 + 8 * block


def _qmode(qb: QuantBlocks) -> str:
    return "int8" if qb.q.dtype == torch.int8 else "bf16"


def _sweep_setup(qb: QuantBlocks, comm: Comm, schedule, mask,
                 mode: str, batch_fn, plane_bytes: int, n_valid):
    """The shared prologue of the two quantized pair sweeps: the mask
    table, the ``mode="auto"`` choice (score / id planes per tile entry
    plus the resident quantized stack) and the pair metadata."""
    sweep_mod.validate_mode(mode, batch_fn)
    L = len(comm.local)
    if qb.q.shape[0] != L:
        raise ValueError(f"the blocks must carry the device axis first: "
                         f"{tuple(qb.q.shape)} for {L} local device(s) of "
                         f"P={comm.P}")
    _L, block, d = qb.q.shape
    if mask is None:
        mask = comm.local_rows(torch.as_tensor(pair_mask_table(schedule)))
    mask = mask.to(qb.q.device).reshape(L, schedule.n_pairs)
    if mode == "auto":
        mode = sweep_mod.select_mode(
            schedule, schedule.n_pairs * block * block * plane_bytes
            + schedule.k * _gather_payload_bytes(block, d, _qmode(qb)),
            batch_fn)
    meta = _pair_meta(schedule, comm, block, n_valid)
    return mask, mode, block, meta


def quorum_allpairs_threshold_q(
    qb: QuantBlocks,
    comm: Comm,
    *,
    threshold: float,
    capacity: int,
    schedule: PairSchedule,
    metric: str = "dot",
    mode: str = "auto",
    mask: torch.Tensor | None = None,
    n_valid: int | None = None,
    batch_fn: Callable | None = None,
) -> SparseHits:
    """Distributed widened-band threshold join over quantized blocks
    (DESIGN.md section 17.3): ``qb`` holds ``[P, ...]`` leaves.  Emits
    every global pair whose quantized score clears ``threshold - eps(i,
    j)`` — a superset of the join, resolved by the rescoring in
    :func:`quant_similarity_join`.  ``batch_fn(qb, lo, hi, meta) -> (vals,
    i, j, count)`` is the kernel hook (batched mode only)."""
    if metric not in JOIN_METRICS:
        raise ValueError(f"metric must be one of {JOIN_METRICS}, "
                         f"got {metric!r}")
    if capacity < 1:
        raise ValueError(f"capacity must be >= 1, got {capacity}")
    mask, mode, block, meta = _sweep_setup(qb, comm, schedule, mask, mode,
                                           batch_fn, 12, n_valid)
    emitter = QuantThresholdEmitter(
        schedule, mask, float(np.float32(threshold)), capacity, metric, block,
        meta[:7], meta[7], batch_fn=batch_fn)
    return sweep_mod.pair_sweep(emitter, schedule=schedule, comm=comm,
                                mode=mode, x=qb)


def quorum_allpairs_knn_q(
    qb: QuantBlocks,
    comm: Comm,
    *,
    topk: int,
    schedule: PairSchedule,
    metric: str = "dot",
    mode: str = "auto",
    mask: torch.Tensor | None = None,
    n_valid: int | None = None,
    batch_fn: Callable | None = None,
):
    """Distributed quantized top-M candidate lists (DESIGN.md section
    17.3): :func:`core.knn.quorum_allpairs_knn` over :class:`QuantBlocks`.
    Returns each row's quantized top-``topk`` ``(scores, global ids)``,
    ``[P, block, topk]``."""
    if metric not in KNN_METRICS:
        raise ValueError(f"metric must be one of {KNN_METRICS}, "
                         f"got {metric!r}")
    if topk < 1:
        raise ValueError(f"topk must be >= 1, got {topk}")
    mask, mode, block, meta = _sweep_setup(qb, comm, schedule, mask, mode,
                                           batch_fn, 16, n_valid)
    emitter = QuantKnnEmitter(schedule, mask, topk, metric, block, meta[:7],
                              batch_fn=batch_fn)
    vals, idx = sweep_mod.pair_sweep(emitter, schedule=schedule, comm=comm,
                                     mode=mode, x=qb)
    partials = [(vals[:, s], idx[:, s]) for s in range(schedule.k)]
    return quorum_scatter(
        partials, schedule, comm,
        reduce_fn=lambda a, b: _merge_lists(a[0], a[1], b[0], b[1], topk))


# ---------------------------------------------------------------------------
# Drivers: quantize, sweep, certify, rescore (DESIGN.md section 17.4)
# ---------------------------------------------------------------------------

def _shard_quant(corpus, comm: Comm, mode: str):
    """Pad to P blocks and quantize this process's: (qc of its L blocks
    on ``comm.device``, the :class:`RescoreRows` of the padded f32
    corpus).  In one process the padded rows are made on the device and
    quantized there, as they always were; a rank pads on the host and
    moves only its own blocks to its device."""
    P, L = comm.P, len(comm.local)
    resident = L == P
    x = pad_blocks(corpus, P, comm.device if resident else "cpu")
    block = x.shape[1]
    x = x.reshape(-1, x.shape[-1])
    if resident:
        qc = quantize_corpus(x, P, block, mode)
        return qc, RescoreRows(x, comm, sq=qc.sq, l1=qc.l1)
    r0 = comm.local.start * block
    qc = quantize_corpus(x[r0:r0 + L * block].to(comm.device), L, block,
                         mode)
    return qc, RescoreRows(x, comm)


def _resolve_placement(placement, P: int):
    from .placement import placement_from_env, resolve_placement
    return (placement_from_env(P) if placement is None
            else resolve_placement(placement, P))


def _require_kernel_mode(mode: str) -> None:
    if mode not in ("batched", "auto"):
        raise ValueError(
            f"use_kernel needs the batched mode (got mode={mode!r}); "
            "the fused kernel only replaces the batched inner step")


@functools.lru_cache(maxsize=64)
def _qjoin_fn(comm: Comm, N: int, block: int, threshold: float,
              metric: str, mode: str, capacity: int, use_kernel: bool,
              placement):
    """Build (and cache) the quantized band join ``f(QuantBlocks) ->
    SparseHits`` per (comm, shape, threshold, capacity, ...) key."""
    sched = placement.schedule()
    mask_table = comm.local_rows(
        torch.as_tensor(pair_mask_table(sched))).to(comm.device)
    batch_fn = None
    if use_kernel:
        _require_kernel_mode(mode)
        from ..kernels import ops as kops

        def batch_fn(qb, lo, hi, meta):
            return kops.pairwise_threshold_q(
                qb.q, _kernel_sd(qb), qb.l1, qb.sq, lo, hi, meta,
                threshold=threshold, capacity=capacity, block_rows=block,
                metric=metric)

    def run(qb):
        return quorum_allpairs_threshold_q(
            qb, comm, threshold=threshold, capacity=capacity, schedule=sched,
            metric=metric, mode=mode, mask=mask_table, n_valid=N,
            batch_fn=batch_fn)
    return run


@functools.lru_cache(maxsize=64)
def _qknn_fn(comm: Comm, N: int, block: int, topk: int,
             metric: str, mode: str, use_kernel: bool, placement):
    """Build (and cache) the quantized top-M sweep ``f(QuantBlocks) ->
    (vals, idx [P, block, topk])``."""
    sched = placement.schedule()
    mask_table = comm.local_rows(
        torch.as_tensor(pair_mask_table(sched))).to(comm.device)
    batch_fn = None
    if use_kernel:
        _require_kernel_mode(mode)
        from ..kernels import ops as kops

        def batch_fn(qb, lo, hi, meta):
            return kops.pairwise_topk_q(
                qb.q, _kernel_sd(qb), qb.sq, lo, hi, meta, topk=topk,
                block_rows=block, metric=metric)

    def run(qb):
        return quorum_allpairs_knn_q(
            qb, comm, topk=topk, schedule=sched, metric=metric, mode=mode,
            mask=mask_table, n_valid=N, batch_fn=batch_fn)
    return run


def _pair_dots(rows: RescoreRows, ai: torch.Tensor, aj: torch.Tensor):
    """f32 dots of the row pairs (x[ai[n]], x[aj[n]]), in chunks."""
    out = torch.empty(ai.shape[0], dtype=torch.float32, device=rows.device)
    step = max(1, _RESCORE_ELEMS // max(1, rows.rows.shape[1]))
    for s in range(0, ai.shape[0], step):
        out[s:s + step] = torch.sum(rows.take(ai[s:s + step])
                                    * rows.take(aj[s:s + step]), dim=-1)
    return out


def quant_similarity_join(corpus, comm: Comm, *,
                          threshold: float, quant: str, metric: str = "dot",
                          mode: str = "auto", placement=None,
                          capacity: int | None = None,
                          use_kernel: bool = False, escalate: bool = True,
                          max_doublings: int = 16,
                          stats: dict | None = None) -> JoinResult:
    """Exact similarity join through the quantized band and f32 rescoring
    (DESIGN.md section 17.4).

    The devices emit the band ``score_q >= threshold - eps`` over the
    quantized working set (kernel B7 with ``use_kernel``), under the
    capacity / overflow escalation contract (counts are *band* counts);
    every emitted pair is rescored against the f32 rows and kept when
    ``score_f32 >= threshold``.  The result equals
    :func:`core.sparse.similarity_join`'s (pairs sorted by (i, j); under
    ``DistributedComm`` the pairs this rank's device owns, and every
    device's band counts).  ``stats`` (optional dict) receives
    ``emitted``, ``kept``, ``certain`` (pairs the bound alone proves in),
    ``borderline`` (those four of this process's devices) and
    ``escalations``.
    """
    _check_quant(quant)
    if metric not in JOIN_METRICS:
        raise ValueError(f"metric must be one of {JOIN_METRICS}, "
                         f"got {metric!r}")
    N = int(torch.as_tensor(corpus).shape[0])
    if N >= MAX_ROWS_F32_EXACT:
        raise ValueError(
            f"corpus has {N} rows >= 2^24; global row ids would lose "
            "float32 exactness in the fused kernel's compaction")
    P = comm.P
    plc = _resolve_placement(placement, P)
    qc, rows = _shard_quant(corpus, comm, quant)
    qb = qc.blocks()
    block = qc.block
    sched = plc.schedule()
    n_cand = sched.n_pairs * block * block
    cap = int(capacity) if capacity is not None else default_capacity(n_cand)
    thr = float(np.float32(threshold))

    escalations = 0
    while True:
        run = _qjoin_fn(comm, N, block, thr, metric, mode, cap, use_kernel,
                        plc)
        hits = run(qb)
        counts = comm.all_rows(hits.count).cpu().numpy().reshape(-1)
        overflow = bool((counts > cap).any())
        if not overflow or not escalate or escalations >= max_doublings:
            break
        cap = 2 * cap
        escalations += 1
    if overflow and escalate:
        raise RuntimeError(
            f"quantized band join still overflows capacity {cap} after "
            f"{escalations} doublings; raise `capacity`/`max_doublings` or "
            "the threshold")

    used = (torch.arange(cap, device=comm.device)[None]
            < torch.clamp(hits.count, max=cap)[:, None])
    ai, aj, band_v = hits.i[used].long(), hits.j[used].long(), hits.vals[used]
    dots = _pair_dots(rows, ai, aj)
    rescored = ((2.0 * dots - rows.norms(aj)) - rows.norms(ai)
                if metric == "l2" else dots)
    keep = rescored >= thr
    if stats is not None:
        eps = _eps_pair_rows(comm.all_rows(qc.delta).double(), block,
                             qc.q.shape[1], ai, rows.l1(ai), aj, rows.l1(aj),
                             metric)
        certain = int((keep & (band_v.double() >= thr + eps)).sum())
        stats.update(emitted=int(ai.shape[0]), kept=int(keep.sum()),
                     certain=certain, borderline=int(ai.shape[0]) - certain,
                     escalations=escalations)
    ai, aj, av = ai[keep], aj[keep], rescored[keep]
    order = torch.argsort(aj, stable=True)
    order = order[torch.argsort(ai[order], stable=True)]
    return JoinResult(i=ai[order].cpu().numpy(), j=aj[order].cpu().numpy(),
                      scores=av[order].cpu().numpy(), counts=counts,
                      capacity=cap, escalations=escalations,
                      overflow=overflow)


def _certify(rows: torch.Tensor, cand: torch.Tensor, c_m: torch.Tensor,
             eps: torch.Tensor, exhaustive: bool, topk: int,
             rescore: Callable, width: int):
    """The certification rule of the quantized top-M drivers, for R rows
    (or queries) at once.  ``rows`` [R] their ids, ``cand`` [R, M]
    candidate ids (IDX_SENTINEL = none), ``c_m`` [R] the quantized M-th
    score, ``eps`` [R] float64 bounds; ``rescore(rows, ids)`` gives the
    f32 scores [r, M] of a chunk of rows against ids (width: the row
    length, which sizes the chunks).  A row is certified when its list is
    complete (fewer than M real candidates, or ``exhaustive``) or its
    rescored k-th score beats ``c_m + eps``.  Returns (certified [R],
    rescored top-k scores [R, topk], ids [R, topk]) ordered by (-score,
    index) with (NEG_INF, IDX_SENTINEL) padding."""
    R, M = cand.shape
    real = cand != IDX_SENTINEL
    n_real = real.sum(dim=1)
    ids = torch.where(real, cand, 0).long()
    step = max(1, _RESCORE_ELEMS // max(1, M * width))
    vals = torch.empty(R, topk, dtype=torch.float32, device=cand.device)
    idx = torch.empty(R, topk, dtype=torch.int32, device=cand.device)
    for s in range(0, R, step):
        c = slice(s, s + step)
        sc = torch.where(real[c], rescore(rows[c], ids[c]), NEG_INF)
        vals[c], idx[c] = kref.topk_by_score_index(
            sc, torch.where(real[c], cand[c], IDX_SENTINEL), topk)
    complete = torch.full_like(real[:, 0], exhaustive) | (n_real < M)
    return (complete | ((n_real >= topk)
                        & (vals[:, topk - 1].double() > c_m.double() + eps)),
            vals, idx)


def quant_knn_graph(corpus, comm: Comm, *, topk: int,
                    quant: str, metric: str = "dot", mode: str = "auto",
                    placement=None, use_kernel: bool = False,
                    stats: dict | None = None) -> KnnResult:
    """Exact k-NN graph through quantized top-M candidates and certified
    rescoring (DESIGN.md section 17.4).

    Runs the quantized sweep for every row's top-M (kernel B8 with
    ``use_kernel``; M starts at the power-of-two bucket of ``topk``), then
    certifies each pending row: its list is complete, or its f32 k-th
    rescored candidate beats the quantized M-th score plus the row's bound
    (:func:`eps_rows_upper`), so no row outside the list can enter the
    true top-k.  Uncertified rows double M and rerun (the list is
    exhaustive once M >= N - 1).  ``stats`` (optional dict) receives
    ``passes``, a list of ``(M, rows still pending)``, counted over every
    device: every process runs every pass, also with none of its own rows
    pending, since each pass is a collective sweep.  Returns a
    :class:`core.knn.KnnResult` equal to :func:`core.knn.knn_graph`'s (a
    rank's: its own block's rows).
    """
    _check_quant(quant)
    if metric not in KNN_METRICS:
        raise ValueError(f"metric must be one of {KNN_METRICS}, "
                         f"got {metric!r}")
    if topk < 1:
        raise ValueError(f"topk must be >= 1, got {topk}")
    N = int(torch.as_tensor(corpus).shape[0])
    P = comm.P
    plc = _resolve_placement(placement, P)
    qc, src = _shard_quant(corpus, comm, quant)
    qb = qc.blocks()
    block = qc.block
    row0, n = local_row_span(comm, block, N)
    # this process's rows against every device's maxima
    eps_row = eps_rows_upper(qc, metric, n,
                             maxima=corpus_maxima(qc, n, comm))
    dev = comm.device

    def rescore(r, ids):
        # the reference's order: (2 dot - |row|^2) - |cand|^2
        dots = torch.sum(src.take(ids) * src.take(r)[:, None, :], dim=-1)
        if metric == "l2":
            return (2.0 * dots - src.norms(r)[:, None]) - src.norms(ids)
        return dots

    out_v = torch.full((n, topk), NEG_INF, dtype=torch.float32, device=dev)
    out_i = torch.full((n, topk), IDX_SENTINEL, dtype=torch.int64,
                       device=dev)
    M = quantize_pow2(topk)
    pending = torch.ones(n, dtype=torch.bool, device=dev)
    passes = []
    while True:
        run = _qknn_fn(comm, N, block, int(M), metric, mode, use_kernel, plc)
        vals_q, idx_q = (t.reshape(-1, M)[:n] for t in run(qb))
        rows = torch.nonzero(pending).reshape(-1)
        ok, v, i = _certify(rows + row0, idx_q[rows], vals_q[rows, M - 1],
                            eps_row[rows], M >= N - 1, topk, rescore,
                            src.rows.shape[1])
        done = rows[ok]
        out_v[done], out_i[done] = v[ok], i[ok].long()
        pending[done] = False
        n_pending = int(comm.all_rows(
            pending.sum().reshape(1, 1)).sum())     # over every device
        passes.append((int(M), n_pending))
        if n_pending == 0:
            break
        M = min(quantize_pow2(2 * M), quantize_pow2(P * block))
    if stats is not None:
        stats.update(passes=passes)
    return KnnResult(indices=out_i.cpu().numpy(),
                     scores=out_v.cpu().numpy(), topk=int(topk), row0=row0)


# ---------------------------------------------------------------------------
# Serving: quantized resident stack + certified query top-k (DESIGN.md
# section 17.4)
# ---------------------------------------------------------------------------

class QuantQueryEmitter(QueryTopKEmitter):
    """Per-query quantized top-M over the resident quantized stack —
    :class:`~repro_torch.serving.engine.QueryTopKEmitter` with the
    dequantized slot score (no kernel: the reference has none on this
    path); the driver certifies the M-th margin against
    :func:`eps_queries` and rescores against the f32 mirror."""

    def _slot_scores(self, blk: QuantBlocks) -> torch.Tensor:
        """[P, Q, block] dequantized scores of one slot (exact stored
        norms for l2)."""
        return self._scores(blk.q.float(), blk.scale[:, None, None],
                            blk.sq[:, None, :])

    def _scores(self, codes, scale, sq):
        qn = self.queries
        s = torch.einsum("qd,...bd->...qb", qn, codes) * scale
        if self.metric == "l2":
            s = (2.0 * s - sq) - torch.sum(qn * qn, dim=-1)[:, None]
        elif self.metric != "dot":
            raise ValueError(f"metric must be one of {QUERY_METRICS}, "
                             f"got {self.metric!r}")
        return s

    def batch(self, quorum: QuantBlocks):
        """One product over the whole quantized stack and one top-M over
        all k * block candidates."""
        P, k, block = quorum.sq.shape
        Q = self.queries.shape[0]
        s = self._scores(quorum.q.float(), quorum.scale[:, :, None, None],
                         quorum.sq[:, :, None, :])         # [P, k, Q, block]
        s = torch.where(self.mask[:, :, None], s, NEG_INF)
        ids = torch.where(self.mask, self.gidx, IDX_SENTINEL)
        return sweep_mod.topk_by_score(
            s.permute(0, 2, 1, 3).reshape(P, Q, k * block),
            ids.reshape(P, 1, k * block).expand(P, Q, k * block), self.topk)


def quorum_query_topk_q(queries, qstack: QuantBlocks, stack_valid, mask_row,
                        *, topk: int, comm: Comm,
                        schedule: PairSchedule, mode: str = "auto",
                        metric: str = "dot"):
    """Quantized query top-M over the resident stack —
    :func:`serving.engine.quorum_query_topk` with a :class:`QuantBlocks`
    stack of ``[P, k, ...]`` leaves.  Returns per-query quantized
    ``(scores [P, Q, M], global ids [P, Q, M])``, the same on every
    device."""
    sweep_mod.validate_mode(mode, None)
    L, k, block, d = qstack.q.shape
    if mode == "auto":
        Q = queries.shape[0]
        mode = sweep_mod.select_mode(
            schedule, 2 * Q * k * block * 4
            + k * _gather_payload_bytes(block, d, _qmode(qstack)), None)
    gidx, mask = _query_geometry(schedule, comm, block,
                                 mask_row.reshape(L, k), stack_valid)
    emitter = QuantQueryEmitter(schedule, queries, mask, gidx, topk, metric)
    vals, idx = sweep_mod.pair_sweep(emitter, schedule=schedule, comm=comm,
                                     mode=mode, stack=qstack)
    return tree_merge_topk(vals, idx, comm=comm, topk=topk)


@functools.lru_cache(maxsize=64)
def _query_q_fn(comm: Comm, topk: int, mode: str, metric: str,
                placement):
    """Build (and cache) the quantized serving query ``f(queries [Q, d],
    QuantBlocks stack, stack_valid) -> (scores [Q, M], ids [Q, M])``."""
    sched = placement.schedule()
    mask_table = comm.local_rows(torch.as_tensor(
        build_cover(comm.P, placement).mask_table())).to(comm.device)

    def run(queries, stacks: QuantBlocks, stack_valid):
        vals, idx = quorum_query_topk_q(
            queries, stacks, stack_valid, mask_table, topk=topk, comm=comm,
            schedule=sched, mode=mode, metric=metric)
        return vals[0], idx[0]              # all device copies identical
    return run


class QuantServing:
    """The quantized resident state of a serving corpus, owned by
    ``serving.engine.ServingCorpus`` when built with ``quant != "off"``.

    Keeps a [P * block, d] f32 mirror of the corpus (the exact rescoring
    source, a :class:`RescoreRows`: on the device in one process, on the
    host for a rank of ``DistributedComm``), the :class:`QuantizedCorpus`
    of this process's blocks made from it, and the quantized stacks in
    the streaming layout (device i's slot s holds block ``(i + shifts[s])
    % P``) as a :class:`QuantBlocks` of ``[L, k, ...]`` leaves, gathered
    over the quorum as the f32 state is.  A streamed block update
    re-quantizes from the mirror and regathers the stacks, as the
    reference does.
    """

    def __init__(self, mode: str, comm: Comm,
                 schedule: PairSchedule, block: int, rows):
        _check_quant(mode)
        self.mode = mode
        self.comm = comm
        self.schedule = schedule
        self.block = block
        self.P = schedule.P
        self.mirror = RescoreRows(
            torch.as_tensor(rows, dtype=torch.float32).clone(), comm)
        self._requant()

    @property
    def rows(self) -> torch.Tensor:
        """The [P * block, d] f32 mirror."""
        return self.mirror.rows

    def _requant(self) -> None:
        """Quantize this process's blocks from the mirror and gather the
        quorum stacks; the bounds' corpus maxima over every device."""
        L, block = len(self.comm.local), self.block
        r0 = self.comm.local.start * block
        self.qc = quantize_corpus(
            self.rows[r0:r0 + L * block].to(self.comm.device), L, block,
            self.mode)
        self.stacks = quorum_gather(self.qc.blocks(), self.schedule,
                                    self.comm)
        self.maxima = corpus_maxima(self.qc, L * block, self.comm)

    def update_block(self, b: int, data, nvalid: int) -> None:
        """Apply a streamed block replace to the mirror and re-quantize
        (every process: the regather is collective)."""
        data = torch.as_tensor(data, dtype=torch.float32)
        blk = torch.zeros(self.block, self.rows.shape[1], dtype=torch.float32,
                          device=self.rows.device)
        blk[:data.shape[0]] = data.to(self.rows.device)
        blk[nvalid:] = 0.0
        self.mirror.update(b * self.block, blk)
        self._requant()

    def stack_bytes_per_device(self) -> int:
        """Bytes of the resident quantized stack and its side arrays on
        one device."""
        return (sum(t.numel() * t.element_size() for t in self.stacks)
                // self.stacks.q.shape[0])


def serving_query(corpus, queries, *, topk: int, mode: str = "auto",
                  metric: str = "dot", stats: dict | None = None):
    """Exact serving top-k through the quantized stack and certified
    rescoring (DESIGN.md section 17.4).

    ``corpus`` is a ``serving.engine.ServingCorpus`` whose ``quant`` holds
    a :class:`QuantServing`.  Runs the quantized top-M (M the power-of-two
    bucket of ``topk``), rescores each query's candidates against the f32
    mirror and certifies them: the list is exhaustive, or the f32 k-th
    score beats the quantized M-th score plus :func:`eps_queries`;
    otherwise M doubles and the device pass reruns.  ``stats`` (optional
    dict) receives ``passes``, a list of ``(M, queries still pending)``.
    Returns ``(scores [Q, topk], global row ids [Q, topk] int64)`` on the
    device, equal to the f32 ``ServingCorpus.query``'s.  Every process
    passes the same queries (SPMD) and takes the same answer; the pending
    counts are gathered and must agree before another pass.
    """
    qs = corpus.quant
    if qs is None:
        raise ValueError(
            "serving_query needs a quantized corpus (ServingCorpus.build "
            "with quant='int8'/'bf16'); use ServingCorpus.query for f32")
    if topk < 1:
        raise ValueError(f"topk must be >= 1, got {topk}")
    dev = qs.comm.device
    q = torch.as_tensor(queries, dtype=torch.float32).to(dev)
    Q = q.shape[0]
    total = qs.P * qs.block
    n_valid_rows = int(np.asarray(corpus.filled).sum())
    eps_q = eps_queries(qs.qc, q, metric, total, maxima=qs.maxima)
    qn2 = row_sum(q * q)

    def rescore(qi, ids):
        dots = torch.sum(qs.mirror.take(ids) * q[qi][:, None, :], dim=-1)
        if metric == "l2":
            return (2.0 * dots - qs.mirror.norms(ids)) - qn2[qi][:, None]
        return dots

    out_v = torch.full((Q, topk), NEG_INF, dtype=torch.float32, device=dev)
    out_i = torch.full((Q, topk), IDX_SENTINEL, dtype=torch.int64,
                       device=dev)
    M = quantize_pow2(topk)
    pending = torch.ones(Q, dtype=torch.bool, device=dev)
    passes = []
    while True:
        run = _query_q_fn(corpus.comm, int(M), mode, metric,
                          corpus.placement)
        vals_q, idx_q = run(q, qs.stacks, corpus.state.stack_valid)
        qids = torch.nonzero(pending).reshape(-1)
        ok, v, i = _certify(qids, idx_q[qids], vals_q[qids, M - 1],
                            eps_q[qids], M >= n_valid_rows, topk, rescore,
                            q.shape[1])
        done = qids[ok]
        out_v[done], out_i[done] = v[ok], i[ok].long()
        pending[done] = False
        n_pending = agreed(corpus.comm, int(pending.sum()), "pending queries")
        passes.append((int(M), n_pending))
        if n_pending == 0:
            break
        M = min(quantize_pow2(2 * M), quantize_pow2(total))
    if stats is not None:
        stats.update(passes=passes)
    return out_v, out_i


# ---------------------------------------------------------------------------
# Selfcheck (python -m repro_torch.core.quant)
# ---------------------------------------------------------------------------

def _serving_topk_oracle(rows: np.ndarray, valid: np.ndarray,
                         queries: np.ndarray, topk: int, metric: str):
    """Host f32 serving oracle: full scores, invalid rows masked, exact
    (-score, index) selection with sentinel padding."""
    s = (queries @ rows.T).astype(np.float32)
    if metric == "l2":
        n2 = (rows * rows).sum(axis=1).astype(np.float32)
        qn2 = (queries * queries).sum(axis=1).astype(np.float32)
        s = 2.0 * s - n2[None, :] - qn2[:, None]
    s = np.where(valid[None, :], s, NEG_INF)
    Q = s.shape[0]
    out_v = np.full((Q, topk), NEG_INF, np.float32)
    out_i = np.full((Q, topk), IDX_SENTINEL, np.int64)
    cand = np.nonzero(valid)[0]
    for qi in range(Q):
        take = np.lexsort((cand, -s[qi, cand].astype(np.float64)))[:topk]
        out_v[qi, :len(take)] = s[qi, cand[take]]
        out_i[qi, :len(take)] = cand[take]
    return out_v, out_i


def selfcheck_main(nblocks: int = 8,
                   modes: Sequence[str] = ENGINE_MODES + ("kernel",),
                   placement: str | None = None, device=None,
                   comm: Comm | None = None) -> None:
    """Selfcheck of the whole quantized pipeline on ``comm`` (default: a
    ``SingleProcessComm`` of ``nblocks`` devices on ``device``, itself
    defaulting to the CUDA device).

    Run as ``python -m repro_torch.core.quant [P] [modes] [placement]
    [--device cpu] [--dist gloo|nccl]`` (``--dist``: one device a
    torchrun process).  For each quant mode and metric the rescored join,
    k-NN graph and serving query must equal the f32 oracles (a rank's
    join: the pairs its device owns; its graph: its block's rows) in every
    requested mode (``kernel`` is the batched path through B7 / B8),
    including after a streamed block replace on the serving side.
    ``REPRO_QUANT``, when not ``off``, restricts the quant modes swept.
    """
    from ..serving.engine import ServingCorpus
    from .knn import brute_force_knn
    from .sparse import (brute_force_join, owned_pairs,
                         threshold_for_selectivity)

    Pn = int(nblocks)
    comm = SingleProcessComm(Pn, device) if comm is None else comm
    if comm.P != Pn:
        raise ValueError(f"the comm has P={comm.P} devices, not {Pn}")
    plc = _resolve_placement(placement, Pn)
    block, d, topk = 8, 16, 4
    N = Pn * block - 3
    rng = np.random.default_rng(0)
    corpus = rng.standard_normal((N, d)).astype(np.float32)
    corpus[:2 * block] *= 0.05          # vary the block scales
    queries = rng.standard_normal((5, d)).astype(np.float32)

    env_q = quant_from_env()
    qmodes = (env_q,) if env_q != "off" else QUANT_DTYPES
    for qm in qmodes:
        for metric in ("dot", "l2"):
            thr = threshold_for_selectivity(corpus, 0.08, metric)
            ref_i, ref_j, ref_s = brute_force_join(corpus, thr, metric)
            mine = owned_pairs(ref_i, ref_j, block, plc.schedule(),
                               comm.local)
            ref_i, ref_j, ref_s = ref_i[mine], ref_j[mine], ref_s[mine]
            ref_knn = brute_force_knn(corpus, topk, metric)
            for m in modes:
                mode, uk = ("batched", True) if m == "kernel" else (m, False)
                label = f"quant={qm} metric={metric} mode={m}"
                st: dict = {}
                res = quant_similarity_join(
                    corpus, comm, threshold=thr, quant=qm, metric=metric,
                    mode=mode, placement=plc, use_kernel=uk, stats=st)
                np.testing.assert_array_equal(res.i, ref_i, err_msg=label)
                np.testing.assert_array_equal(res.j, ref_j, err_msg=label)
                np.testing.assert_allclose(res.scores, ref_s, rtol=1e-5,
                                           atol=1e-5, err_msg=label)
                if not st["emitted"] >= st["kept"] == res.n_pairs:
                    raise AssertionError(f"{label}: band stats {st}")
                knn = quant_knn_graph(
                    corpus, comm, topk=topk, quant=qm, metric=metric,
                    mode=mode, placement=plc, use_kernel=uk)
                rows = slice(knn.row0, knn.row0 + knn.n_rows)
                np.testing.assert_array_equal(
                    knn.indices, ref_knn.indices[rows], err_msg=label)
                np.testing.assert_allclose(knn.scores, ref_knn.scores[rows],
                                           rtol=1e-5, atol=1e-5,
                                           err_msg=label)
        # serving: the quantized stack and a streamed replace (no kernel
        # on this path)
        sc = ServingCorpus.build(corpus, comm, placement=plc, quant=qm)
        total = sc.P * sc.block
        valid = np.zeros((total,), bool)
        valid[:N] = True
        rows = np.zeros((total, d), np.float32)
        rows[:N] = corpus
        for metric in ("dot", "l2"):
            ref_v, ref_i = _serving_topk_oracle(rows, valid, queries, topk,
                                                metric)
            for mode in ENGINE_MODES:
                sv, si = serving_query(sc, queries, topk=topk, mode=mode,
                                       metric=metric)
                label = f"serving quant={qm} metric={metric} mode={mode}"
                np.testing.assert_array_equal(si.cpu().numpy(), ref_i,
                                              err_msg=label)
                np.testing.assert_allclose(sv.cpu().numpy(), ref_v,
                                           rtol=1e-5, atol=1e-5,
                                           err_msg=label)
        newb = rng.standard_normal((sc.block, d)).astype(np.float32)
        sc.replace_block(1, newb)
        rows[sc.block:2 * sc.block] = newb
        valid[sc.block:2 * sc.block] = True
        ref_v, ref_i = _serving_topk_oracle(rows, valid, queries, topk,
                                            "dot")
        sv, si = serving_query(sc, queries, topk=topk, metric="dot")
        np.testing.assert_array_equal(si.cpu().numpy(), ref_i,
                                      err_msg=f"serving quant={qm} replace")
        np.testing.assert_allclose(sv.cpu().numpy(), ref_v, rtol=1e-5,
                                   atol=1e-5)
    where = (f" rank={comm.rank} transport={comm.transport}"
             if isinstance(comm, DistributedComm) else "")
    print(f"quant selfcheck OK: P={Pn} placement={plc.describe()} "
          f"quant={','.join(qmodes)} modes={','.join(modes)} "
          f"device={comm.device}{where}")


if __name__ == "__main__":
    import argparse
    ap = argparse.ArgumentParser(description="quantized-pipeline selfcheck")
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
