"""B7 and B8: quantized pair scoring (int8 or bf16 codes, float32 sums,
dequant epilogue), hand-written CUDA.

Replace the Pallas kernels of ``repro/kernels/pairwise_batch_q.py``:

  * B7 ``pairwise_threshold_q_pallas`` (body ``_threshold_q_kernel``), the
    quantized join's ``batch_fn``: B5's compaction with the widened band
    ``score >= threshold - eps``.  Source ``csrc/pairwise_threshold_q.cu``.
  * B8 ``pairwise_topk_q_pallas`` (body ``_pairwise_topk_q_kernel``), the
    quantized k-NN graph's ``batch_fn``: B6's running lists over the
    dequantized tiles, no band.  Source ``csrc/pairwise_topk_q.cu``.

The codes stay in their storage type (1 or 2 bytes) all the way into
shared memory; the per-slot (scale, delta) pairs ride as one [P, k, 2]
float32 operand, the row L1 norms and exact squared norms as [P, k, block]
ones.  What bounds them on the H100: 2*d operations per candidate of an
active tile, at the int8 (1,979 TOP/s) or bf16 (989 TFLOP/s) tensor-core
rate.  Both files are built with ``-fmad=false``, so the dequant
epilogues round op for op as the plain versions' do.

Both score on the tensor cores with ``mma.sync`` (int8 into s32, bf16
into f32) at every row width up to :data:`INT8_TC_MAX_D` /
:data:`BF16_TC_MAX_D`, which no published corpus reaches.  B7 forms each
tile once, lo rows x hi columns, on 128 x 128 tiles, and compacts through
``csrc/compact.cuh`` (count, scan, write; the write pass scores again only
the tiles, and within them the warp sub-tiles, that held a survivor); an
entry meets a one-operation prefilter on its code dot, provably looser
than the band, before the exact score and eps (the file header has the
argument).  B8 selects behind each row's admission bound in registers.

int8 sums are exact s32 sums, converted once to float32: up to
:data:`INT8_EXACT_D` (1,040) exactly, so the int8 lists and band equal
the plain versions'; above, the float32 rounding of the exact dot (the
plain version's float32 matmul then depends on its order).  The tensor
cores' float32 accumulation of bf16 products does not round to nearest,
so bf16 rows longer than 128 join each :data:`BF16_CHUNK` of d into a
float32 running sum, compensated (the rounding error of each join starts
the next chunk's accumulator); the file headers bound the error and
prove the B7 band against it.  The float32 SIMT tile of
``csrc/pair_tile.cuh`` (route ``"simt"``) runs only when a caller asks
for it (``route=``), as the yardstick ``chip_smoke.py`` times the tensor
cores against.

The plain versions beside them are :func:`pairwise_threshold_q_plain` and
:func:`pairwise_topk_q_plain`; the device dispatch is
:func:`repro_torch.kernels.ops.pairwise_threshold_q` /
:func:`~repro_torch.kernels.ops.pairwise_topk_q`.
"""

from __future__ import annotations

import torch

from . import _build
from .pairwise_threshold import check_pairs, hot_words
from .pairwise_topk import list_width
from .ref import QUERY_METRICS
from .ref import pairwise_threshold_q as pairwise_threshold_q_plain
from .ref import pairwise_topk_q as pairwise_topk_q_plain

__all__ = ["pairwise_threshold_q_cuda", "pairwise_topk_q_cuda",
           "pairwise_threshold_q_plain", "pairwise_topk_q_plain",
           "threshold_launches", "topk_launches", "route_of", "band_tile",
           "INT8_EXACT_D", "INT8_TC_MAX_D", "BF16_TC_MAX_D", "BF16_CHUNK"]

#: B7 / B8 launches since the counts were last set to 0
threshold_launches = 0
topk_launches = 0

#: the largest d at which every int8 code dot (|dot| <= d * 127^2) is an
#: integer below 2^24, so its int32 sum converts to float32 exactly and
#: the plain version's float32 matmul gives it in any order
INT8_EXACT_D = (1 << 24) // (127 * 127)

#: the widest int8 rows on the tensor cores: every code dot stays within
#: 2^30 (its s32 sum is exact up to 2^31), so B7's integer prefilter
#: x - B_c, with B_c in [0, 2^30], never wraps
#: (``csrc/pairwise_threshold_q.cu``)
INT8_TC_MAX_D = (1 << 30) // (127 * 127)

#: d a tensor-core accumulator sums before the chunk joins the row's
#: float32 sum, compensated (bf16 rows longer than 128; the kernels'
#: kChunk in ``csrc/chunk_join.cuh``, passed by ``_build`` as
#: -DREPRO_BF16_CHUNK: at 32 every width read on the card lies closer to
#: float64 than the plain float32 version, at 64 and 128 not;
#: scripts/pair_q_chunks.py)
BF16_CHUNK = 32

#: the widest bf16 rows on the tensor cores: B7's band keeps every pair of
#: the f32 join while c + 2 + (d / c) 2^-24 <= 254 at c =
#: :data:`BF16_CHUNK` (``csrc/pairwise_threshold_q.cu``), which the
#: compensated joins make all but independent of d; 2^20 keeps a row's
#: 2 d bytes, an int in the kernels, far inside 2^31
BF16_TC_MAX_D = 1 << 20


def route_of(dtype: torch.dtype, d: int) -> str:
    """The B7 and B8 kernel a CUDA call with codes of ``dtype`` and width
    ``d`` launches: ``"tensor_cores"`` (``mma.sync``) for int8 with d <=
    :data:`INT8_TC_MAX_D` (66,572) and bf16 with d <=
    :data:`BF16_TC_MAX_D` (1,048,576); ``"simt"`` (the float32 tile of
    ``csrc/pair_tile.cuh``) above them, past every published width.  B7
    strips are :func:`band_tile` rows on each route."""
    limit = INT8_TC_MAX_D if dtype == torch.int8 else BF16_TC_MAX_D
    return "tensor_cores" if d <= limit else "simt"


def band_tile(route: str) -> int:
    """Rows of a B7 strip, and columns of its score tile, on ``route``:
    128 on the tensor cores, 64 on the SIMT tile (the hot-tile bits of
    ``csrc/compact.cuh`` are sized by it)."""
    return 128 if route == "tensor_cores" else 64


def _check_route(route):
    if route not in (None, "tensor_cores", "simt"):
        raise ValueError(f"route must be 'tensor_cores' or 'simt', got "
                         f"{route!r}")


def _check_codes(name: str, q: torch.Tensor, sd: torch.Tensor, rows,
                 metric: str):
    """Validate codes [P, k, block, d] (int8 or bfloat16), sd [P, k, 2]
    and the [P, k, block] row arrays; returns them contiguous, sd and the
    rows as float32."""
    if metric not in QUERY_METRICS:
        raise ValueError(f"metric must be one of {QUERY_METRICS}, "
                         f"got {metric!r}")
    if q.dim() != 4 or q.dtype not in (torch.int8, torch.bfloat16):
        raise ValueError(f"{name}: q must be an int8 or bfloat16 [P, k, "
                         f"block, d] tensor, got {q.dtype} {tuple(q.shape)}")
    P, k, block, _d = q.shape
    if sd.shape != (P, k, 2):
        raise ValueError(f"{name}: sd must be [P, k, 2] = {(P, k, 2)}, got "
                         f"{tuple(sd.shape)}")
    for r in rows:
        if r.shape != (P, k, block):
            raise ValueError(f"{name}: l1 / sq must be [P, k, block] = "
                             f"{(P, k, block)}, got {tuple(r.shape)}")
    _build.require_cuda(name, q, sd, *rows)
    return (q.contiguous(), sd.to(torch.float32).contiguous(),
            [r.to(torch.float32).contiguous() for r in rows])


def pairwise_threshold_q_cuda(q: torch.Tensor, sd: torch.Tensor,
                              l1: torch.Tensor, sq: torch.Tensor, lo, hi,
                              meta, *, threshold: float, capacity: int,
                              block_rows: int, metric: str = "dot",
                              route: str | None = None):
    """q [P, k, block, d] int8 / bfloat16 codes; sd [P, k, 2] (scale,
    delta >= 0); l1 / sq [P, k, block] (l1 >= 0); lo / hi [n_pairs]; meta
    [P, n_pairs, 6]; all on one CUDA device.  Returns ``(vals [P,
    capacity] float32, i / j [P, capacity] int32, count [P] int32)`` as
    ``kernels/ref.py:pairwise_threshold_q``.  ``route`` overrides
    :func:`route_of` (``chip_smoke.py`` times both routes at one
    shape; a failed build or launch raises, on either route)."""
    global threshold_launches
    if capacity < 1:
        raise ValueError(f"capacity must be >= 1, got {capacity}")
    _check_route(route)
    q, sd, (l1, sq) = _check_codes("pairwise_threshold_q", q, sd, (l1, sq),
                                   metric)
    P, k, block, d = q.shape
    route = route or route_of(q.dtype, d)
    lo_h, hi_h, n_pairs, meta = check_pairs("pairwise_threshold_q", q, lo,
                                            hi, meta)
    dev = q.device
    out_v = torch.empty(P, capacity, dtype=torch.float32, device=dev)
    out_i = torch.empty(P, capacity, dtype=torch.int32, device=dev)
    out_j = torch.empty(P, capacity, dtype=torch.int32, device=dev)
    count = torch.empty(P, dtype=torch.int32, device=dev)
    if n_pairs * block == 0:
        return (out_v.fill_(-1e30), out_i.fill_(2 ** 31 - 1),
                out_j.fill_(2 ** 31 - 1), count.zero_())
    row_count = torch.empty(P, n_pairs, block, dtype=torch.int32, device=dev)
    row_off = torch.empty(P, n_pairs, block, dtype=torch.int64, device=dev)
    tile = band_tile(route)
    strips = -(-block // tile)
    hot = torch.empty(P, n_pairs, strips, hot_words(block, tile),
                      dtype=torch.int32, device=dev)
    # the tensor-core route's per-warp flags: 8 bytes per (strip, tile)
    warp_hot = torch.empty(P, n_pairs, strips,
                           strips if route == "tensor_cores" else 0, 8,
                           dtype=torch.uint8, device=dev)
    lo_d, hi_d = lo_h.to(dev), hi_h.to(dev)
    with torch.cuda.device(dev):
        rc = _build.library().repro_pairwise_threshold_q(
            q.data_ptr(), sd.data_ptr(), l1.data_ptr(), sq.data_ptr(),
            lo_d.data_ptr(), hi_d.data_ptr(), meta.data_ptr(),
            hot.data_ptr(), warp_hot.data_ptr(), row_count.data_ptr(),
            row_off.data_ptr(),
            out_v.data_ptr(), out_i.data_ptr(), out_j.data_ptr(),
            count.data_ptr(), P, k, block, d, n_pairs, int(block_rows),
            float(threshold), int(capacity), int(metric == "l2"),
            int(q.dtype == torch.bfloat16), int(route == "tensor_cores"),
            _build.stream_of(q))
    _build.check(rc, "pairwise_threshold_q")
    threshold_launches += 1
    return out_v, out_i, out_j, count


def pairwise_topk_q_cuda(q: torch.Tensor, sd: torch.Tensor, sq: torch.Tensor,
                         lo, hi, meta, *, topk: int, block_rows: int,
                         metric: str = "dot", route: str | None = None):
    """q [P, k, block, d] int8 / bfloat16 codes; sd [P, k, 2] (scale,
    delta); sq [P, k, block]; lo / hi [n_pairs]; meta [P, n_pairs, 6]; all
    on one CUDA device.  Returns ``(vals [P, k, block, topk] float32, idx
    [P, k, block, topk] int32)`` as ``kernels/ref.py:pairwise_topk_q``.
    ``route`` overrides :func:`route_of` (``chip_smoke.py`` reads both
    routes' error at one shape)."""
    global topk_launches
    if topk < 1:
        raise ValueError(f"topk must be >= 1, got {topk}")
    _check_route(route)
    q, sd, (sq,) = _check_codes("pairwise_topk_q", q, sd, (sq,), metric)
    P, k, block, d = q.shape
    route = route or route_of(q.dtype, d)
    lo_h, hi_h, n_pairs, meta = check_pairs("pairwise_topk_q", q, lo, hi,
                                            meta)
    dev = q.device
    tp = list_width(topk)
    out_v = torch.empty(P, k, block, topk, dtype=torch.float32, device=dev)
    out_i = torch.empty(P, k, block, topk, dtype=torch.int32, device=dev)
    if block == 0:
        return out_v, out_i
    list_v = torch.empty(P, k, block, tp, dtype=torch.float32, device=dev)
    list_i = torch.empty(P, k, block, tp, dtype=torch.int32, device=dev)
    lo_d, hi_d = lo_h.to(dev), hi_h.to(dev)
    with torch.cuda.device(dev):
        rc = _build.library().repro_pairwise_topk_q(
            q.data_ptr(), sd.data_ptr(), sq.data_ptr(), lo_d.data_ptr(),
            hi_d.data_ptr(), meta.data_ptr(), list_v.data_ptr(),
            list_i.data_ptr(), out_v.data_ptr(), out_i.data_ptr(), P, k,
            block, d, n_pairs, int(block_rows), int(topk), tp,
            int(metric == "l2"), int(q.dtype == torch.bfloat16),
            int(route == "tensor_cores"), _build.stream_of(q))
    _build.check(rc, "pairwise_topk_q")
    topk_launches += 1
    return out_v, out_i
