"""B5: fused thresholded scoring + sparse compaction, hand-written CUDA.

Replaces the Pallas kernel ``repro/kernels/pairwise_threshold.py:
pairwise_threshold_pallas`` (body ``_threshold_kernel``), the similarity
join's ``batch_fn``.  Source: ``repro_torch/csrc/pairwise_threshold.cu``,
compaction ``csrc/compact.cuh``.

What bounds it on the H100: fp32 arithmetic outside the tensor cores
(67 TFLOP/s; 2*d operations per candidate of an active tile).  The TPU
kernel compacts with a running count on its sequential grid, through a
one-hot matmul.  Here the (pair, row, col) order of the compacted buffers
is made explicit, so an overflowing buffer keeps exactly the plain
version's first-``capacity`` prefix: a count pass scores every active
tile on B2's 128 x 128 fp32 tile (``csrc/pairwise_corr.cu``) and records
per-row survivor counts and which column tiles hold a survivor (the hot
tiles); an exclusive scan per device gives each row's offset; a write
pass scores again only the hot tiles and writes each survivor at its
offset.  Inactive tiles exit at once; a self tile scores only the tiles
from its diagonal on.

Threshold and capacity are runtime arguments: one build serves every
threshold.  The plain version beside it is
:func:`pairwise_threshold_plain`; the device dispatch is
:func:`repro_torch.kernels.ops.pairwise_threshold`.
"""

from __future__ import annotations

import torch

from . import _build
from .ref import QUERY_METRICS
from .ref import pairwise_threshold as pairwise_threshold_plain

__all__ = ["pairwise_threshold_cuda", "pairwise_threshold_plain",
           "check_pairs", "hot_words", "launches", "TILE"]

#: kernel launches since the count was last set to 0
launches = 0

#: rows of a strip and columns of a score tile (``csrc/pairwise_threshold.cu``)
TILE = 128


def hot_words(block: int, tile: int) -> int:
    """32-bit words of hot-tile bits per strip: one bit per column tile of
    ``tile`` rows of a ``block``-row slot (``csrc/compact.cuh``)."""
    return (-(-block // tile) + 31) // 32


def check_pairs(name: str, data: torch.Tensor, lo, hi, meta):
    """Validate the slot pairs and meta rows of a pair kernel over ``data``
    [P, k, ...] (every tensor on one CUDA device); returns host int32
    ``(lo, hi)``, the pair count and contiguous int32 meta."""
    P, k = data.shape[:2]
    lo_h = torch.as_tensor(lo, dtype=torch.int32, device="cpu").reshape(-1)
    hi_h = torch.as_tensor(hi, dtype=torch.int32, device="cpu").reshape(-1)
    n_pairs = lo_h.numel()
    if hi_h.numel() != n_pairs:
        raise ValueError("lo and hi must have the same length")
    if n_pairs and (min(lo_h.min(), hi_h.min()) < 0
                    or max(lo_h.max(), hi_h.max()) >= k):
        raise ValueError(f"slot ids must lie in [0, {k})")
    meta = torch.as_tensor(meta)
    if meta.shape != (P, n_pairs, 6):
        raise ValueError(f"meta must be [P={P}, n_pairs={n_pairs}, 6], got "
                         f"{tuple(meta.shape)}")
    if not 0 < P <= 65535 or n_pairs > 65535 or k > 65535:
        raise ValueError(f"P={P}, k={k} or n_pairs={n_pairs} exceeds the "
                         "launch grid")
    _build.require_cuda(name, data, meta)
    return lo_h, hi_h, n_pairs, meta.to(torch.int32).contiguous()


def pairwise_threshold_cuda(quorum: torch.Tensor, lo, hi, meta, *,
                            threshold: float, capacity: int,
                            block_rows: int, metric: str = "dot"):
    """quorum [P, k, block, d] float32 on a CUDA device; lo / hi
    [n_pairs] slot ids (host or device); meta [P, n_pairs, 6] integer rows
    ``(active, is_self, ga, gb, nv_lo, nv_hi)``.  Returns ``(vals [P,
    capacity] float32, i [P, capacity] int32, j [P, capacity] int32,
    count [P] int32)`` under the overflow contract of
    ``kernels/ref.py:pairwise_threshold``."""
    global launches
    if metric not in QUERY_METRICS:
        raise ValueError(f"metric must be one of {QUERY_METRICS}, "
                         f"got {metric!r}")
    if capacity < 1:
        raise ValueError(f"capacity must be >= 1, got {capacity}")
    if quorum.dim() != 4 or quorum.dtype != torch.float32:
        raise ValueError(f"quorum must be a float32 [P, k, block, d] tensor, "
                         f"got {quorum.dtype} {tuple(quorum.shape)}")
    P, k, block, d = quorum.shape
    lo_h, hi_h, n_pairs, meta = check_pairs("pairwise_threshold", quorum, lo,
                                            hi, meta)
    dev = quorum.device
    quorum = quorum.contiguous()
    lo_d, hi_d = lo_h.to(dev), hi_h.to(dev)
    out_v = torch.empty(P, capacity, dtype=torch.float32, device=dev)
    out_i = torch.empty(P, capacity, dtype=torch.int32, device=dev)
    out_j = torch.empty(P, capacity, dtype=torch.int32, device=dev)
    count = torch.empty(P, dtype=torch.int32, device=dev)
    if n_pairs * block == 0:
        return (out_v.fill_(-1e30), out_i.fill_(2 ** 31 - 1),
                out_j.fill_(2 ** 31 - 1), count.zero_())
    row_count = torch.empty(P, n_pairs, block, dtype=torch.int32, device=dev)
    row_off = torch.empty(P, n_pairs, block, dtype=torch.int64, device=dev)
    strips = -(-block // TILE)
    hot = torch.empty(P, n_pairs, strips, hot_words(block, TILE),
                      dtype=torch.int32, device=dev)
    norms = torch.empty(P, k, block if metric == "l2" else 0,
                        dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        rc = _build.library().repro_pairwise_threshold(
            quorum.data_ptr(), lo_d.data_ptr(), hi_d.data_ptr(),
            meta.data_ptr(), norms.data_ptr(), hot.data_ptr(),
            row_count.data_ptr(), row_off.data_ptr(), out_v.data_ptr(),
            out_i.data_ptr(), out_j.data_ptr(), count.data_ptr(), P, k,
            block, d, n_pairs, int(block_rows), float(threshold),
            int(capacity), int(metric == "l2"), _build.stream_of(quorum))
    _build.check(rc, "pairwise_threshold")
    launches += 1
    return out_v, out_i, out_j, count
