"""B6: per-slot running top-k lists over the pair tiles, hand-written CUDA.

Replaces the Pallas kernel ``repro/kernels/pairwise_topk.py:
pairwise_topk_pallas`` (body ``_pairwise_topk_kernel``), the k-NN graph's
``batch_fn``.  Source: ``repro_torch/csrc/pairwise_topk.cu``, with the
selection of ``csrc/topk_select.cuh`` and the ordering pass of
``csrc/pair_tile.cuh``.

What bounds it on the H100: fp32 arithmetic outside the tensor cores
(67 TFLOP/s; 2*d operations per candidate pair of an active tile).  The
TPU kernel folds tile after tile into one VMEM accumulator on its
sequential grid.  Here each block owns 128 rows of one (device, slot),
walks the pairs in order and scores the tiles touching its slot from its
own side on B2's fp32 tile (128 rows x 256 candidates), so nothing is
shared between blocks (no atomics) and a non-self tile is formed twice.
Each score is compared in registers with its row's admission bound and
only the few that beat it are queued for the row's running list (shared
memory while ``list_width(topk)`` is at most 32, global scratch above, so
``topk`` has no ceiling); a second pass sorts the lists.  Selection is exact under
the (-score, index) order.

The plain version beside it is :func:`pairwise_topk_plain`; the device
dispatch is :func:`repro_torch.kernels.ops.pairwise_topk`.
"""

from __future__ import annotations

import torch

from . import _build
from .pairwise_threshold import check_pairs
from .ref import QUERY_METRICS
from .ref import pairwise_topk as pairwise_topk_plain

__all__ = ["pairwise_topk_cuda", "pairwise_topk_plain",
           "pairwise_topk_score_only_cuda", "launches"]

#: kernel launches since the count was last set to 0
launches = 0


def list_width(topk: int) -> int:
    """Entries kept per running list: topk rounded up to a power of two
    (the ordering pass is a bitonic sort)."""
    return 1 << (int(topk) - 1).bit_length()


def pairwise_topk_cuda(quorum: torch.Tensor, lo, hi, meta, *, topk: int,
                       block_rows: int, metric: str = "dot"):
    """quorum [P, k, block, d] float32 on a CUDA device; lo / hi [n_pairs]
    slot ids; meta [P, n_pairs, 6] integer rows ``(active, is_self, ga,
    gb, nv_lo, nv_hi)``.  Returns ``(vals [P, k, block, topk] float32, idx
    [P, k, block, topk] int32)`` as ``kernels/ref.py:pairwise_topk``."""
    global launches
    out = _launch(quorum, lo, hi, meta, topk=topk, block_rows=block_rows,
                  metric=metric, score_only=False)
    launches += 1
    return out


def pairwise_topk_score_only_cuda(quorum: torch.Tensor, lo, hi, meta, *,
                                  topk: int, block_rows: int,
                                  metric: str = "dot") -> torch.Tensor:
    """The scoring pass of :func:`pairwise_topk_cuda` alone, for measuring
    how the kernel's time splits between scoring and selection: the same
    tiles, walk and masks, each row's best score instead of its list.
    Returns that best score [P, k, block] (-inf where a row had no
    candidate).  Not a launch of B6: the count stays."""
    lists = _launch(quorum, lo, hi, meta, topk=topk, block_rows=block_rows,
                    metric=metric, score_only=True)
    return lists[..., 0]


def _launch(quorum, lo, hi, meta, *, topk: int, block_rows: int,
            metric: str, score_only: bool):
    if metric not in QUERY_METRICS:
        raise ValueError(f"metric must be one of {QUERY_METRICS}, "
                         f"got {metric!r}")
    if topk < 1:
        raise ValueError(f"topk must be >= 1, got {topk}")
    if quorum.dim() != 4 or quorum.dtype != torch.float32:
        raise ValueError(f"quorum must be a float32 [P, k, block, d] tensor, "
                         f"got {quorum.dtype} {tuple(quorum.shape)}")
    P, k, block, d = quorum.shape
    lo_h, hi_h, n_pairs, meta = check_pairs("pairwise_topk", quorum, lo, hi,
                                            meta)
    dev = quorum.device
    quorum = quorum.contiguous()
    tp = list_width(topk)
    l2 = metric == "l2"
    out_v = torch.empty(P, k, block, topk, dtype=torch.float32, device=dev)
    out_i = torch.empty(P, k, block, topk, dtype=torch.int32, device=dev)
    list_v = torch.empty(P, k, block, tp, dtype=torch.float32, device=dev)
    if block == 0:
        return list_v if score_only else (out_v, out_i)
    list_i = torch.empty(P, k, block, tp, dtype=torch.int32, device=dev)
    norms = torch.empty(P, k, block if l2 else 0, dtype=torch.float32,
                        device=dev)
    lo_d, hi_d = lo_h.to(dev), hi_h.to(dev)
    with torch.cuda.device(dev):
        rc = _build.library().repro_pairwise_topk(
            quorum.data_ptr(), lo_d.data_ptr(), hi_d.data_ptr(),
            meta.data_ptr(), norms.data_ptr() if l2 else None,
            list_v.data_ptr(), list_i.data_ptr(), out_v.data_ptr(),
            out_i.data_ptr(), P, k, block, d, n_pairs, int(block_rows),
            int(topk), tp, int(l2), int(score_only), _build.stream_of(quorum))
    _build.check(rc, "pairwise_topk")
    return list_v if score_only else (out_v, out_i)
