"""B4: fused query scoring + dedup mask + top-k selection, hand-written CUDA.

Replaces the Pallas kernel ``repro/kernels/query_score.py:
query_topk_pallas`` (body ``_query_topk_kernel``), the serving engine's
``batch_fn``.  Source: ``repro_torch/csrc/query_topk.cu``.

What bounds it on the H100: fp32 arithmetic outside the tensor cores
(67 TFLOP/s; 2*Q*d operations per unmasked (query, row)); the f32 scores
decide the ranking, so no TF32.  The TPU kernel merges slot after slot
into one running [Q, topk] list on its sequential grid.  Here one launch
covers every simulated device: a first pass scores 16,384-row chunks
against 128-query tiles with B2's tile (``csrc/pairwise_corr.cu``;
128 x 256 a block, a 3-stage ``cp.async`` ring) and keeps each chunk's
top-k per query: each score is compared in registers with its query's
admission bound, and only those that beat it are queued for the query's
running list.  A chunk the cover mask leaves unscored exits at once, so
only the cover's rows cost work.  A second pass merges the chunk lists per (device,
query) and orders them.  Selection is exact under the (-score, index)
order.

The plain version beside it is :func:`query_topk_plain`; the device
dispatch is :func:`repro_torch.kernels.ops.query_topk`.
"""

from __future__ import annotations

import torch

from . import _build
from .ref import QUERY_METRICS
from .ref import query_topk as query_topk_plain

__all__ = ["query_topk_cuda", "query_topk_plain", "MAX_TOPK", "launches"]

#: the largest topk the kernel selects (the merge keeps one list per warp
#: in shared memory)
MAX_TOPK = 1024

#: kernel launches since the count was last set to 0
launches = 0


def query_topk_cuda(stack: torch.Tensor, queries: torch.Tensor,
                    mask: torch.Tensor, gidx: torch.Tensor, *, topk: int,
                    metric: str = "dot"):
    """stack [P, k, block, d] float32; queries [Q, d] float32 (shared by
    the P devices); mask [P, k, block] (> 0 = score the row); gidx
    [P, k, block] integer global row ids; all on one CUDA device.  Returns
    (values [P, Q, topk] float32, indices [P, Q, topk] int32)."""
    global launches
    if metric not in QUERY_METRICS:
        raise ValueError(f"metric must be one of {QUERY_METRICS}, "
                         f"got {metric!r}")
    if not 1 <= topk <= MAX_TOPK:
        raise ValueError(f"topk must lie in [1, {MAX_TOPK}], got {topk}")
    if stack.dim() != 4 or queries.dim() != 2 \
            or queries.shape[1] != stack.shape[3]:
        raise ValueError(f"need stack [P, k, block, d] and queries [Q, d], "
                         f"got {tuple(stack.shape)} and "
                         f"{tuple(queries.shape)}")
    P, k, block, d = stack.shape
    Q = queries.shape[0]
    if mask.shape != (P, k, block) or gidx.shape != (P, k, block):
        raise ValueError(f"mask and gidx must be [P, k, block] = "
                         f"{(P, k, block)}, got {tuple(mask.shape)} and "
                         f"{tuple(gidx.shape)}")
    for t in (stack, queries):
        if t.dtype != torch.float32:
            raise ValueError(f"query_topk takes float32, got {t.dtype}")
    _build.require_cuda("query_topk", stack, queries, mask, gidx)
    dev = stack.device
    stack, queries = stack.contiguous(), queries.contiguous()
    mask = mask.to(torch.float32).contiguous()
    gidx = gidx.to(torch.int32).contiguous()
    out_v = torch.empty(P, Q, topk, dtype=torch.float32, device=dev)
    out_i = torch.empty(P, Q, topk, dtype=torch.int32, device=dev)
    if P == 0 or Q == 0:
        return out_v, out_i
    if k * block == 0:
        return out_v.fill_(-1e30), out_i.fill_(2 ** 31 - 1)
    lib = _build.library()
    n_lists = k * -(-block // lib.repro_query_topk_chunk_rows())
    if P > 65535 or -(-Q // 128) > 65535:
        raise ValueError(f"P={P} or Q={Q} exceeds the launch grid")
    list_v = torch.empty(P, Q, n_lists, topk, dtype=torch.float32,
                         device=dev)
    list_i = torch.empty(P, Q, n_lists, topk, dtype=torch.int32, device=dev)
    list_full = torch.empty(P, n_lists, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        rc = lib.repro_query_topk(
            stack.data_ptr(), queries.data_ptr(), mask.data_ptr(),
            gidx.data_ptr(), list_v.data_ptr(), list_i.data_ptr(),
            list_full.data_ptr(), out_v.data_ptr(), out_i.data_ptr(), P, k,
            block, d, Q, topk, int(metric == "l2"), _build.stream_of(stack))
    _build.check(rc, "query_topk")
    launches += 1
    return out_v, out_i
