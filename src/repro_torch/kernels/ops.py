"""Public entry points of the port's kernels (the counterpart of
``repro/kernels/ops.py``).

Dispatch is by the device of the input tensors, and by nothing else:

  * a tensor on the CPU runs the plain PyTorch version (``kernels/ref.py``);
  * a tensor on a CUDA device launches the hand-written kernel, and a
    kernel that fails to build, load or launch raises — there is no path
    that falls back to the plain version on the card.

B9 and B10 have their gradients on the card: ``flash_attention`` on a
CUDA tensor that needs one goes through :class:`FlashAttention`, whose
backward is the hand-written kernel of ``csrc/flash_attention_bwd*.cu``,
and ``ssd_intra_chunk`` through :class:`SsdIntraChunk`, whose backward is
that of ``csrc/ssd_chunk_bwd.cu``.  On the CPU autograd differentiates
the plain versions.

The CUDA kernels mask their own ragged edges, so nothing is padded here.
Entry points take a leading batch axis (simulated devices or stacked
tiles), so one launch covers a whole batched step.
"""

from __future__ import annotations

import torch

from . import pairwise_batch, pairwise_corr as _corr_mod, pcit_filter as _pcit_mod
from . import pairwise_threshold as _thr_mod, query_score as _query_mod
from . import pairwise_batch_q as _q_mod, pairwise_topk as _topk_mod
from . import flash_attention as _flash_mod, ssd_chunk as _ssd_mod
from . import ref
from .ref import NEG_INF

#: kernel name -> (wrapper module, name of its launch counter)
KERNEL_MODULES = {
    "pairwise_batch": (pairwise_batch, "launches"),
    "pairwise_corr": (_corr_mod, "launches"),
    "pcit_filter": (_pcit_mod, "launches"),
    "query_topk": (_query_mod, "launches"),
    "pairwise_threshold": (_thr_mod, "launches"),
    "pairwise_topk": (_topk_mod, "launches"),
    "pairwise_threshold_q": (_q_mod, "threshold_launches"),
    "pairwise_topk_q": (_q_mod, "topk_launches"),
    "flash_attention": (_flash_mod, "launches"),
    "flash_attention_bwd": (_flash_mod, "bwd_launches"),
    "ssd_chunk": (_ssd_mod, "launches"),
    "ssd_chunk_bwd": (_ssd_mod, "bwd_launches"),
}


def _on_cpu(t: torch.Tensor) -> bool:
    return t.device.type == "cpu"


def pairwise_corr(xs_i: torch.Tensor, xs_j: torch.Tensor) -> torch.Tensor:
    """Correlation tiles [B, M, N] float32 of standardized row blocks
    [B, M, G] x [B, N, G] (PCIT phase 2)."""
    if _on_cpu(xs_i):
        return ref.pairwise_corr(xs_i, xs_j)
    return _corr_mod.pairwise_corr_cuda(xs_i, xs_j)


def pcit_filter(r_xy, rows_x, rows_y, gx, gy) -> torch.Tensor:
    """PCIT keep tiles [B, M, N] bool (PCIT phase 4); see
    ``kernels/pcit_filter.py``."""
    if _on_cpu(r_xy):
        return ref.pcit_filter(r_xy, rows_x, rows_y, gx, gy)
    return _pcit_mod.pcit_filter_cuda(r_xy, rows_x, rows_y, gx, gy)


def pairwise_batch_forces(quorum, lo, hi, wi, wj, *,
                          softening: float = 1e-2) -> torch.Tensor:
    """Fused batched n-body step for the engine's ``batch_fn`` hook:
    quorum [B, k, block, 4], lo / hi [n_pairs] slot ids, wi / wj
    [B, n_pairs] per-side pair weights -> [B, k, block, 3] float32."""
    if _on_cpu(quorum):
        return ref.pairwise_batch_forces(quorum, lo, hi, wi, wj,
                                         softening=softening)
    return pairwise_batch.pairwise_batch_forces_cuda(quorum, lo, hi, wi, wj,
                                                     softening=softening)


def query_topk(stack, queries, mask, gidx, *, topk: int,
               metric: str = "dot"):
    """Fused query scoring + dedup mask + top-k for the serving engine's
    ``batch_fn`` hook: stack [P, k, block, d], queries [Q, d], mask / gidx
    [P, k, block] -> (values [P, Q, topk], indices [P, Q, topk]); see
    ``kernels/query_score.py``."""
    if _on_cpu(stack):
        return ref.query_topk(stack, queries, mask, gidx, topk=topk,
                              metric=metric)
    return _query_mod.query_topk_cuda(stack, queries, mask, gidx, topk=topk,
                                      metric=metric)


def pairwise_threshold(quorum, lo, hi, meta, *, threshold: float,
                       capacity: int, block_rows: int, metric: str = "dot"):
    """Fused thresholded scoring + compaction for the similarity join's
    ``batch_fn`` hook: quorum [P, k, block, d], lo / hi [n_pairs], meta
    [P, n_pairs, 6] -> (vals, i, j [P, capacity], count [P]); see
    ``kernels/pairwise_threshold.py``."""
    if _on_cpu(quorum):
        return ref.pairwise_threshold(quorum, lo, hi, meta,
                                      threshold=threshold, capacity=capacity,
                                      block_rows=block_rows, metric=metric)
    return _thr_mod.pairwise_threshold_cuda(
        quorum, lo, hi, meta, threshold=threshold, capacity=capacity,
        block_rows=block_rows, metric=metric)


def pairwise_topk(quorum, lo, hi, meta, *, topk: int, block_rows: int,
                  metric: str = "dot"):
    """Fused per-slot top-k accumulation for the k-NN graph's ``batch_fn``
    hook: quorum [P, k, block, d], lo / hi [n_pairs], meta [P, n_pairs, 6]
    -> (vals, idx [P, k, block, topk]); see ``kernels/pairwise_topk.py``."""
    if _on_cpu(quorum):
        return ref.pairwise_topk(quorum, lo, hi, meta, topk=topk,
                                 block_rows=block_rows, metric=metric)
    return _topk_mod.pairwise_topk_cuda(quorum, lo, hi, meta, topk=topk,
                                        block_rows=block_rows, metric=metric)


def pairwise_threshold_q(q, sd, l1, sq, lo, hi, meta, *, threshold: float,
                         capacity: int, block_rows: int, metric: str = "dot"):
    """Quantized band compaction for the quantized join's ``batch_fn``
    hook: codes q [P, k, block, d], sd [P, k, 2] (scale, delta), l1 / sq
    [P, k, block] -> (vals, i, j [P, capacity], count [P]); see
    ``kernels/pairwise_batch_q.py``."""
    if _on_cpu(q):
        return ref.pairwise_threshold_q(
            q, sd[..., 0], sd[..., 1], l1, sq, lo, hi, meta,
            threshold=threshold, capacity=capacity, block_rows=block_rows,
            metric=metric)
    return _q_mod.pairwise_threshold_q_cuda(
        q, sd, l1, sq, lo, hi, meta, threshold=threshold, capacity=capacity,
        block_rows=block_rows, metric=metric)


def pairwise_topk_q(q, sd, sq, lo, hi, meta, *, topk: int, block_rows: int,
                    metric: str = "dot"):
    """Quantized per-slot top-k for the quantized k-NN graph's ``batch_fn``
    hook: codes q [P, k, block, d], sd [P, k, 2], sq [P, k, block] ->
    (vals, idx [P, k, block, topk]); see ``kernels/pairwise_batch_q.py``."""
    if _on_cpu(q):
        return ref.pairwise_topk_q(q, sd[..., 0], sq, lo, hi, meta,
                                   topk=topk, block_rows=block_rows,
                                   metric=metric)
    return _q_mod.pairwise_topk_q_cuda(q, sd, sq, lo, hi, meta, topk=topk,
                                       block_rows=block_rows, metric=metric)


def _needs_grad(*ts) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


class FlashAttention(torch.autograd.Function):
    """B9 with its gradient on the card: the forward launches B9 with the
    row log-sum-exp and saves (q, k, v, o, lse); the backward launches
    the B9 backward kernel."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool):
        o, lse = _flash_mod.flash_attention_cuda(q, k, v, causal=causal,
                                                 with_lse=True)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal = causal
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = _flash_mod.flash_attention_bwd_cuda(
            q, k, v, o, lse, do, causal=ctx.causal)
        return dq, dk, dv, None


def flash_attention(q, k, v, *, causal: bool = True) -> torch.Tensor:
    """4-d attention entry point (GQA): q [B, Tq, H, hd], k / v [B, Tk,
    KV, hd] -> [B, Tq, H, hd] in q's dtype; head h reads kv head h // G,
    causal masking is end-aligned; see ``kernels/flash_attention.py``.
    Differentiable on either device (the kernel pair on CUDA)."""
    if _on_cpu(q):
        return ref.flash_attention(q, k, v, causal=causal)
    if _needs_grad(q, k, v):
        return FlashAttention.apply(q, k, v, causal)
    return _flash_mod.flash_attention_cuda(q, k, v, causal=causal)


def flash_block(q, k, v, *, causal: bool, row_valid=None):
    """Partial attention of one block pair: q [B, Tq, H, hd], k / v [B, Tk,
    KV, hd] -> (o unnormalized [B, Tq, H, hd], m, l [B, Tq, H]) float32.
    ``row_valid`` [B]: rows whose flag is 0 become the merge identity
    (o = 0, m = NEG_INF, l = 0), as ``repro/apps/attention.py`` zeroes the
    schedule's invalid pairs; the kernel skips their work."""
    if not _on_cpu(q):
        return _flash_mod.flash_attention_cuda(q, k, v, causal=causal,
                                               partial=True,
                                               row_valid=row_valid)
    o, m, l = ref.flash_block(q, k, v, causal=causal)
    if row_valid is None:
        return o, m, l
    w = torch.as_tensor(row_valid).to(torch.float32).reshape(-1, 1, 1)
    m = torch.where(w > 0, m, NEG_INF)
    return o * w[..., None], m, l * w


class SsdIntraChunk(torch.autograd.Function):
    """B10 with its gradient on the card: the forward launches B10 and
    saves its inputs (nothing of size L^2, not y); the backward launches
    B10's backward kernel, which recomputes the cumsum and the decays.  An
    output whose gradient is absent (cd where only y is used) comes as
    None and counts as zero."""

    @staticmethod
    def forward(ctx, x, dt, A, Bm, Cm, chunk: int):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(x, dt, A, Bm, Cm)
        ctx.chunk = chunk
        return _ssd_mod.ssd_chunk_cuda(x, dt, A, Bm, Cm, chunk=chunk)

    @staticmethod
    def backward(ctx, dy, dS, dcd):
        x, dt, A, Bm, Cm = ctx.saved_tensors
        return (*_ssd_mod.ssd_chunk_bwd_cuda(x, dt, A, Bm, Cm, dy, dS, dcd,
                                             chunk=ctx.chunk), None)


def ssd_intra_chunk(x, dt, A, Bm, Cm, *, chunk: int):
    """The SSD intra-chunk step: x [B, T, H, P], dt [B, T, H], A [H], Bm /
    Cm [B, T, N] -> (y_intra [B, T, H, P], S [B, nc, H, N, P], cd [B, T,
    H]) float32; see ``kernels/ssd_chunk.py``.  Differentiable on either
    device (the kernel pair on CUDA, autograd of the plain version on the
    CPU)."""
    if _on_cpu(x):
        return ref.ssd_intra_chunk(x, dt, A, Bm, Cm, chunk=chunk)
    if _needs_grad(x, dt, A, Bm, Cm):
        return SsdIntraChunk.apply(x, dt, A, Bm, Cm, chunk)
    return _ssd_mod.ssd_chunk_cuda(x, dt, A, Bm, Cm, chunk=chunk)


def ssd_chunk(x, dt, A, Bm, Cm, *, chunk: int = 256) -> torch.Tensor:
    """Full SSD (the reference's ``ops.ssd_chunk``): the intra-chunk step
    plus the inter-chunk recurrence from a zero state.  x [B, T, H, P];
    dt [B, T, H]; A [H]; Bm / Cm [B, T, N] -> y [B, T, H, P] float32."""
    L = min(chunk, x.shape[1])
    y_intra, S, cd = ssd_intra_chunk(x, dt, A, Bm, Cm, chunk=L)
    return _ssd_mod.ssd_inter_chunk(y_intra, S, cd, Cm, chunk=L)[0]


def launch_counts() -> dict:
    """Kernel launches per kernel since the counts were last reset."""
    return {name: getattr(mod, attr)
            for name, (mod, attr) in KERNEL_MODULES.items()}


def reset_launch_counts() -> None:
    """Set every kernel's launch count to 0."""
    for mod, attr in KERNEL_MODULES.values():
        setattr(mod, attr, 0)
