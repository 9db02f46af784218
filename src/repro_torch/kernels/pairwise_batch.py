"""B1: fused batched n-body pair step + slot reduction, hand-written CUDA.

Replaces the Pallas kernel ``repro/kernels/pairwise_batch.py:
pairwise_batch_pallas`` (body ``_nbody_batch_kernel``), the engine's
``batch_fn`` for n-body.  Source: ``repro_torch/csrc/pairwise_batch.cu``.

What bounds it on the H100: fp32 arithmetic outside the tensor cores
(67 TFLOP/s; about 20 flops per body pair, with the body blocks read once
from device memory).  The TPU kernel accumulates the pairs in order into
one VMEM scratch on its sequential grid; Hopper's blocks run in no order
and float atomics are ruled out, so one call launches three kernels: a
plan that lists the (device, pair, side) items with a non-zero weight, a
side pass that gives each listed item and 512-body row tile one block (one
pass over the partner block: equal work per block, whatever the schedule)
and writes the unweighted partial forces to scratch ``[B, n_pairs, 2,
block, 3]``, and a reduction that adds the weighted partials in pair
order, side 0 before side 1.  Deterministic; every non-self tile is formed
from both of its sides.  ``launches`` counts one per call.

The plain version beside it is :func:`pairwise_batch_forces_plain`; the
device dispatch is :func:`repro_torch.kernels.ops.pairwise_batch_forces`.
"""

from __future__ import annotations

import torch

from . import _build
from .ref import pairwise_batch_forces as pairwise_batch_forces_plain

__all__ = ["pairwise_batch_forces_cuda", "pairwise_batch_forces_plain",
           "launches"]

#: kernel launches since the count was last set to 0
launches = 0


def pairwise_batch_forces_cuda(quorum: torch.Tensor, lo, hi,
                               wi: torch.Tensor, wj: torch.Tensor, *,
                               softening: float = 1e-2) -> torch.Tensor:
    """quorum [B, k, block, 4] float32 on a CUDA device; lo / hi
    [n_pairs] slot ids (host or device); wi / wj [B, n_pairs] weights.
    Returns the slot-accumulated forces [B, k, block, 3] float32."""
    global launches
    if quorum.dim() != 4 or quorum.shape[-1] != 4:
        raise ValueError(f"quorum must be [B, k, block, 4], got "
                         f"{tuple(quorum.shape)}")
    if quorum.dtype != torch.float32:
        raise ValueError(f"quorum must be float32, got {quorum.dtype}")
    B, k, block, _ = quorum.shape
    lo_h = torch.as_tensor(lo, dtype=torch.int32, device="cpu").reshape(-1)
    hi_h = torch.as_tensor(hi, dtype=torch.int32, device="cpu").reshape(-1)
    n_pairs = lo_h.numel()
    if hi_h.numel() != n_pairs:
        raise ValueError("lo and hi must have the same length")
    if n_pairs and (min(lo_h.min(), hi_h.min()) < 0
                    or max(lo_h.max(), hi_h.max()) >= k):
        raise ValueError(f"slot ids must lie in [0, {k})")
    w = torch.stack([torch.as_tensor(wi, dtype=torch.float32),
                     torch.as_tensor(wj, dtype=torch.float32)], dim=-1)
    if w.shape != (B, n_pairs, 2):
        raise ValueError(f"wi / wj must be [B={B}, n_pairs={n_pairs}], got "
                         f"{tuple(w.shape[:-1])}")
    quorum = quorum.contiguous()
    dev = quorum.device
    w = w.to(dev).contiguous()
    lo_d, hi_d = lo_h.to(dev), hi_h.to(dev)
    _build.require_cuda("pairwise_batch_forces", quorum, w)
    if not 0 < B <= 65535 or not 0 < k <= 65535:
        raise ValueError(f"B={B} and k={k} must lie in [1, 65535]")
    out = torch.empty(B, k, block, 3, dtype=torch.float32, device=dev)
    if block == 0:
        return out
    # the plan's item list and the side pass's unweighted partials
    plan = torch.empty(1 + B * n_pairs * 2, dtype=torch.int32, device=dev)
    partial = torch.empty(B, n_pairs, 2, block, 3, dtype=torch.float32,
                          device=dev)
    with torch.cuda.device(dev):
        rc = _build.library().repro_pairwise_batch_forces(
            quorum.data_ptr(), lo_d.data_ptr(), hi_d.data_ptr(), w.data_ptr(),
            plan.data_ptr(), partial.data_ptr(), out.data_ptr(), B, k, block,
            n_pairs, float(softening), _build.stream_of(quorum))
    _build.check(rc, "pairwise_batch_forces")
    launches += 1
    return out
