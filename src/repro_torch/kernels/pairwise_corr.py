"""B2: batched correlation tiles, hand-written CUDA.

Replaces the Pallas kernel ``repro/kernels/pairwise_corr.py:
pairwise_corr_pallas`` (body ``_corr_kernel``), PCIT phase 2.  Source:
``repro_torch/csrc/pairwise_corr.cu``.

What bounds it on the H100: fp32 arithmetic outside the tensor cores
(67 TFLOP/s; 2*M*N*G flops per tile).  Tensor cores are ruled out: TF32
keeps about three digits where the PCIT filter makes threshold decisions,
and any reordered sum (3xTF32, split-K) moves near-zero outputs by about
1e-5.  So each output is one ``fmaf`` chain over k in order, and the
design is a register-blocked SIMT GEMM: 128 x 128 output tiles, 8 x 16 per
thread fed by float4 shared-memory reads, K slices of 32 through a
3-stage ``cp.async`` ring.  One launch covers every stacked tile (all
devices and pairs of the batched mode).

The plain version beside it is :func:`pairwise_corr_plain`; the device
dispatch is :func:`repro_torch.kernels.ops.pairwise_corr`.
"""

from __future__ import annotations

import torch

from . import _build
from .ref import pairwise_corr as pairwise_corr_plain

__all__ = ["pairwise_corr_cuda", "pairwise_corr_plain", "launches"]

#: kernel launches since the count was last set to 0
launches = 0


def pairwise_corr_cuda(xs_i: torch.Tensor, xs_j: torch.Tensor) -> torch.Tensor:
    """xs_i [B, M, G], xs_j [B, N, G] (float32, or bfloat16 widened
    exactly to float32) on a CUDA device -> [B, M, N] float32."""
    global launches
    if xs_i.dim() != 3 or xs_j.dim() != 3 or xs_i.shape[0] != xs_j.shape[0] \
            or xs_i.shape[2] != xs_j.shape[2]:
        raise ValueError(f"need [B, M, G] x [B, N, G], got "
                         f"{tuple(xs_i.shape)} x {tuple(xs_j.shape)}")
    for t in (xs_i, xs_j):
        if t.dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"pairwise_corr takes float32 or bfloat16, got "
                             f"{t.dtype}")
    _build.require_cuda("pairwise_corr", xs_i, xs_j)
    a = xs_i.float().contiguous()
    b = xs_j.float().contiguous()
    B, M, G = a.shape
    N = b.shape[1]
    out = torch.empty(B, M, N, dtype=torch.float32, device=a.device)
    if B > 65535 or -(-M // 128) > 65535:
        raise ValueError(f"B={B} or M={M} exceeds the launch grid")
    if out.numel() == 0:
        return out
    with torch.cuda.device(a.device):
        rc = _build.library().repro_pairwise_corr(
            a.data_ptr(), b.data_ptr(), out.data_ptr(), B, M, N, G,
            _build.stream_of(a))
    _build.check(rc, "pairwise_corr")
    launches += 1
    return out
