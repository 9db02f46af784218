"""B3: PCIT significance filter, hand-written CUDA.

Replaces the Pallas kernel ``repro/kernels/pcit_filter.py:
pcit_filter_pallas`` (body ``_pcit_kernel``), PCIT phase 4.  Source:
``repro_torch/csrc/pcit_filter.cu``.

What bounds it on the H100: fp32 arithmetic outside the tensor cores
(67 TFLOP/s; about 40 operations per visited (x, y, z) trio, with IEEE
divisions and square roots among them).  The TPU kernel evaluates every z
of every tile and OR-reduces; here one thread per (x, y) stops at the first
explaining z, as the reference's loop does, and a block stops once all of
its threads have stopped — the work done is what the data needs, not the
full cube.  The file is compiled without FMA contraction so that each step
rounds as the plain version's elementwise ops do; a decision can still
flip where the plain version's CUDA ops round otherwise, and only within
a rounding error of the boundary.

The plain version beside it is :func:`pcit_filter_plain`; the device
dispatch is :func:`repro_torch.kernels.ops.pcit_filter`.
"""

from __future__ import annotations

import torch

from . import _build
from .ref import pcit_filter as pcit_filter_plain

__all__ = ["pcit_filter_cuda", "pcit_filter_plain", "launches"]

#: kernel launches since the count was last set to 0
launches = 0


def pcit_filter_cuda(r_xy, rows_x, rows_y, gx, gy, *,
                     visits: torch.Tensor | None = None) -> torch.Tensor:
    """r_xy [B, M, N], rows_x [B, M, Z], rows_y [B, N, Z] float32; gx
    [B, M], gy [B, N] integer gene ids (the column index into the rows);
    all on one CUDA device.  Returns keep [B, M, N] bool.

    ``visits`` (an int32 [B, M, N] tensor) receives, per (x, y), how many z
    the search went through — the data-dependent work of the call, which a
    measurement needs for the kernel's bound."""
    global launches
    B, M, N = r_xy.shape
    Z = rows_x.shape[-1]
    if (rows_x.shape != (B, M, Z) or rows_y.shape != (B, N, Z)
            or gx.shape != (B, M) or gy.shape != (B, N)):
        raise ValueError(
            f"shapes do not fit: r_xy {tuple(r_xy.shape)}, rows_x "
            f"{tuple(rows_x.shape)}, rows_y {tuple(rows_y.shape)}, gx "
            f"{tuple(gx.shape)}, gy {tuple(gy.shape)}")
    for t in (r_xy, rows_x, rows_y):
        if t.dtype != torch.float32:
            raise ValueError(f"pcit_filter takes float32, got {t.dtype}")
    _build.require_cuda("pcit_filter", r_xy, rows_x, rows_y, gx, gy)
    r_xy, rows_x, rows_y = (t.contiguous() for t in (r_xy, rows_x, rows_y))
    gx = gx.to(torch.int32).contiguous()
    gy = gy.to(torch.int32).contiguous()
    keep = torch.empty(B, M, N, dtype=torch.bool, device=r_xy.device)
    if visits is not None and (visits.shape != (B, M, N)
                               or visits.dtype != torch.int32
                               or visits.device != r_xy.device
                               or not visits.is_contiguous()):
        raise ValueError("visits must be a contiguous int32 [B, M, N] "
                         "tensor on the inputs' device")
    if B > 65535 or -(-M // 8) > 65535:
        raise ValueError(f"B={B} or M={M} exceeds the launch grid")
    if keep.numel() == 0:
        return keep
    with torch.cuda.device(r_xy.device):
        rc = _build.library().repro_pcit_filter(
            r_xy.data_ptr(), rows_x.data_ptr(), rows_y.data_ptr(),
            gx.data_ptr(), gy.data_ptr(), keep.data_ptr(),
            None if visits is None else visits.data_ptr(), B, M, N, Z,
            _build.stream_of(r_xy))
    _build.check(rc, "pcit_filter")
    launches += 1
    return keep
