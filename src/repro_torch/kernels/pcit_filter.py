"""B3: PCIT significance filter, hand-written CUDA.

Replaces the Pallas kernel ``repro/kernels/pcit_filter.py:
pcit_filter_pallas`` (body ``_pcit_kernel``), PCIT phase 4.  Source:
``repro_torch/csrc/pcit_filter.cu``.

What bounds it on the H100: fp32 arithmetic outside the tensor cores
(67 TFLOP/s; the repo counts 36 operations per visited (x, y, z) trio).
The TPU kernel evaluates every z of every tile and OR-reduces; here a
pair's search stops at its first explaining z, as the reference's loop
does, so the work done is what the data needs, not the full cube.  One
block owns 8 x 32 pairs: each pair's thread tries the first
:data:`HEAD_Z` z, then a warp takes each pair still searching and runs
32 consecutive z of it a step, one a lane, so a kept edge (which searches
every z) keeps all 32 lanes busy.  A provable prefilter of approximate
reciprocals decides most trios; the rest run the exact chain, compiled
without FMA contraction and with IEEE division and square root, so each
step rounds as the plain version's elementwise ops do (the argument is in
the source's header).  A decision can still flip where the plain
version's CUDA ops round otherwise, and only within a rounding error of
the boundary.

The plain version beside it is :func:`pcit_filter_plain`; the device
dispatch is :func:`repro_torch.kernels.ops.pcit_filter`.
"""

from __future__ import annotations

import torch

from . import _build
from .ref import pcit_filter as pcit_filter_plain

__all__ = ["pcit_filter_cuda", "pcit_filter_plain", "pcit_probe_cuda",
           "launch_grid", "launches", "HEAD_Z", "STATS"]

#: kernel launches since the count was last set to 0
launches = 0
#: pairs (x, y) a block owns: rows of x, columns of y
BLOCK_ROWS, BLOCK_COLS = 8, 32
#: z each pair's own thread tries before a warp takes the pair
HEAD_Z = 8
#: the counters ``stats`` receives, in order
STATS = ("issued_lane_trios", "prefilter_decided", "exact_decided")
_GRID_MAX_YZ = 65535


def launch_grid(B: int, M: int, N: int) -> tuple[int, int, int]:
    """The kernel's grid ``(ceil(N / 32), ceil(M / 8), B)``; raises where
    it passes CUDA's limits (65,535 for the last two)."""
    grid = (-(-N // BLOCK_COLS), -(-M // BLOCK_ROWS), B)
    if grid[1] > _GRID_MAX_YZ or grid[2] > _GRID_MAX_YZ:
        raise ValueError(f"B={B} or M={M} exceeds the launch grid "
                         f"({grid[2]} x {grid[1]} blocks, at most "
                         f"{_GRID_MAX_YZ} each)")
    return grid


def pcit_filter_cuda(r_xy, rows_x, rows_y, gx, gy, *,
                     visits: torch.Tensor | None = None,
                     stats: torch.Tensor | None = None,
                     prefilter: bool = True) -> torch.Tensor:
    """r_xy [B, M, N], rows_x [B, M, Z], rows_y [B, N, Z] float32; gx
    [B, M], gy [B, N] integer gene ids (the column index into the rows);
    all on one CUDA device.  Returns keep [B, M, N] bool.

    ``visits`` (an int32 [B, M, N] tensor) receives, per (x, y), how many z
    the search went through — the data-dependent work of the call, which a
    measurement needs for the kernel's bound.  ``stats`` (an int64 [3]
    tensor, zeroed here) receives the counters of :data:`STATS`.
    ``prefilter=False`` runs the exact chain on every trio (the same
    result; for measurement)."""
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
    for name, t, shape, dtype in (("visits", visits, (B, M, N), torch.int32),
                                  ("stats", stats, (len(STATS),),
                                   torch.int64)):
        if t is not None and (t.shape != shape or t.dtype != dtype
                              or t.device != r_xy.device
                              or not t.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous {dtype} "
                             f"{list(shape)} tensor on the inputs' device")
    launch_grid(B, M, N)
    _build.require_cuda("pcit_filter", r_xy, rows_x, rows_y, gx, gy)
    r_xy, rows_x, rows_y = (t.contiguous() for t in (r_xy, rows_x, rows_y))
    gx = gx.to(torch.int32).contiguous()
    gy = gy.to(torch.int32).contiguous()
    keep = torch.empty(B, M, N, dtype=torch.bool, device=r_xy.device)
    if stats is not None:
        stats.zero_()
    if keep.numel() == 0:
        return keep
    with torch.cuda.device(r_xy.device):
        rc = _build.library().repro_pcit_filter(
            r_xy.data_ptr(), rows_x.data_ptr(), rows_y.data_ptr(),
            gx.data_ptr(), gy.data_ptr(), keep.data_ptr(),
            None if visits is None else visits.data_ptr(),
            None if stats is None else stats.data_ptr(), B, M, N, Z,
            int(bool(prefilter)), _build.stream_of(r_xy))
    _build.check(rc, "pcit_filter")
    launches += 1
    return keep


def pcit_probe_cuda(a, b, c, *, exact: bool) -> torch.Tensor:
    """One trio per element of the float32 CUDA tensors a = r_xy, b = r_xz,
    c = r_yz (one shape): the exact chain's verdict (1 explained, 0 not)
    or, with ``exact=False``, the prefilter's (1, 0, or -1: left to the
    exact chain), as int32.  For tests and measurement; not a launch of
    the filter."""
    if not (a.shape == b.shape == c.shape):
        raise ValueError(f"a, b, c must have one shape, got {tuple(a.shape)},"
                         f" {tuple(b.shape)}, {tuple(c.shape)}")
    for t in (a, b, c):
        if t.dtype != torch.float32:
            raise ValueError(f"pcit_probe takes float32, got {t.dtype}")
    _build.require_cuda("pcit_probe", a, b, c)
    a, b, c = (t.contiguous() for t in (a, b, c))
    out = torch.empty(a.shape, dtype=torch.int32, device=a.device)
    with torch.cuda.device(a.device):
        rc = _build.library().repro_pcit_probe(
            a.data_ptr(), b.data_ptr(), c.data_ptr(), out.data_ptr(),
            a.numel(), int(bool(exact)), _build.stream_of(a))
    _build.check(rc, "pcit_probe")
    return out
