"""PCIT (partial correlation + information theory) on the port's quorum
engine — the paper's section 5 application; counterpart of
``repro/apps/pcit.py``.

  phase 1  quorum-gather the standardized expression blocks
  phase 2  per owned block pair: correlation tile r = Xs_x @ Xs_y^T
           (kernel B2, ``kernels/pairwise_corr.py``, with use_kernels)
  phase 3  tile -> row assembly: strip writes + quorum_scatter(sum) give
           every block owner its full correlation rows [block, N]
  phase 4  per owned pair: the PCIT filter over all z (kernel B3,
           ``kernels/pcit_filter.py``), then the same strip / scatter route
           returns the keep rows to each block owner.

Every per-device tensor carries the comm layer's leading axis over the L
devices this process holds (L = P in one process, 1 a rank under
``DistributedComm``).
Oracle: :func:`pcit_reference`, the direct O(N^3) numpy implementation of
Reverter & Chan (2008).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..core.comm import Comm, shard, unshard
from ..core.scheduler import PairSchedule, build_schedule
from ..core.sweep import (env_mode_override, pair_mask_table,
                          pair_ready_order, quorum_gather, quorum_scatter)
from ..kernels import ref as kref

EPS = 1e-12


# ---------------------------------------------------------------------------
# Reference implementation (numpy, single node)
# ---------------------------------------------------------------------------

def standardize(X: np.ndarray) -> np.ndarray:
    """Rows -> zero mean, unit norm, so corr = Xs @ Xs.T exactly."""
    Xc = X - X.mean(axis=1, keepdims=True)
    nrm = np.linalg.norm(Xc, axis=1, keepdims=True)
    return Xc / np.maximum(nrm, EPS)


def correlation_reference(X: np.ndarray) -> np.ndarray:
    """Numpy correlation-matrix oracle over standardized rows."""
    Xs = standardize(X)
    return Xs @ Xs.T


def pcit_reference(X: np.ndarray) -> np.ndarray:
    """Direct PCIT: keep[x, y] iff no z explains the (x, y) correlation.

    For each trio (x, y, z):
      r_xy.z = (r_xy - r_xz r_yz) / sqrt((1-r_xz^2)(1-r_yz^2))
      eps    = (r_xy.z/r_xy + r_xz.y/r_xz + r_yz.x/r_yz) / 3
      edge (x, y) is explained by z if |r_xy| <= |eps * r_xz| and
                                       |r_xy| <= |eps * r_yz|.
    """
    r = correlation_reference(X)
    N = r.shape[0]
    keep = np.ones((N, N), bool)

    def pc(a, b, c):  # r_ab.c
        den = np.sqrt(max((1 - r[a, c] ** 2) * (1 - r[b, c] ** 2), EPS))
        return (r[a, b] - r[a, c] * r[b, c]) / den

    for x in range(N):
        for y in range(N):
            if x == y:
                continue
            for z in range(N):
                if z == x or z == y:
                    continue
                rxy_z = pc(x, y, z)
                rxz_y = pc(x, z, y)
                ryz_x = pc(y, z, x)
                eps = (rxy_z / (r[x, y] + EPS) + rxz_y / (r[x, z] + EPS)
                       + ryz_x / (r[y, z] + EPS)) / 3.0
                if (abs(r[x, y]) <= abs(eps * r[x, z])
                        and abs(r[x, y]) <= abs(eps * r[y, z])):
                    keep[x, y] = False
                    break
    np.fill_diagonal(keep, True)
    return keep


# ---------------------------------------------------------------------------
# Tile primitives (plain PyTorch; kernels B2 / B3 replace them)
# ---------------------------------------------------------------------------

def corr_tile(xs_i: torch.Tensor, xs_j: torch.Tensor) -> torch.Tensor:
    """Correlation tiles between standardized blocks [..., bm, G] x
    [..., bn, G]."""
    return xs_i @ xs_j.transpose(-1, -2)


def pcit_tile(r_xy, rows_x, rows_y, gx, gy) -> torch.Tensor:
    """PCIT keep mask of tiles: r_xy [..., bm, bn] direct correlations,
    rows_x [..., bm, N] / rows_y [..., bn, N] correlation rows, gx / gy
    global gene ids (z == x and z == y are excluded).  Returns bool
    [..., bm, bn]."""
    return kref.pcit_filter(r_xy, rows_x, rows_y, gx, gy)


# ---------------------------------------------------------------------------
# Distributed quorum PCIT
# ---------------------------------------------------------------------------

def _tile_strips(make_tile, source: torch.Tensor, *, schedule: PairSchedule,
                 comm: Comm, mask: torch.Tensor, mode: str,
                 out_dtype) -> torch.Tensor:
    """Gather ``source`` [L, block, F] (the L = ``len(comm.local)`` local
    devices' blocks) over the quorum and assemble the masked per-slot
    [L, k, block, N] tile strips (DESIGN.md 3.2), under the engine's modes:

      * ``batched`` — every (device, pair) tile in one ``make_tile`` call
        over the gathered stack (one kernel launch for all of them),
      * ``overlap`` — each pair's tiles (all L devices at once) as soon as
        its later slot lands,
      * ``scan``    — one pair at a time over the gathered stack.

    ``make_tile(lo_blk, hi_blk, glo, ghi) -> [B, block, block]`` takes
    [B, block, F] blocks and their [B] global block ids.  The (lo, hi)
    pair's tile lands at strip[lo][:, ghi*block:...] and its transpose at
    strip[hi][:, glo*block:...]; the column offsets differ from device to
    device (glo = (i + shifts[lo]) % P, i the global device id).  Self
    pairs write once.
    """
    P, k, n_pairs = schedule.P, schedule.k, schedule.n_pairs
    L, block = source.shape[:2]
    dev = source.device
    ar = torch.arange(L, device=dev)                  # local positions
    gid = comm.axis_index().to(dev)                   # their global ids
    lo_np = schedule.pair_slots[:, 0]
    hi_np = schedule.pair_slots[:, 1]
    shifts = torch.as_tensor(schedule.shifts, dtype=torch.long, device=dev)
    lo_t = torch.as_tensor(lo_np, dtype=torch.long, device=dev)
    hi_t = torch.as_tensor(hi_np, dtype=torch.long, device=dev)
    glo = (gid[None, :] + shifts[lo_t][:, None]) % P        # [n_pairs, L]
    ghi = (gid[None, :] + shifts[hi_t][:, None]) % P

    strips = torch.zeros(L, k, block, P * block, dtype=out_dtype, device=dev)
    tiles5 = strips.view(L, k, block, P, block)  # column blocks split out

    def put(idx: int, tile: torch.Tensor) -> None:
        lo, hi = int(lo_np[idx]), int(hi_np[idx])
        tile = (tile * mask[:, idx, None, None]).to(out_dtype)
        tiles5[ar, lo, :, ghi[idx]] = tile
        if lo != hi:  # self pair: the transpose write would double it
            tiles5[ar, hi, :, glo[idx]] += tile.transpose(1, 2)

    if mode == "batched":
        xq = quorum_gather(source, schedule, comm)      # [L, k, block, F]
        F = xq.shape[-1]
        tiles = make_tile(xq[:, lo_t].reshape(L * n_pairs, block, F),
                          xq[:, hi_t].reshape(L * n_pairs, block, F),
                          glo.T.reshape(-1), ghi.T.reshape(-1))
        tiles = tiles.reshape(L, n_pairs, block, block)
        for idx in range(n_pairs):
            put(idx, tiles[:, idx])
    elif mode == "overlap":
        ready = pair_ready_order(schedule)
        landed: list = []

        def on_land(slot, blk):
            landed.append(blk)
            for idx in ready[slot]:
                put(idx, make_tile(landed[int(lo_np[idx])],
                                   landed[int(hi_np[idx])],
                                   glo[idx], ghi[idx]))

        quorum_gather(source, schedule, comm, overlap_fn=on_land)
    elif mode == "scan":
        xq = quorum_gather(source, schedule, comm)
        for idx in range(n_pairs):
            put(idx, make_tile(xq[:, int(lo_np[idx])], xq[:, int(hi_np[idx])],
                               glo[idx], ghi[idx]))
    else:
        raise ValueError(f"unknown mode {mode!r}")
    return strips


def quorum_pcit_local(xs_blocks: torch.Tensor, mask: torch.Tensor, *,
                      schedule: PairSchedule, comm: Comm,
                      use_kernels: bool = False,
                      mode: str = "auto") -> Tuple[torch.Tensor, torch.Tensor]:
    """The per-device pipeline for the L = ``len(comm.local)`` devices this
    process holds: xs_blocks [L, block, G] standardized rows (local device
    i's block, global block ``comm.local[i]``), mask [L, n_pairs] those
    devices' rows of the dedup mask.  ``mode`` is the engine mode of both tile phases; ``auto`` is the
    environment override, else batched while the pair count is small
    (<= 32) and scan beyond.

    Returns (corr_rows [L, block, N] float32, keep_rows [L, block, N] bool).
    """
    if use_kernels:
        from ..kernels import ops as kops
        _corr, _pcit = kops.pairwise_corr, kops.pcit_filter
    else:
        _corr, _pcit = corr_tile, pcit_tile

    if mode == "auto":
        mode = env_mode_override() or (
            "batched" if schedule.n_pairs <= 32 else "scan")
    if mode not in ("scan", "batched", "overlap"):
        raise ValueError(f"unknown mode {mode!r}")

    P = schedule.P
    L, block = xs_blocks.shape[:2]
    mask = mask.reshape(L, schedule.n_pairs).to(xs_blocks.device)
    base_ids = torch.arange(block, device=xs_blocks.device)

    # ---- phase 2+3: correlation tiles -> row strips ----------------------
    strips = _tile_strips(lambda bx, by, glo, ghi: _corr(bx, by), xs_blocks,
                          schedule=schedule, comm=comm, mask=mask, mode=mode,
                          out_dtype=xs_blocks.dtype)
    corr_rows = quorum_scatter(strips, schedule, comm)       # [L, block, N]
    del strips

    # ---- phase 4: PCIT filter tiles -> keep strips -----------------------
    def pcit_make(rows_x, rows_y, glo, ghi):
        B = rows_x.shape[0]
        cols = rows_x.unflatten(-1, (P, block))              # [B, bm, P, bn]
        r_xy = cols[torch.arange(B, device=cols.device), :, ghi]
        gx = glo[:, None] * block + base_ids
        gy = ghi[:, None] * block + base_ids
        return _pcit(r_xy, rows_x, rows_y, gx, gy).to(torch.float32)

    keep_strips = _tile_strips(pcit_make, corr_rows, schedule=schedule,
                               comm=comm, mask=mask, mode=mode,
                               out_dtype=torch.float32)
    keep_rows = quorum_scatter(keep_strips, schedule, comm) > 0.5
    return corr_rows, keep_rows


def run_quorum_pcit(X: np.ndarray, comm: Comm,
                    use_kernels: bool = False, mode: str = "auto"):
    """Driver: standardize on the host, shard rows over ``comm``'s P
    devices (each process moves only its own rows to its device), run the
    quorum pipeline.

    X: [N, G] expression matrix; N must divide by P.  Returns (corr, keep)
    on ``comm.device``: the rows of the devices this process holds,
    [N, N] float32 and bool in one process, rows ``r*N/P : (r+1)*N/P``
    ([N/P, N]) on rank r under ``DistributedComm``.
    """
    P = comm.P
    N = X.shape[0]
    if N % P:
        raise ValueError(f"N={N} does not divide by P={P}")
    sched = build_schedule(P)
    masks = comm.local_rows(torch.as_tensor(pair_mask_table(sched)))
    Xs = standardize(np.asarray(X, np.float32))
    corr, keep = quorum_pcit_local(shard(Xs, comm), masks, schedule=sched,
                                   comm=comm, use_kernels=use_kernels,
                                   mode=mode)
    return unshard(corr), unshard(keep)
