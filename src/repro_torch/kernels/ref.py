"""Plain PyTorch versions of the main path's kernels (the allclose targets).

Ports of ``repro/kernels/ref.py``.  Each function takes optional leading
batch dimensions (the simulated devices, or stacked tiles); the CUDA
kernels in this package are held against these on the card, and on the
CPU the dispatch in :mod:`repro_torch.kernels.ops` runs them directly.
"""

from __future__ import annotations

import numpy as np
import torch

EPS = 1e-12
NEG_INF = -1e30
# shared "no candidate" index sentinel for every top-k path — cross-path
# index agreement depends on all of them using this exact value
IDX_SENTINEL = int(np.iinfo(np.int32).max)
QUERY_METRICS = ("dot", "l2")


def sort_by_score_index(k1: torch.Tensor, k2: torch.Tensor):
    """Ascending sort along the last axis by the key pair (k1, k2): a
    stable sort by the minor key, then a stable sort by the major key.
    With k1 = -score it is the (-score, index) total order of every top-k
    path."""
    order = torch.argsort(k2, dim=-1, stable=True)
    k1, k2 = k1.gather(-1, order), k2.gather(-1, order)
    order = torch.argsort(k1, dim=-1, stable=True)
    return k1.gather(-1, order), k2.gather(-1, order)


def pairwise_corr(xs_i: torch.Tensor, xs_j: torch.Tensor) -> torch.Tensor:
    """Correlation tile of standardized blocks: [..., bm, G] x [..., bn, G]
    -> [..., bm, bn] float32 (bf16 operands are widened first, which is
    exact)."""
    return xs_i.float() @ xs_j.float().transpose(-1, -2)


def pcit_filter(r_xy, rows_x, rows_y, gx, gy) -> torch.Tensor:
    """PCIT keep mask: r_xy [..., M, N], rows_x [..., M, Z], rows_y
    [..., N, Z], gx [..., M] / gy [..., N] global gene ids -> [..., M, N]
    bool.  Mirrors ``apps.pcit.pcit_tile`` of the reference op for op."""
    rxz = rows_x[..., :, None, :]
    ryz = rows_y[..., None, :, :]
    rxy = r_xy[..., :, :, None]
    den_z = torch.sqrt(torch.clamp((1 - rxz ** 2) * (1 - ryz ** 2), min=EPS))
    rxy_z = (rxy - rxz * ryz) / den_z
    den_y = torch.sqrt(torch.clamp((1 - rxy ** 2) * (1 - ryz ** 2), min=EPS))
    rxz_y = (rxz - rxy * ryz) / den_y
    den_x = torch.sqrt(torch.clamp((1 - rxy ** 2) * (1 - rxz ** 2), min=EPS))
    ryz_x = (ryz - rxy * rxz) / den_x
    eps = (rxy_z / (rxy + EPS) + rxz_y / (rxz + EPS)
           + ryz_x / (ryz + EPS)) / 3.0
    explained = ((torch.abs(rxy) <= torch.abs(eps * rxz))
                 & (torch.abs(rxy) <= torch.abs(eps * ryz)))
    z_ids = torch.arange(rows_x.shape[-1], device=rows_x.device)
    explained &= ((z_ids != gx[..., :, None, None])
                  & (z_ids != gy[..., None, :, None]))
    keep = ~torch.any(explained, dim=-1)
    keep |= gx[..., :, None] == gy[..., None, :]
    return keep


def nbody_pair(bi: torch.Tensor, bj: torch.Tensor, softening: float):
    """Softened gravity between body blocks [..., m, 4] and [..., n, 4]
    (x, y, z, mass).  Returns (force on bi [..., m, 3], force on bj
    [..., n, 3]); each pair is formed once (Newton's third law)."""
    pi, mi = bi[..., :3], bi[..., 3]
    pj, mj = bj[..., :3], bj[..., 3]
    d = pj[..., None, :, :] - pi[..., :, None, :]          # [..., m, n, 3]
    r2 = torch.sum(d * d, dim=-1) + softening
    inv_r3 = torch.rsqrt(r2) / r2
    w = (mi[..., :, None] * mj[..., None, :] * inv_r3)[..., None]
    f_ij = w * d                                           # force ON i FROM j
    return torch.sum(f_ij, dim=-2), -torch.sum(f_ij, dim=-3)


def pairwise_batch_forces(quorum, lo, hi, wi, wj, *,
                          softening: float = 1e-2) -> torch.Tensor:
    """Batched n-body slot accumulation: quorum [B, k, block, 4]; lo/hi
    [n_pairs] slot ids; wi/wj [B, n_pairs] per-side weights.  Returns
    [B, k, block, 3] float32: slot lo gathers ``wi * out_i`` and slot hi
    ``wj * out_j`` of every pair, in pair order.  Pairs are formed one at
    a time, so the working set is one [B, block, block, 3] tile."""
    q = quorum.float()
    B, k, block, _ = q.shape
    lo = torch.as_tensor(lo).tolist()
    hi = torch.as_tensor(hi).tolist()
    wi = torch.as_tensor(wi, dtype=torch.float32, device=q.device)
    wj = torch.as_tensor(wj, dtype=torch.float32, device=q.device)
    acc = torch.zeros(B, k, block, 3, dtype=torch.float32, device=q.device)
    for n, (l, h) in enumerate(zip(lo, hi)):
        f_i, f_j = nbody_pair(q[:, l], q[:, h], softening)
        acc[:, l] += f_i * wi[:, n, None, None]
        acc[:, h] += f_j * wj[:, n, None, None]
    return acc


def _check_metric(metric: str) -> None:
    if metric not in QUERY_METRICS:
        raise ValueError(f"metric must be one of {QUERY_METRICS}, "
                         f"got {metric!r}")


def query_topk(stack, queries, mask, gidx, *, topk: int,
               metric: str = "dot"):
    """Fused query-scoring top-k (B4): stack [..., k, block, d]; queries
    [Q, d] shared by every leading entry; mask [..., k, block] (> 0 =
    score the row); gidx [..., k, block] global row ids.  Scores are
    ``q.x`` or ``2 q.x - |x|^2 - |q|^2`` (l2); selection is by the
    (-score, index) total order, masked rows and missing candidates are
    (NEG_INF, IDX_SENTINEL).  Returns (values [..., Q, topk] float32,
    indices [..., Q, topk] int32)."""
    _check_metric(metric)
    stack = stack.float()
    q = queries.float()
    *lead, k, block, _d = stack.shape
    Q = q.shape[0]
    s = torch.einsum("qd,...sbd->...qsb", q, stack)
    if metric == "l2":
        s = (2.0 * s - torch.sum(stack * stack, dim=-1)[..., None, :, :]
             - torch.sum(q * q, dim=-1)[:, None, None])
    valid = torch.as_tensor(mask, device=stack.device) > 0
    s = torch.where(valid[..., None, :, :], s,
                    torch.full_like(s, NEG_INF)).reshape(*lead, Q, k * block)
    ids = torch.where(valid, torch.as_tensor(gidx, device=stack.device)
                      .to(torch.int32), IDX_SENTINEL)
    ids = ids.reshape(*lead, 1, k * block).expand(*lead, Q, k * block)
    n = k * block
    if n < topk:
        pad = (0, topk - n)
        s = torch.nn.functional.pad(s, pad, value=NEG_INF)
        ids = torch.nn.functional.pad(ids, pad, value=IDX_SENTINEL)
    sv, si = sort_by_score_index(-s, ids)
    return -sv[..., :topk], si[..., :topk]


def tile_scores(bi: torch.Tensor, bj: torch.Tensor, metric: str):
    """[..., m, d] x [..., n, d] -> [..., m, n] under the join metric: the
    dot, or ``2 x.y - |y|^2 - |x|^2`` (l2) — one formula for the join, the
    serving engine and both kernels, so threshold membership agrees."""
    dot = bi @ bj.transpose(-1, -2)
    if metric == "dot":
        return dot
    return (2.0 * dot - torch.sum(bj * bj, dim=-1)[..., None, :]
            - torch.sum(bi * bi, dim=-1)[..., :, None])


# score-tile elements per step of the plain join compaction (bounds its
# working set at the main path's [P, block, block] tiles)
_THRESHOLD_STEP_ELEMS = 1 << 26


def pairwise_threshold(quorum, lo, hi, meta, *, threshold: float,
                       capacity: int, block_rows: int, metric: str = "dot"):
    """Thresholded sparse-join compaction (B5): quorum [..., k, block, d];
    lo / hi [n_pairs] slot ids; meta [..., n_pairs, 6] int32 rows
    ``(active, is_self, ga, gb, nv_lo, nv_hi)``.  Each passing entry of an
    active tile — score >= threshold, row < nv_lo, col < nv_hi, and row <
    col on a self tile — is emitted as ``(score, min_gid, max_gid)`` with
    ``gid = g * block_rows + row``, compacted in (pair, row, col) order
    into [capacity] buffers; entries past capacity are dropped while the
    count keeps the true total (the overflow contract).  Returns
    ``(vals [..., capacity] float32, i / j [..., capacity] int32, count
    [...] int32)``; unused slots are (NEG_INF, IDX_SENTINEL).

    Tiles are formed pair by pair in row strips, so the working set stays
    bounded; a pair no leading entry has active is skipped."""
    _check_metric(metric)
    quorum = quorum.float()
    *lead, k, block, d = quorum.shape
    dev = quorum.device
    q = quorum.reshape(-1, k, block, d)
    B = q.shape[0]
    meta = torch.as_tensor(meta, device=dev).to(torch.int64).reshape(B, -1, 6)
    lo = torch.as_tensor(lo).reshape(-1).tolist()
    hi = torch.as_tensor(hi).reshape(-1).tolist()
    thr = torch.tensor(threshold, dtype=torch.float32, device=dev)
    vbuf = torch.full((B, capacity + 1), NEG_INF, dtype=torch.float32,
                      device=dev)
    ibuf = torch.full((B, capacity + 1), IDX_SENTINEL, dtype=torch.int32,
                      device=dev)
    jbuf = torch.full_like(ibuf, IDX_SENTINEL)
    count = torch.zeros(B, dtype=torch.int64, device=dev)
    active_any = meta[:, :, 0].eq(1).any(0).tolist()
    rows_step = max(1, min(block, _THRESHOLD_STEP_ELEMS // max(1, B * block)))
    cols = torch.arange(block, device=dev)
    for p, (l, h) in enumerate(zip(lo, hi)):
        if not active_any[p]:
            continue
        act, is_self, ga, gb, nv_lo, nv_hi = (meta[:, p, c] for c in range(6))
        for r0 in range(0, block, rows_step):
            rows = torch.arange(r0, min(block, r0 + rows_step), device=dev)
            s = tile_scores(q[:, l, r0:r0 + len(rows)], q[:, h], metric)
            keep = (s >= thr) & (act == 1)[:, None, None]
            keep &= ((rows[:, None] < nv_lo[:, None, None])
                     & (cols[None, :] < nv_hi[:, None, None]))
            keep &= (is_self == 0)[:, None, None] | (rows[:, None]
                                                      < cols[None, :])
            gi = ga[:, None, None] * block_rows + rows[:, None]
            gj = gb[:, None, None] * block_rows + cols[None, :]
            keep = keep.reshape(B, -1)
            pos = count[:, None] + torch.cumsum(keep, dim=1) - 1
            pos = torch.where(keep & (pos < capacity), pos, capacity)
            vbuf.scatter_(1, pos, s.reshape(B, -1))
            ibuf.scatter_(1, pos, torch.minimum(gi, gj).reshape(B, -1)
                          .to(torch.int32))
            jbuf.scatter_(1, pos, torch.maximum(gi, gj).reshape(B, -1)
                          .to(torch.int32))
            count += keep.sum(1)
    out = (vbuf[:, :capacity], ibuf[:, :capacity], jbuf[:, :capacity],
           count.to(torch.int32))
    return tuple(t.reshape(tuple(lead) + tuple(t.shape[1:])) for t in out)
