"""Plain PyTorch versions of the main path's kernels (the allclose targets).

Ports of ``repro/kernels/ref.py``.  Each function takes optional leading
batch dimensions (the simulated devices, or stacked tiles); the CUDA
kernels in this package are held against these on the card, and on the
CPU the dispatch in :mod:`repro_torch.kernels.ops` runs them directly.
"""

from __future__ import annotations

import math

import numpy as np
import torch

EPS = 1e-12
NEG_INF = -1e30
# shared "no candidate" index sentinel for every top-k path — cross-path
# index agreement depends on all of them using this exact value
IDX_SENTINEL = int(np.iinfo(np.int32).max)
QUERY_METRICS = ("dot", "l2")
# relative float32-accumulation slack folded into the certified
# quantization error bound (core/quant.py; DESIGN.md section 17)
FP_REL = 1e-6


def sort_by_score_index(k1: torch.Tensor, k2: torch.Tensor):
    """Ascending sort along the last axis by the key pair (k1, k2): a
    stable sort by the minor key, then a stable sort by the major key.
    With k1 = -score it is the (-score, index) total order of every top-k
    path."""
    order = torch.argsort(k2, dim=-1, stable=True)
    k1, k2 = k1.gather(-1, order), k2.gather(-1, order)
    order = torch.argsort(k1, dim=-1, stable=True)
    return k1.gather(-1, order), k2.gather(-1, order)


def topk_by_score_index(vals: torch.Tensor, idx: torch.Tensor, topk: int):
    """The first ``topk`` entries along the last axis under the (-score,
    index) total order, best first; needs at least ``topk`` entries and
    non-negative indices.

    The same selection as :func:`sort_by_score_index` followed by a slice,
    in one ``torch.topk`` over a packed int64 key: the score's bits mapped
    to a descending signed order in the high word, the index in the low
    word (-0.0 counts as 0.0, as the sort's float compare does)."""
    bits = (vals.float() + 0.0).view(torch.int32)
    ordered = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)
    key = ((~ordered).to(torch.int64) << 32) | idx.to(torch.int64)
    pos = torch.topk(key, topk, dim=-1, largest=False, sorted=True).indices
    return vals.gather(-1, pos), idx.gather(-1, pos)


def quant_eps_tile(delta_lo, delta_hi, l1_lo, l1_hi, *, dim: int,
                   metric: str = "dot") -> torch.Tensor:
    """Certified per-entry error bound of quantized score tiles (DESIGN.md
    section 17.2):

      |s_q - s_f32| <= d_lo*l1_hi + d_hi*l1_lo + 3*dim*d_lo*d_hi
                       + FP_REL*(l1_lo*l1_hi + 1)

    delta_lo / delta_hi: [...] per-block rounding steps (scalars for one
    tile); l1_lo [..., m] / l1_hi [..., n] f32 row L1 norms.  Returns the
    [..., m, n] bound, doubled for l2 (whose norms are stored exactly).
    The expression order is the reference's, so it rounds identically."""
    l1_lo = torch.as_tensor(l1_lo, dtype=torch.float32)
    l1_hi = torch.as_tensor(l1_hi, dtype=torch.float32, device=l1_lo.device)
    d_lo = torch.as_tensor(delta_lo, dtype=torch.float32,
                           device=l1_lo.device)[..., None, None]
    d_hi = torch.as_tensor(delta_hi, dtype=torch.float32,
                           device=l1_lo.device)[..., None, None]
    eps = (d_lo * l1_hi[..., None, :] + d_hi * l1_lo[..., :, None]
           + 3.0 * dim * d_lo * d_hi
           + FP_REL * (l1_lo[..., :, None] * l1_hi[..., None, :] + 1.0))
    if metric == "l2":
        eps = 2.0 * eps
    return eps


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
    q = quorum.reshape(-1, k, block, d)
    thr = torch.tensor(threshold, dtype=torch.float32, device=q.device)

    def strip(l, h, r0, r1):
        return tile_scores(q[:, l, r0:r1], q[:, h], metric), thr

    return _compact_pairs(strip, lead, block, lo, hi, meta, capacity,
                          block_rows, q.device)


def _compact_pairs(strip, lead, block: int, lo, hi, meta, capacity: int,
                   block_rows: int, dev):
    """The compaction of B5 and B7: ``strip(l, h, r0, r1)`` gives the
    scores [B, r1 - r0, block] of rows r0:r1 of slot l against slot h and
    the bound each must reach (broadcastable); entries are kept under the
    ownership rules and compacted in (pair, row, col) order."""
    B = int(np.prod(lead)) if lead else 1
    meta = torch.as_tensor(meta, device=dev).to(torch.int64).reshape(B, -1, 6)
    lo = torch.as_tensor(lo).reshape(-1).tolist()
    hi = torch.as_tensor(hi).reshape(-1).tolist()
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
            s, bound = strip(l, h, r0, r0 + len(rows))
            keep = (s >= bound) & (act == 1)[:, None, None]
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


def _q_operands(q, scale, sq):
    """Codes widened to float32 (exact for int8 and bf16) as [B, k, block,
    d], scales [B, k], squared norms [B, k, block], and the leading
    shape."""
    *lead, k, block, d = q.shape
    qf = q.reshape(-1, k, block, d).float()
    B = qf.shape[0]
    scale = torch.as_tensor(scale, dtype=torch.float32,
                            device=qf.device).reshape(B, k)
    sq = torch.as_tensor(sq, dtype=torch.float32,
                         device=qf.device).reshape(B, k, block)
    return qf, scale, sq, lead


def _q_dots(qf, scale, l, h, r0, r1):
    """Dequantized dots of rows r0:r1 of slot l against slot h, [B, rows,
    block]: the f32 product of the codes times ``s_l * s_h``."""
    return (qf[:, l, r0:r1] @ qf[:, h].transpose(-1, -2)) \
        * (scale[:, l] * scale[:, h])[:, None, None]


def pairwise_threshold_q(q, scale, delta, l1, sq, lo, hi, meta, *,
                         threshold: float, capacity: int, block_rows: int,
                         metric: str = "dot"):
    """Quantized sparse-join compaction with the widened keep band (B7;
    DESIGN.md section 17.3): q [..., k, block, d] int8 or bf16 codes;
    scale / delta [..., k] (or [..., k, 1]) per-block dequant scale and
    rounding step; l1 / sq [..., k, block] row L1 norms and exact squared
    norms of the original rows; lo / hi / meta as in
    :func:`pairwise_threshold`.  Scores are ``(q_l @ q_h^T) * (s_l *
    s_h)`` (l2: ``(2 s - sq_h) - sq_l``), and an entry is kept when
    ``score >= threshold - eps`` with eps from :func:`quant_eps_tile`.
    Compaction order, overflow contract and sentinels are B5's."""
    _check_metric(metric)
    qf, scale, sq, lead = _q_operands(q, scale, sq)
    B, k, block, d = qf.shape
    delta = torch.as_tensor(delta, dtype=torch.float32,
                            device=qf.device).reshape(B, k)
    l1 = torch.as_tensor(l1, dtype=torch.float32,
                         device=qf.device).reshape(B, k, block)

    def strip(l, h, r0, r1):
        s = _q_dots(qf, scale, l, h, r0, r1)
        if metric == "l2":
            s = (2.0 * s - sq[:, h][:, None, :]) - sq[:, l, r0:r1][:, :, None]
        eps = quant_eps_tile(delta[:, l], delta[:, h], l1[:, l, r0:r1],
                             l1[:, h], dim=d, metric=metric)
        return s, threshold - eps

    return _compact_pairs(strip, lead, block, lo, hi, meta, capacity,
                          block_rows, qf.device)


def pairwise_topk(quorum, lo, hi, meta, *, topk: int, block_rows: int,
                  metric: str = "dot"):
    """Per-slot running top-k lists over the scheduled tiles (B6; the k-NN
    graph's batched step, DESIGN.md section 12.3): quorum [..., k, block,
    d]; lo / hi [n_pairs] slot ids; meta [..., n_pairs, 6] int32 rows
    ``(active, is_self, ga, gb, nv_lo, nv_hi)``.  For each active tile the
    rows of the ``lo`` slot receive the ``hi`` block's valid rows as
    candidates and, unless it is a self tile (whose diagonal is excluded),
    the other way round, folded into per-slot [k, block, topk] lists under
    the (-score, index) order.  Both orientations of an l2 tile score
    ``(2 dot - |cand|^2) - |row|^2``.  Masked candidates are (NEG_INF,
    IDX_SENTINEL).  Returns ``(vals [..., k, block, topk] float32, idx
    [..., k, block, topk] int32)``; rows past a block's valid count carry
    lists too (callers slice them off)."""
    _check_metric(metric)
    quorum = quorum.float()
    *lead, k, block, d = quorum.shape
    q = quorum.reshape(-1, k, block, d)
    n2 = torch.sum(q * q, dim=-1)                         # [B, k, block]

    def strip(l, h, r0, r1):
        return q[:, l, r0:r1] @ q[:, h].transpose(-1, -2), n2[:, l], n2[:, h]

    return _topk_pairs(strip, lead, k, block, lo, hi, meta, topk,
                       block_rows, q.device, metric)


def pairwise_topk_q(q, scale, sq, lo, hi, meta, *, topk: int,
                    block_rows: int, metric: str = "dot"):
    """Quantized per-slot top-k lists (B8; DESIGN.md section 17.3): q
    [..., k, block, d] int8 or bf16 codes; scale [..., k] (or [..., k, 1])
    dequant scales; sq [..., k, block] exact squared row norms; lo / hi /
    meta as in :func:`pairwise_topk`.  Tiles are ``(q_l @ q_h^T) * (s_l *
    s_h)`` with the stored norms in the l2 formulas; merge order,
    sentinels and layout are B6's.  No error band: the caller certifies
    and rescores the lists (core/quant.py)."""
    _check_metric(metric)
    qf, scale, sq, lead = _q_operands(q, scale, sq)
    B, k, block, d = qf.shape

    def strip(l, h, r0, r1):
        return _q_dots(qf, scale, l, h, r0, r1), sq[:, l], sq[:, h]

    return _topk_pairs(strip, lead, k, block, lo, hi, meta, topk,
                       block_rows, qf.device, metric)


def _topk_pairs(strip, lead, k: int, block: int, lo, hi, meta, topk: int,
                block_rows: int, dev, metric: str):
    """The running-list fold of B6 and B8: ``strip(l, h, r0, r1)`` gives
    the dots [B, r1 - r0, block] of rows r0:r1 of slot l against slot h
    and both slots' squared norms [B, block].  Pairs are walked in order,
    in row strips of the lo slot; each strip's lo-side candidates merge
    into the lo rows' lists and its transposed hi-side candidates into
    the hi rows' lists (selection under a strict total order makes the
    merge order immaterial)."""
    B = int(np.prod(lead)) if lead else 1
    meta = torch.as_tensor(meta, device=dev).to(torch.int64).reshape(B, -1, 6)
    lo = torch.as_tensor(lo).reshape(-1).tolist()
    hi = torch.as_tensor(hi).reshape(-1).tolist()
    vals = torch.full((B, k, block, topk), NEG_INF, dtype=torch.float32,
                      device=dev)
    idx = torch.full((B, k, block, topk), IDX_SENTINEL, dtype=torch.int32,
                     device=dev)
    active_any = meta[:, :, 0].eq(1).any(0).tolist()
    rows_step = max(1, min(block, _THRESHOLD_STEP_ELEMS // max(1, B * block)))
    cols = torch.arange(block, device=dev)
    sent = torch.tensor(IDX_SENTINEL, dtype=torch.int32, device=dev)
    neg = torch.tensor(NEG_INF, dtype=torch.float32, device=dev)

    def merge(slot, rs, cv, ci):
        v = torch.cat([vals[:, slot, rs], cv], dim=-1)
        i = torch.cat([idx[:, slot, rs], ci], dim=-1)
        vals[:, slot, rs], idx[:, slot, rs] = topk_by_score_index(v, i, topk)

    for p, (l, h) in enumerate(zip(lo, hi)):
        if not active_any[p]:
            continue
        act, is_self, ga, gb, nv_lo, nv_hi = (meta[:, p, c, None, None]
                                              for c in range(6))
        on = act == 1
        for r0 in range(0, block, rows_step):
            r1 = min(block, r0 + rows_step)
            rows = torch.arange(r0, r1, device=dev)[:, None]
            dots, n2_l, n2_h = strip(l, h, r0, r1)
            if metric == "l2":
                t_lo = (2.0 * dots - n2_h[:, None, :]) - n2_l[:, r0:r1, None]
                t_hi = (2.0 * dots - n2_l[:, r0:r1, None]) - n2_h[:, None, :]
            else:
                t_lo = t_hi = dots
            # lo side: rows of slot l receive slot h's valid rows
            keep = on & (cols < nv_hi) & ((is_self == 0) | (rows != cols))
            merge(l, slice(r0, r1), torch.where(keep, t_lo, neg),
                  torch.where(keep, (gb * block_rows + cols).to(torch.int32),
                              sent))
            # hi side (transposed; a self tile contributes once)
            keep_t = (on & (is_self == 0) & (rows < nv_lo)).expand_as(t_hi)
            merge(h, slice(None), torch.where(keep_t, t_hi, neg)
                  .transpose(-1, -2),
                  torch.where(keep_t, (ga * block_rows + rows)
                              .to(torch.int32), sent).transpose(-1, -2))
    shape = tuple(lead) + (k, block, topk)
    return vals.reshape(shape), idx.reshape(shape)


# ---------------------------------------------------------------------------
# B9: flash attention;  B10: the SSD intra-chunk step
# ---------------------------------------------------------------------------

def causal_visible(Tq: int, Tk: int, device) -> torch.Tensor:
    """End-aligned causal visibility [Tq, Tk]: key j is visible to query i
    iff j <= i + Tk - Tq (``np.tril(ones, k=Tk - Tq)``)."""
    i = torch.arange(Tq, device=device)[:, None]
    j = torch.arange(Tk, device=device)[None, :]
    return j <= i + (Tk - Tq)


def _gqa_scores(q, k, causal: bool):
    """Scaled scores [B, KV, G, Tq, Tk] float32 with the NEG_INF causal
    mask; query head h reads kv head h // G."""
    B, Tq, H, hd = q.shape
    Tk, KV = k.shape[1], k.shape[2]
    qg = q.reshape(B, Tq, KV, H // KV, hd)
    s = torch.einsum("bqkgh,bskh->bkgqs", qg.float() / math.sqrt(hd),
                     k.float())
    if causal:
        s = torch.where(causal_visible(Tq, Tk, s.device), s, NEG_INF)
    return s


def flash_attention(q, k, v, *, causal: bool) -> torch.Tensor:
    """Plain attention (B9's normalized output): q [B, Tq, H, hd], k / v
    [B, Tk, KV, hd] -> [B, Tq, H, hd] in q's dtype; softmax in float32
    over end-aligned causal scores masked with the finite NEG_INF."""
    B, Tq, H, hd = q.shape
    w = torch.softmax(_gqa_scores(q, k, causal), dim=-1)
    o = torch.einsum("bkgqs,bskh->bkgqh", w, v.float())
    return o.reshape(B, H, Tq, hd).permute(0, 2, 1, 3).to(q.dtype)


def flash_attention_bwd(q, k, v, o, lse, do, *, causal: bool):
    """Plain gradient of :func:`flash_attention` (B9's backward): q / o /
    do [B, Tq, H, hd], k / v [B, Tk, KV, hd], lse [B, Tq, H] the forward's
    row log-sum-exp -> (dq, dk, dv) float32, dk / dv summed over each kv
    head's G query heads.  With the scale c = hd^-1/2 and S the masked
    scores of :func:`flash_attention`: D = rowsum(dO * O), P = exp(S -
    lse), dV = P^T dO, dS = P * (dO V^T - D), dQ = c dS K, dK = c dS^T Q.
    Masked scores get no gradient (dS = 0 there), and a row that sees no
    key (causal, Tq > Tk) has P = 1 / Tk on every key, as its forward
    averaged v."""
    B, Tq, H, hd = q.shape
    Tk, KV = k.shape[1], k.shape[2]
    G = H // KV
    c = 1.0 / math.sqrt(hd)
    qg = q.float().reshape(B, Tq, KV, G, hd)
    dog = do.float().reshape(B, Tq, KV, G, hd)
    lse_g = lse.float().reshape(B, Tq, KV, G).permute(0, 2, 3, 1)
    D = torch.sum(do.float() * o.float(), dim=-1)
    D = D.reshape(B, Tq, KV, G).permute(0, 2, 3, 1)          # [B, KV, G, Tq]
    p = torch.exp(_gqa_scores(q, k, causal) - lse_g[..., None])
    if causal:
        vis = causal_visible(Tq, Tk, q.device)
        none = ~vis.any(dim=-1)                              # [Tq]
        p = torch.where(none[:, None], 1.0 / Tk, torch.where(vis, p, 0.0))
    dv = torch.einsum("bkgqs,bqkgh->bskh", p, dog)
    dp = torch.einsum("bqkgh,bskh->bkgqs", dog, v.float())
    ds = p * (dp - D[..., None])
    if causal:
        ds = torch.where(vis, ds, 0.0)
    dq = torch.einsum("bkgqs,bskh->bqkgh", ds, k.float()) * c
    dk = torch.einsum("bkgqs,bqkgh->bskh", ds, qg) * c
    return dq.reshape(B, Tq, H, hd), dk, dv


def flash_block(q, k, v, *, causal: bool):
    """Plain partial attention (B9's partial epilogue;
    ``repro/apps/attention.py:flash_block``): q [B, Tq, H, hd], k / v
    [B, Tk, KV, hd] -> (o [B, Tq, H, hd] unnormalized, o = sum exp(s - m)
    v; m [B, Tq, H] row max; l [B, Tq, H] row sum-exp), float32.  With
    Tq == Tk the causal mask is the diagonal block's lower triangle."""
    B, Tq, H, hd = q.shape
    s = _gqa_scores(q, k, causal)
    m = torch.amax(s, dim=-1)
    p = torch.exp(s - m[..., None])
    l = torch.sum(p, dim=-1)
    o = torch.einsum("bkgqs,bskh->bkgqh", p, v.float())
    o = o.reshape(B, H, Tq, hd).permute(0, 2, 1, 3)
    m = m.reshape(B, H, Tq).permute(0, 2, 1)
    l = l.reshape(B, H, Tq).permute(0, 2, 1)
    return o, m, l


def ssd_intra_chunk(x, dt, A, Bm, Cm, *, chunk: int):
    """Plain SSD intra-chunk step (B10): x [B, T, H, P], dt [B, T, H], A
    [H], Bm / Cm [B, T, N], chunks of length ``chunk``.  Per chunk, with
    cums the inclusive cumsum of dt * A: y_i = sum_{j<=i} (C_i . B_j)
    exp(cums_i - cums_j) dt_j x_j, S = sum_j exp(cums_last - cums_j) dt_j
    B_j x_j^T and cd = exp(cums).  Returns (y [B, T, H, P], S [B, nc, H,
    N, P], cd [B, T, H]), float32."""
    Bsz, T, H, P = x.shape
    N = Bm.shape[-1]
    nc = T // chunk
    xc = x.float().reshape(Bsz, nc, chunk, H, P)
    dtc = dt.float().reshape(Bsz, nc, chunk, H)
    Bc = Bm.float().reshape(Bsz, nc, chunk, N)
    Cc = Cm.float().reshape(Bsz, nc, chunk, N)
    cums = torch.cumsum(dtc * A.float(), dim=2)             # [B, nc, L, H]
    CB = torch.einsum("bcln,bcmn->bclm", Cc, Bc)            # [B, nc, L, L]
    seg = cums[:, :, :, None, :] - cums[:, :, None, :, :]   # [B, nc, L, L, H]
    tril = torch.ones(chunk, chunk, dtype=torch.bool, device=x.device).tril()
    # masked before the exponent: above the diagonal seg may exceed 88, and
    # exp's gradient there would be 0 * inf (the decays are the same)
    decay = torch.exp(torch.where(tril[None, None, :, :, None], seg,
                                  -math.inf))
    W = CB[..., None] * decay * dtc[:, :, None, :, :]
    y = torch.einsum("bclmh,bcmhp->bclhp", W, xc).reshape(Bsz, T, H, P)
    dend = torch.exp(cums[:, :, -1:, :] - cums) * dtc
    S = torch.einsum("bclh,bcln,bclhp->bchnp", dend, Bc, xc)
    return y, S, torch.exp(cums).reshape(Bsz, T, H)


def ssd_intra_chunk_bwd(x, dt, A, Bm, Cm, dy, dS, dcd, *, chunk: int,
                        dtype=torch.float32):
    """Plain gradient of :func:`ssd_intra_chunk` (B10's backward): the
    forward's inputs, and the gradients dy [B, T, H, P], dS [B, nc, H, N,
    P] and dcd [B, T, H] of its outputs (None: zero).  Per (b, chunk, head)
    with W_ij = (C_i . B_j) exp(cums_i - cums_j) dt_j (j <= i), G = dy
    x^T, e_j = exp(cums_last - cums_j) and u_j = dS^T B_j:

      dx_j   = sum_{i>=j} W_ij dy_i + e_j dt_j u_j
      dCB_ij = sum_h G_ij exp(cums_i - cums_j) dt_j    (B, C are shared)
      dC = dCB B,  dB = dCB^T C + sum_h e_j dt_j dS x_j
      ddt_j  = sum_{i>=j} G_ij CB_ij exp(.) + e_j u_j . x_j + dla_j A
      dcums  = rowsum(G W) - colsum(G W) - e dt (u . x) (+ its sum on the
               last row) + dcd cd,   dla_k = sum_{i>=k} dcums_i,
      dA     = sum dla dt.

    Returns (dx [B, T, H, P], ddt [B, T, H], dA [H], dB [B, T, N], dC [B,
    T, N]) in ``dtype`` (float32; float64 for a reference gradient)."""
    Bsz, T, H, P = x.shape
    N = Bm.shape[-1]
    nc = T // chunk
    xc = x.to(dtype).reshape(Bsz, nc, chunk, H, P)
    dtc = dt.to(dtype).reshape(Bsz, nc, chunk, H)
    Bc = Bm.to(dtype).reshape(Bsz, nc, chunk, N)
    Cc = Cm.to(dtype).reshape(Bsz, nc, chunk, N)
    Af = A.to(dtype)
    cums = torch.cumsum(dtc * Af, dim=2)                    # [B, nc, L, H]
    CB = torch.einsum("bcln,bcmn->bclm", Cc, Bc)            # [B, nc, L, L]
    seg = cums[:, :, :, None, :] - cums[:, :, None, :, :]   # [B, nc, L, L, H]
    tril = torch.ones(chunk, chunk, dtype=torch.bool, device=x.device).tril()
    decay = torch.where(tril[None, None, :, :, None], torch.exp(seg), 0.0)
    dyc = (torch.zeros_like(xc) if dy is None
           else dy.to(dtype).reshape(Bsz, nc, chunk, H, P))
    G = torch.einsum("bcihp,bcjhp->bcijh", dyc, xc)         # dy_i . x_j
    GD = G * decay
    dCB = torch.einsum("bcijh,bcjh->bcij", GD, dtc)
    Q = GD * CB[..., None]                                  # G CB exp(.)
    M = Q * dtc[:, :, None, :, :]                           # G W
    W = CB[..., None] * decay * dtc[:, :, None, :, :]
    dx = torch.einsum("bcijh,bcihp->bcjhp", W, dyc)
    ddt = Q.sum(2)
    dcums = M.sum(3) - M.sum(2)
    dC = torch.einsum("bcij,bcjn->bcin", dCB, Bc)
    dB = torch.einsum("bcij,bcin->bcjn", dCB, Cc)
    if dS is not None:
        dSf = dS.to(dtype)
        e = torch.exp(cums[:, :, -1:, :] - cums)
        dend = e * dtc
        u = torch.einsum("bcjn,bchnp->bcjhp", Bc, dSf)
        ux = (u * xc).sum(-1)                               # [B, nc, L, H]
        dx = dx + dend[..., None] * u
        dB = dB + torch.einsum("bcjh,bchnp,bcjhp->bcjn", dend, dSf, xc)
        ddt = ddt + e * ux
        s = dend * ux
        dcums = dcums - s
        dcums[:, :, -1] += s.sum(2)
    if dcd is not None:
        dcums = dcums + dcd.to(dtype).reshape(Bsz, nc, chunk, H) \
            * torch.exp(cums)
    dla = torch.flip(torch.cumsum(torch.flip(dcums, [2]), 2), [2])
    ddt = ddt + dla * Af
    dA = (dla * dtc).sum((0, 1, 2))
    return (dx.reshape(Bsz, T, H, P), ddt.reshape(Bsz, T, H), dA,
            dB.reshape(Bsz, T, N), dC.reshape(Bsz, T, N))


def ssd_chunk(x, dt, A, Bm, Cm) -> torch.Tensor:
    """Sequential (non-chunked) SSD oracle: x [B, T, H, P]; dt [B, T, H];
    A [H]; Bm / Cm [B, T, N].  Returns y [B, T, H, P] float32."""
    Bsz, T, H, P = x.shape
    N = Bm.shape[-1]
    x, dt, Bm, Cm = x.float(), dt.float(), Bm.float(), Cm.float()
    h = torch.zeros(Bsz, H, N, P, dtype=torch.float32, device=x.device)
    ys = []
    for t in range(T):
        a = torch.exp(dt[:, t] * A)                          # [B, H]
        h = a[:, :, None, None] * h + torch.einsum(
            "bh,bn,bhp->bhnp", dt[:, t], Bm[:, t], x[:, t])
        ys.append(torch.einsum("bn,bhnp->bhp", Cm[:, t], h))
    return torch.stack(ys, dim=1)
