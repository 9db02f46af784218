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
