#!/usr/bin/env python3
"""Histogram of the PCIT filter's search lengths at chip_smoke.py's shape.

    python3 scripts/pcit_visits.py

Builds B3's operands as ``chip_smoke.py`` does (N = 8,192 genes, G = 512
samples, P = 8: 40 tiles of 1,024 x 1,024 pairs, Z = 8,192), runs
``pcit_filter_cuda`` with ``visits`` on the card and prints:

- the deciles and a log2 histogram of ``visits`` (first explaining z + 1,
  Z for a kept edge, 0 on the diagonal);
- the kernel's time with and without its prefilter, and its counters
  (``kernels.pcit_filter.STATS``);
- for each split point Z1, the lane-trios a two-phase design would issue:
  phase 1 gives each (x, y) a lane and a warp 32 consecutive y of one x,
  for at most Z1 z (a warp runs until its last lane stops); phase 2 puts
  the z of each pair still searching on a warp's 32 lanes, 32 z a step.
  Z1 = 0 is the lanes-only design.  The useful share is the visited
  trios over the issued ones.
"""

from __future__ import annotations

import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]


def lane_model(visits: torch.Tensor, z1: int) -> tuple[int, int]:
    """(issued lane-trios of phase 1, of phase 2) for split point z1."""
    v = visits.long()
    if z1 > 0:
        warp_max = v.reshape(-1, 32).amax(1).clamp(max=z1)
        p1 = int(warp_max.sum()) * 32
    else:
        p1 = 0
    rest = (v - z1).clamp(min=0)
    p2 = int(((rest + 31) // 32).sum()) * 32
    return p1, p2


def main() -> int:
    if not torch.cuda.is_available():
        print("FAIL: no CUDA device")
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from repro_torch.apps.pcit import standardize
    from repro_torch.core.scheduler import build_schedule
    from repro_torch.kernels.pcit_filter import STATS, pcit_filter_cuda

    sched = build_schedule(cs.P)
    Xs = standardize(cs.make_expression(cs.PCIT_N, cs.PCIT_G, cs.PCIT_RANK, 1))
    X = torch.as_tensor(Xs, device="cuda")
    C = X @ X.T
    r_xy, rows_x, rows_y, gx, gy = cs.pcit_tile_inputs(C, sched,
                                                       cs.PCIT_N // cs.P)
    visits = torch.empty(r_xy.shape, dtype=torch.int32, device="cuda")
    keep = pcit_filter_cuda(r_xy, rows_x, rows_y, gx, gy, visits=visits)
    Z = rows_x.shape[-1]
    v = visits.long().flatten()
    trios = int(v.sum())
    for pre in (True, False):
        stats = torch.empty(len(STATS), dtype=torch.int64, device="cuda")
        got = pcit_filter_cuda(r_xy, rows_x, rows_y, gx, gy, stats=stats,
                               prefilter=pre)
        st = dict(zip(STATS, stats.tolist()))
        ms = cs.cuda_ms(lambda: pcit_filter_cuda(r_xy, rows_x, rows_y, gx,
                                                 gy, prefilter=pre), reps=2)
        evaluated = st["prefilter_decided"] + st["exact_decided"]
        print(f"B3 prefilter={pre}: kernel {ms:.3f} ms, keep equal to the "
              f"default call: {bool(torch.equal(got, keep))}; {st}; useful "
              f"share of issued lane-trios {trios / st['issued_lane_trios']:.4f}"
              f", share of evaluated trios the prefilter decided "
              f"{st['prefilter_decided'] / evaluated:.6f}")
    live = v[v > 0].double()
    qs = torch.quantile(live[torch.randperm(live.numel(), device="cuda")
                             [:1 << 24]],
                        torch.linspace(0.1, 0.9, 9, device="cuda",
                                       dtype=torch.float64))
    print(f"B3 visits at {tuple(r_xy.shape)} x Z={Z}: kept "
          f"{float(keep.float().mean()):.4f}, visited {trios} trios; "
          f"deciles of visits (off the diagonal) "
          f"{[int(q) for q in qs.tolist()]}")
    nonkept = v[(v > 0) & keep.flatten().logical_not()]
    print(f"explained pairs: {nonkept.numel()}, mean visits "
          f"{float(nonkept.double().mean()):.2f}; kept pairs "
          f"{int(keep.sum())} make {int(v[keep.flatten()].sum())} trios")
    edges = [1, 2, 3, 5, 9, 17, 33, 65, 129, 257, 513, 1025, 2049, 4097,
             Z, Z + 1]
    counts = []
    for a, b in zip(edges[:-1], edges[1:]):
        counts.append(f"[{a},{b}) {int(((v >= a) & (v < b)).sum())}")
    print("histogram of visits: " + ", ".join(counts))
    for z1 in (0, 8, 16, 24, 32, 48, 64, 96, 128, 256):
        p1, p2 = lane_model(visits, z1)
        print(f"split Z1={z1}: phase 1 issues {p1}, phase 2 {p2} lane-trios,"
              f" survivors {int((v > z1).sum())}; useful share "
              f"{trios / (p1 + p2):.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
