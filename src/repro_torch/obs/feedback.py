"""The Rocket feedback loop: measured per-device throughput becomes the
capacity weights of weighted pair ownership (port of
``repro/obs/feedback.py``, DESIGN.md section 14.5).

``Placement.owner_of(weights=...)`` partitions the pairs by capacity
(Rocket's heterogeneity model, arXiv:2009.04755); this module feeds it
from the metrics the fault-tolerant sweep already records:

  1. a sweep runs and :class:`core.faults.RecoveryStats` accumulates
     per-device pairs computed and busy time (virtual busy time is
     deterministic — ``rows_x * rows_y * slow_factor`` per pair — so the
     derived weights are reproducible bit for bit);
  2. :func:`throughput_weights` turns (pairs, busy) into a normalized
     per-device throughput vector;
  3. the next sweep passes that vector as ``weights=`` and the slowed
     device owns proportionally fewer pairs — while the *result* stays
     bit-exact, because ownership only decides *where* a pure partial is
     computed, never its value or the canonical fold order.

:func:`feedback_selfcheck` (CLI: ``python -m repro_torch.obs.feedback``)
asserts exactly that.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

from ..core import faults as faults_mod
from ..core.placement import supported_placements

__all__ = [
    "throughput_weights",
    "weights_from_stats",
    "feedback_selfcheck",
]


def throughput_weights(pairs_by_device: Dict[int, float],
                       busy_by_device: Dict[int, float],
                       P: int) -> List[float]:
    """Per-device capacity weights from measured work: throughput_c =
    pairs_c / busy_c, normalized to mean 1.

    A device with no observations (it owned no pairs — e.g. it was dead)
    gets the observed mean, i.e. weight 1.0: no evidence means assume
    average capacity, not zero.  Raises ValueError on a non-positive busy
    time for a device that computed pairs.
    """
    tput: Dict[int, float] = {}
    for d, n in pairs_by_device.items():
        if n <= 0:
            continue
        busy = busy_by_device.get(d, 0.0)
        if busy <= 0.0:
            raise ValueError(
                f"device {d} computed {n} pairs with busy time {busy!r}")
        tput[int(d)] = float(n) / float(busy)
    if not tput:
        return [1.0] * P
    mean = sum(tput.values()) / len(tput)
    return [tput.get(d, mean) / mean for d in range(P)]


def weights_from_stats(stats, P: int) -> List[float]:
    """Capacity weights out of a sweep's :class:`core.faults.RecoveryStats`
    (the deterministic virtual busy time, so the same fault history always
    yields the same weights)."""
    return throughput_weights(stats.pairs_by_device, stats.busy_by_device,
                              P)


def feedback_selfcheck(P: int = 8, slow_factor: float = 4.0,
                       slow_device: int = 2, mode: str = "batched",
                       placements: Optional[Sequence[str]] = None,
                       device=None, verbose: bool = True) -> int:
    """The closed-loop check: slow one device ``slow_factor`` x through the
    faults harness, derive throughput weights from the sweep, run again
    with ``weights=`` — the slowed device must own at most its
    proportional share ``ceil(total * w / sum(w))`` of pairs (strictly
    fewer than before), and the output must stay bit-exact against both
    the unweighted run and the brute-force oracle.  The blocks live on
    ``device`` (default the CUDA device).  Returns the number of
    placements checked."""
    n_checked = 0
    for plc in supported_placements(P):
        if placements is not None and plc.name not in placements:
            continue
        if plc.full:
            continue  # no quorum schedule to drive the faults harness
        # equal-size blocks so virtual throughput is exactly 1/factor
        wl = faults_mod.DenseReduceWorkload(P, n_items=8 * P, device=device)
        plan = faults_mod.FaultPlan(events=(
            faults_mod.FaultEvent("slow", 0, slow_device,
                                  factor=slow_factor),))

        out1, stats1 = faults_mod.run_fault_tolerant_sweep(
            wl, plc, mode, plan)
        wl.check_oracle(out1)
        weights = weights_from_stats(stats1, P)
        fast = next(d for d in range(P) if d != slow_device)
        if abs(weights[fast] - slow_factor * weights[slow_device]) >= 1e-9:
            raise AssertionError(
                f"virtual throughput ratio must be exactly {slow_factor}, "
                f"got weights={weights}")

        out2, stats2 = faults_mod.run_fault_tolerant_sweep(
            wl, plc, mode, plan, weights=weights)
        if not wl.equal(out1, out2):
            raise AssertionError(f"{plc.name}: reweighted output not "
                                 f"bit-exact")

        total = len(wl.canonical_pairs())
        before = stats1.pairs_by_device.get(slow_device, 0)
        after = stats2.pairs_by_device.get(slow_device, 0)
        cap = math.ceil(total * weights[slow_device] / sum(weights))
        if after > cap:
            raise AssertionError(f"{plc.name}: slowed device owns {after} "
                                 f"pairs > proportional cap {cap}")
        if after >= before:
            raise AssertionError(f"{plc.name}: slowed device share did not "
                                 f"shrink ({before} -> {after})")
        n_checked += 1
        if verbose:
            print(f"  feedback {plc.name:10s} P={P:<3d} {mode:7s}: "
                  f"slow dev {slow_device} x{slow_factor:g} -> "
                  f"{before} -> {after} pairs (cap {cap}, "
                  f"total {total}), bit-exact OK")
    if verbose:
        print(f"feedback selfcheck OK ({n_checked} placements at P={P}: "
              f"slowed device's share shrank proportionally, output "
              f"bit-exact)")
    return n_checked


def _main(argv=None) -> int:
    """CLI: ``python -m repro_torch.obs.feedback [--P 8] [--factor 4]
    [--device 2] [--mode batched] [--placements ...] [--on cpu]`` — the
    throughput-weighted ownership selfcheck."""
    import argparse
    ap = argparse.ArgumentParser(
        description="closed-loop check: measured throughput -> capacity "
                    "weights -> proportionally smaller share for a "
                    "slowed device, bit-exact output")
    ap.add_argument("--P", type=int, default=8)
    ap.add_argument("--factor", type=float, default=4.0)
    ap.add_argument("--device", type=int, default=2,
                    help="the simulated device to slow")
    ap.add_argument("--mode", default="batched",
                    choices=["batched", "overlap", "scan"])
    ap.add_argument("--placements", nargs="*", default=None)
    ap.add_argument("--on", default=None,
                    help="torch device the blocks live on (default: the "
                         "CUDA device)")
    args = ap.parse_args(argv)
    feedback_selfcheck(P=args.P, slow_factor=args.factor,
                       slow_device=args.device, mode=args.mode,
                       placements=args.placements, device=args.on)
    return 0


if __name__ == "__main__":  # pragma: no cover
    raise SystemExit(_main())
