"""Analytical comm-volume predictor for the sweep data plane (port of
``repro/obs/comm.py``, DESIGN.md section 14.3).

Every shift the runtime issues has a statically known payload — the
schedule's shift structure fixes the hop count and block shapes fix the
bytes — so per-device communication is a pure function of (placement,
block bytes):

  * quorum gather:  one ppermute hop per **nonzero** shift, each moving
    one block — ``(k - 1) * block_bytes`` per device for a difference
    set containing 0.
  * quorum scatter: the inverse shifts move per-slot partials —
    ``(k - 1) * partial_bytes`` per device.
  * full placement: the engine routes through ``all_gather`` —
    ``(P - 1) * block_bytes`` per device and **zero** ppermute hops.
  * serving tree merge: ``ceil(log2 P)`` doubling hops; ring gather:
    ``P - 1`` hops.

Resident bytes per device are ``replication * block_bytes`` — the
paper's O(N/sqrt(P)) replication claim, against N for all-gather.

The traced actuals are the ``obs.trace`` counters.  The reference counts
once per compiled program, at trace time; the port's eager engine counts
on every call (``core/sweep.py``: ``quorum_gather`` / ``quorum_scatter``),
so each check below reads a tracer configured around exactly one call.
:func:`verify_dense_comm` asserts prediction == trace for every
registered placement; ``python -m repro_torch.obs.comm`` runs it.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..core.comm import Comm, SingleProcessComm, run_main, shard
from ..core.placement import (Placement, resolve_placement,
                              supported_placements)
from . import trace as trace_mod

__all__ = [
    "SweepComm",
    "block_bytes_of",
    "quant_block_bytes",
    "predict_sweep_comm",
    "predict_tree_merge_comm",
    "predict_ring_gather_comm",
    "traced_sweep_comm",
    "verify_dense_comm",
    "verify_quant_comm",
]


def block_bytes_of(block: int, dim: int, dtype: str = "float32") -> int:
    """One [block, dim] quorum block's payload bytes under ``dtype``;
    ``int8`` / ``bfloat16`` stacks shrink every gather hop by the same
    4x / 2x their residency shrinks."""
    return block * dim * getattr(torch, dtype).itemsize


def quant_block_bytes(block: int, dim: int, mode: str) -> int:
    """One quantized block's per-hop gather payload (DESIGN.md section
    17.1): the [block, dim] codes at the mode's itemsize plus the side
    arrays that ride the same shifts — scale + delta (two f32 scalars)
    and the l1 + sq f32 rows, leaf for leaf ``core.quant.QuantBlocks``."""
    from ..core.quant import quant_itemsize
    return block * dim * quant_itemsize(mode) + 8 + 8 * block


@dataclasses.dataclass(frozen=True)
class SweepComm:
    """Predicted per-device communication of one sweep under a placement.
    All byte fields are **per device**; the programs are symmetric, so
    the cluster total is ``P x`` each."""

    P: int
    placement: str
    block_bytes: int
    partial_bytes: int
    gather_hops: int
    scatter_hops: int
    gather_bytes: int
    scatter_bytes: int
    allgather_bytes: int
    resident_bytes: int

    @property
    def ppermute_bytes(self) -> int:
        """Total per-device ppermute bytes (gather + scatter)."""
        return self.gather_bytes + self.scatter_bytes

    def as_dict(self) -> Dict[str, int]:
        """The prediction as a plain dict."""
        return dataclasses.asdict(self)


def _nonzero_shifts(placement: Placement) -> int:
    return sum(1 for a in placement.schedule().shifts
               if int(a) % placement.P != 0)


def predict_sweep_comm(placement, block_bytes: int, *,
                       partial_bytes: Optional[int] = None,
                       P: Optional[int] = None) -> SweepComm:
    """Predict one sweep's per-device comm volume under ``placement`` (a
    Placement or spec name; ``P`` required for a name).

    ``block_bytes`` is one block's payload; ``partial_bytes`` the
    per-slot scatter payload (defaults to ``block_bytes`` — exact for
    emitters whose partials have the block's shape).  A full placement
    predicts zero ppermute hops and the all-gather baseline instead.
    """
    if not isinstance(placement, Placement):
        if P is None:
            raise ValueError("P is required when placement is a spec name")
        placement = resolve_placement(placement, P)
    pb = int(block_bytes) if partial_bytes is None else int(partial_bytes)
    bb = int(block_bytes)
    resident = placement.replication * bb
    if placement.full:
        return SweepComm(
            P=placement.P, placement=placement.name, block_bytes=bb,
            partial_bytes=pb, gather_hops=0, scatter_hops=0,
            gather_bytes=0, scatter_bytes=0,
            allgather_bytes=(placement.P - 1) * bb,
            resident_bytes=resident)
    nz = _nonzero_shifts(placement)
    return SweepComm(
        P=placement.P, placement=placement.name, block_bytes=bb,
        partial_bytes=pb, gather_hops=nz, scatter_hops=nz,
        gather_bytes=nz * bb, scatter_bytes=nz * pb, allgather_bytes=0,
        resident_bytes=resident)


def predict_tree_merge_comm(P: int, payload_bytes: int) -> Dict[str, int]:
    """Per-device comm of the serving recursive-doubling top-k merge: one
    ppermute hop per shift doubling (``ceil(log2 P)`` hops), each moving
    the running candidate payload."""
    hops = 0
    shift = 1
    while shift < P:
        hops += 1
        shift *= 2
    return {"hops": hops, "bytes": hops * int(payload_bytes)}


def predict_ring_gather_comm(P: int, payload_bytes: int) -> Dict[str, int]:
    """Per-device comm of the thresholded-query ring gather: ``P - 1``
    single-step hops, each moving the full buffer payload."""
    return {"hops": max(0, P - 1),
            "bytes": max(0, P - 1) * int(payload_bytes)}


def traced_sweep_comm(tracer) -> Dict[str, int]:
    """The traced per-device comm actuals out of a tracer's counters.  The
    port counts every call, so ``tracer`` must have seen exactly one."""
    return {
        "gather_bytes": int(tracer.counter_total(
            "comm.ppermute.gather_bytes")),
        "scatter_bytes": int(tracer.counter_total(
            "comm.ppermute.scatter_bytes")),
        "gather_hops": int(tracer.counter_total(
            "comm.ppermute.gather_hops")),
        "scatter_hops": int(tracer.counter_total(
            "comm.ppermute.scatter_hops")),
        "allgather_bytes": int(tracer.counter_total("comm.allgather.bytes")),
    }


def _pair_fn(bi, bj):
    # out_j(bi, bj) == out_i(bj, bi): the engine's symmetry contract; the
    # sum runs over each block (the last two axes), and the cast back to
    # the stack dtype keeps partial_bytes == block_bytes at every dtype
    def side(a, b):
        s = (b * b).sum(dim=(-2, -1), keepdim=True)
        return (a * s).to(a.dtype)
    return side(bi, bj), side(bj, bi)


def verify_dense_comm(P: int = 8,
                      placements: Optional[Sequence[str]] = None,
                      *, block: int = 4, dim: int = 3,
                      mode: str = "batched", dtype: str = "float32",
                      device=None, comm: Optional[Comm] = None,
                      verbose: bool = True) -> List[Dict[str, int]]:
    """Run one dense sweep per registered placement under a fresh tracer
    and assert the traced ppermute / all-gather bytes equal the analytical
    prediction **exactly**.

    The P devices are ``comm`` (default a :class:`SingleProcessComm` on
    ``device``, itself defaulting to the CUDA device); under a
    ``DistributedComm`` each rank checks its own device's counters.  The
    toy pair function emits block-shaped partials, so ``partial_bytes ==
    block_bytes`` and the default prediction is exact.  ``dtype`` sets the
    block itemsize (:func:`block_bytes_of`).
    Returns one traced-actuals dict per placement checked.
    """
    from ..core.allpairs import quorum_allpairs

    comm = SingleProcessComm(P, device) if comm is None else comm
    if comm.P != P:
        raise ValueError(f"the comm has P={comm.P} devices, not {P}")
    rng = np.random.default_rng(0)
    x = shard(rng.normal(size=(P * block, dim)) * 10, comm).to(
        getattr(torch, dtype))
    block_bytes = block_bytes_of(block, dim, dtype)

    out: List[Dict[str, int]] = []
    try:
        for plc in supported_placements(P):
            if placements is not None and plc.name not in placements:
                continue
            tracer = trace_mod.configure(metrics_only=True)
            res = quorum_allpairs(_pair_fn, x, comm, mode=mode,
                                  placement=plc)
            trace_mod.reset()
            if res.shape != x.shape or res.dtype != x.dtype:
                raise AssertionError(
                    f"{plc.name} P={P}: sweep returned {tuple(res.shape)} "
                    f"{res.dtype} for blocks {tuple(x.shape)} {x.dtype}")
            pred = predict_sweep_comm(plc, block_bytes)
            got = traced_sweep_comm(tracer)
            for field in ("gather_bytes", "scatter_bytes", "gather_hops",
                          "scatter_hops", "allgather_bytes"):
                want = getattr(pred, field)
                if got[field] != want:
                    raise AssertionError(
                        f"{plc.name} P={P}: traced {field}={got[field]} != "
                        f"predicted {want}")
            out.append({"placement": plc.name, **got})
            if verbose:
                print(f"  comm {plc.name:10s} P={P:<3d} mode={mode}: "
                      f"gather={got['gather_bytes']}B x{got['gather_hops']} "
                      f"scatter={got['scatter_bytes']}B "
                      f"allgather={got['allgather_bytes']}B == predicted")
    finally:
        trace_mod.reset()
    if verbose:
        print(f"comm predictor OK: {len(out)} placement(s) at P={P} "
              f"dtype={dtype}, traced == predicted exactly")
    return out


def verify_quant_comm(P: int = 8,
                      placements: Optional[Sequence[str]] = None,
                      *, block: int = 4, dim: int = 3,
                      qmode: str = "int8", device=None,
                      comm: Optional[Comm] = None,
                      verbose: bool = True) -> List[Dict[str, int]]:
    """Gather one quantized :class:`core.quant.QuantBlocks` stack per
    registered placement under a fresh tracer and assert the traced
    ppermute gather bytes equal ``nonzero_shifts * quant_block_bytes``
    exactly (DESIGN.md sections 14.3, 17.1) — the quantized twin of
    :func:`verify_dense_comm`, pinning the side arrays' payload to the
    predictor formula.  The P devices are ``comm`` (default a
    :class:`SingleProcessComm` on ``device``); under a
    ``DistributedComm`` each rank quantizes and gathers its own block and
    checks its own device's counters.
    """
    from ..core import sweep as sweep_mod
    from ..core.quant import quantize_corpus

    comm = SingleProcessComm(P, device) if comm is None else comm
    if comm.P != P:
        raise ValueError(f"the comm has P={comm.P} devices, not {P}")
    rng = np.random.default_rng(0)
    x = shard(rng.normal(size=(P * block, dim)).astype(np.float32), comm)
    L = x.shape[0]
    qb = quantize_corpus(x.reshape(L * block, dim), L, block, qmode).blocks()
    payload = quant_block_bytes(block, dim, qmode)

    out: List[Dict[str, int]] = []
    try:
        for plc in supported_placements(P):
            if placements is not None and plc.name not in placements:
                continue
            sched = plc.schedule()
            tracer = trace_mod.configure(metrics_only=True)
            g = sweep_mod.quorum_gather(qb, sched, comm)
            trace_mod.reset()
            if g.q.shape != (L, len(sched.shifts), block, dim):
                raise AssertionError(
                    f"{plc.name} P={P}: gathered codes {tuple(g.q.shape)}")
            got = traced_sweep_comm(tracer)
            nz = _nonzero_shifts(plc)
            want = nz * payload
            if got["gather_bytes"] != want:
                raise AssertionError(
                    f"{plc.name} P={P} quant={qmode}: traced gather_bytes="
                    f"{got['gather_bytes']} != predicted {want}")
            if got["gather_hops"] != nz:
                raise AssertionError(
                    f"{plc.name} P={P} quant={qmode}: traced gather_hops="
                    f"{got['gather_hops']} != {nz}")
            out.append({"placement": plc.name, "qmode": qmode, **got})
            if verbose:
                print(f"  quant comm {plc.name:10s} P={P:<3d} "
                      f"quant={qmode}: gather={got['gather_bytes']}B "
                      f"x{got['gather_hops']} == predicted")
    finally:
        trace_mod.reset()
    if verbose:
        print(f"quant comm predictor OK: {len(out)} placement(s) at "
              f"P={P} quant={qmode}, traced == predicted exactly")
    return out


def _main(argv=None) -> int:
    """CLI: ``python -m repro_torch.obs.comm [--P N] [--placements ...]
    [--mode batched] [--dtype float32] [--quant int8] [--block 4] [--dim 3]
    [--device cpu] [--dist gloo|nccl]`` — the predictor-vs-traced equality
    check; with ``--quant`` it also pins the quantized-stack gather
    payload; with ``--dist`` each of P torchrun processes is one device
    and checks its own counters."""
    import argparse
    ap = argparse.ArgumentParser(
        description="assert traced ppermute bytes == analytical "
                    "prediction for every registered placement")
    ap.add_argument("--P", type=int, default=8)
    ap.add_argument("--placements", nargs="*", default=None)
    ap.add_argument("--mode", default="batched",
                    choices=["batched", "overlap", "scan"])
    ap.add_argument("--dtype", default="float32",
                    choices=["float32", "bfloat16", "int8"])
    ap.add_argument("--quant", default=None, choices=["int8", "bf16"])
    ap.add_argument("--block", type=int, default=4)
    ap.add_argument("--dim", type=int, default=3)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    ap.add_argument("--dist", choices=("gloo", "nccl"), default=None,
                    help="one process per device over torch.distributed "
                         "with this backend (start under torchrun)")
    args = ap.parse_args(argv)

    def check(device=None, comm=None):
        verify_dense_comm(args.P, args.placements, block=args.block,
                          dim=args.dim, mode=args.mode, dtype=args.dtype,
                          device=device, comm=comm)
        if args.quant is not None:
            verify_quant_comm(args.P, args.placements, block=args.block,
                              dim=args.dim, qmode=args.quant, device=device,
                              comm=comm)
    run_main(check, device=args.device, dist=args.dist)
    return 0


if __name__ == "__main__":  # pragma: no cover
    raise SystemExit(_main())
