#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA card.  It imports
nothing of JAX or of the JAX package ``repro``, and exits non-zero on the
first failed check (and at once where there is no CUDA device, or no port
beside the script).  Phases:

  1. the card's name and power limit; build the CUDA kernels from
     ``src/repro_torch/csrc`` (one ``nvcc`` per source, in parallel);
  2. each kernel (B1 pairwise_batch, B2 pairwise_corr, B3 pcit_filter) at
     the main path's shapes against its plain PyTorch version, timed with
     CUDA events beside the plain version (and, for B2, torch.matmul);
  3. the engine self-check on the card at P = 2, 5, 8, every mode;
  4. n-body, the quorum path at N = 65,536 bodies over P = 8 devices with
     the fused kernel, against the plain scan path, plus leapfrog steps;
  5. PCIT at N = 8,192 genes x G = 512 samples over P = 8 devices with the
     kernels, against a matmul and the plain filter on the card, and at
     N = 64 against the numpy O(N^3) reference;
  6. a JSON line of every kernel (launches on the main path, error against
     the plain version, times, bound), the nvidia-smi line, and the result
     line ``{"ok": true, "device": {...}}`` last.

Kernel launch counts are set to 0 just before each main path (n-body,
PCIT) is driven and read just after it, so comparison launches do not
count.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
DEVICE = "cuda"
P = 8
NBODY_N = 65536          # 8,192 bodies per block
NBODY_STEPS = 3
PCIT_N, PCIT_G = 8192, 512
PCIT_RANK = 16           # latent factors of the synthetic expression data
# published H100 SXM peaks (NVIDIA data sheet)
PEAK_FP32_FLOPS = 67e12  # fp32 outside the tensor cores
PEAK_BYTES = 3.35e12     # HBM3
# fp32 operations per body pair of the n-body step (difference 3, r^2 6,
# rsqrt and its cube 3, mass product 2, force 3, row sum 3), plus 3 for the
# column sum where both sides of a tile are needed
NBODY_OPS, NBODY_OPS_BOTH = 20, 23
# fp32 operations per visited (x, y, z) trio of the PCIT filter (squares,
# three denominators with their sqrt, three partial correlations, the eps
# mean with its three divisions, two products, abs and compares)
PCIT_OPS = 36
BOUNDARY_TOL = 1e-6


class CheckFailed(RuntimeError):
    pass


def check(cond, msg: str) -> None:
    if not cond:
        raise CheckFailed(msg)


def say(*parts) -> None:
    print(*parts, flush=True)


def cuda_ms(fn, reps: int = 3, warmup: int = 1) -> float:
    """Mean device time of ``fn`` in ms (CUDA events, after warm-up)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound(nbytes: float, ops: float) -> tuple[float, str]:
    """The least time (ms) the card could take: the larger of bytes over
    the memory rate and fp32 operations over the fp32 peak."""
    t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, ops / PEAK_FP32_FLOPS * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def make_bodies(n: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return np.concatenate([rng.normal(size=(n, 3)),
                           rng.uniform(0.5, 2, (n, 1))], -1).astype(np.float32)


def make_expression(n: int, g: int, rank: int, seed: int) -> np.ndarray:
    """Synthetic co-expression data: genes driven by a few latent factors
    plus noise (the shape of the repo's PCIT examples, at scale)."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, rank)) @ rng.normal(size=(rank, g))
    return (X + 0.5 * rng.normal(size=(n, g))).astype(np.float32)


def pcit_margin(rxy, rx, ry, gx, gy) -> float:
    """Distance of one (x, y) decision from its boundary: the least
    |max(|r_xy| - |eps r_xz|, |r_xy| - |eps r_yz|)| over the valid z, in
    float64."""
    rxy, rx, ry = float(rxy), rx.double(), ry.double()
    eps_ = 1e-12
    den_z = torch.sqrt(torch.clamp((1 - rx ** 2) * (1 - ry ** 2), min=eps_))
    den_y = torch.sqrt(torch.clamp((1 - rxy ** 2) * (1 - ry ** 2), min=eps_))
    den_x = torch.sqrt(torch.clamp((1 - rxy ** 2) * (1 - rx ** 2), min=eps_))
    e = ((rxy - rx * ry) / den_z / (rxy + eps_)
         + (rx - rxy * ry) / den_y / (rx + eps_)
         + (ry - rxy * rx) / den_x / (ry + eps_)) / 3.0
    m = torch.maximum(abs(rxy) - (e * rx).abs(), abs(rxy) - (e * ry).abs())
    z = torch.arange(rx.numel(), device=rx.device)
    valid = (z != int(gx)) & (z != int(gy))
    return float(m[valid].abs().min())


def compare_keep(got, want, r_xy, rows_x, rows_y, gx, gy, what: str) -> int:
    """Keep masks must agree, except entries within BOUNDARY_TOL of their
    decision boundary; returns the number of differing entries."""
    diff = torch.nonzero(got != want)
    for b, x, y in diff.tolist():
        m = pcit_margin(r_xy[b, x, y], rows_x[b, x], rows_y[b, y],
                        gx[b, x], gy[b, y])
        check(m <= BOUNDARY_TOL,
              f"{what}: keep differs at {(b, x, y)}, {m:.3e} from the "
              f"boundary")
    return len(diff)


def plain_pcit_chunked(r_xy, rows_x, rows_y, gx, gy, rows: int = 16):
    """The plain filter over [B, M, N] tiles, called on row slices so the
    [rows, N, Z] intermediates fit in memory."""
    from repro_torch.kernels.ref import pcit_filter
    out = torch.empty(r_xy.shape, dtype=torch.bool, device=r_xy.device)
    for b in range(r_xy.shape[0]):
        for r0 in range(0, r_xy.shape[1], rows):
            sl = slice(r0, r0 + rows)
            out[b, sl] = pcit_filter(r_xy[b, sl], rows_x[b, sl], rows_y[b],
                                     gx[b, sl], gy[b])
    return out


def pcit_tile_inputs(C, sched, block):
    """The batched mode's B3 operands for every (device, pair) tile of the
    correlation matrix C [N, N]: r_xy [B, bm, bn], rows_x [B, bm, N],
    rows_y [B, bn, N], gx / gy [B, block]."""
    ids = torch.arange(block, device=C.device)
    rx, ry, rxy, gxs, gys = [], [], [], [], []
    for i in range(sched.P):
        for lo, hi in sched.pair_slots.tolist():
            glo = (i + int(sched.shifts[lo])) % sched.P
            ghi = (i + int(sched.shifts[hi])) % sched.P
            rx.append(C[glo * block:(glo + 1) * block])
            ry.append(C[ghi * block:(ghi + 1) * block])
            rxy.append(C[glo * block:(glo + 1) * block,
                         ghi * block:(ghi + 1) * block])
            gxs.append(glo * block + ids)
            gys.append(ghi * block + ids)
    return (torch.stack(rxy), torch.stack(rx), torch.stack(ry),
            torch.stack(gxs).int(), torch.stack(gys).int())


def phase_kernels(report: dict) -> None:
    from repro_torch.apps.pcit import standardize
    from repro_torch.core.comm import SingleProcessComm, shard
    from repro_torch.core.scheduler import build_schedule
    from repro_torch.core.sweep import pair_mask_table, quorum_gather
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.pcit_filter import pcit_filter_cuda

    comm = SingleProcessComm(P, DEVICE)
    sched = build_schedule(P)
    lo, hi = sched.pair_slots[:, 0], sched.pair_slots[:, 1]
    mask = torch.as_tensor(pair_mask_table(sched), device=DEVICE)

    # ---- B1 at n-body's shape: quorum [P, k, 8192, 4] -------------------
    quorum = quorum_gather(shard(make_bodies(NBODY_N, 0), comm), sched, comm)
    wi = mask
    wj = torch.where(torch.as_tensor(sched.pair_diff == 0, device=DEVICE),
                     torch.zeros_like(mask), mask)
    got = ops.pairwise_batch_forces(quorum, lo, hi, wi, wj)
    want = ref.pairwise_batch_forces(quorum, lo, hi, wi, wj)
    err = float((got - want).abs().max())
    rel = err / float(want.abs().max())
    check(torch.isfinite(got).all(), "B1: non-finite forces")
    check(rel < 1e-4, f"B1: max abs err / max |plain| = {rel:.3e} >= 1e-4")
    ms = cuda_ms(lambda: ops.pairwise_batch_forces(quorum, lo, hi, wi, wj))
    plain_ms = cuda_ms(lambda: ref.pairwise_batch_forces(quorum, lo, hi, wi,
                                                         wj), reps=2)
    block = quorum.shape[2]
    ops_needed = 0
    for p in range(P):
        for n in range(sched.n_pairs):
            a, b = float(wi[p, n]) != 0, float(wj[p, n]) != 0
            if a or b:
                ops_needed += block * block * (
                    NBODY_OPS_BOTH if a and b else NBODY_OPS)
    w = torch.stack([wi, wj], -1)
    b_ms, b_by = bound(nbytes(quorum, w, got) + 8 * sched.n_pairs, ops_needed)
    say(f"B1 pairwise_batch {tuple(quorum.shape)} x {sched.n_pairs} pairs: "
        f"max_abs_err={err:.3e} (rel {rel:.3e} < 1e-4) kernel {ms:.3f} ms, "
        f"plain {plain_ms:.3f} ms, bound {b_ms:.3f} ms ({b_by})")
    report["pairwise_batch"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                    bound_ms=b_ms, bound_by=b_by,
                                    library_ms=None)
    del quorum, got, want

    # ---- B2 at PCIT's shape: [P*n_pairs, 1024, 512] tiles ---------------
    Xs = standardize(make_expression(PCIT_N, PCIT_G, PCIT_RANK, 1))
    xq = quorum_gather(shard(Xs, comm), sched, comm)
    lhs = xq[:, torch.as_tensor(lo, dtype=torch.long)].flatten(0, 1)
    rhs = xq[:, torch.as_tensor(hi, dtype=torch.long)].flatten(0, 1)
    got = ops.pairwise_corr(lhs, rhs)
    want = ref.pairwise_corr(lhs, rhs)
    err = float((got - want).abs().max())
    check(torch.allclose(got, want, rtol=1e-4, atol=1e-5),
          f"B2: not within rtol 1e-4 / atol 1e-5 (max abs err {err:.3e})")
    ms = cuda_ms(lambda: ops.pairwise_corr(lhs, rhs), reps=10)
    plain_ms = cuda_ms(lambda: ref.pairwise_corr(lhs, rhs), reps=10)
    lib_ms = cuda_ms(lambda: torch.bmm(lhs, rhs.transpose(1, 2)), reps=10)
    Bt, M, G = lhs.shape
    b_ms, b_by = bound(nbytes(lhs, rhs, got), 2.0 * Bt * M * rhs.shape[1] * G)
    say(f"B2 pairwise_corr {tuple(lhs.shape)} x {tuple(rhs.shape)}: "
        f"max_abs_err={err:.3e} kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, "
        f"torch.bmm (TF32 off) {lib_ms:.3f} ms, bound {b_ms:.3f} ms ({b_by})")
    report["pairwise_corr"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                   bound_ms=b_ms, bound_by=b_by,
                                   library_ms=lib_ms)
    del xq, lhs, rhs, got, want

    # ---- B3 at PCIT's shape: every (device, pair) tile, Z = 8192 --------
    X_t = torch.as_tensor(Xs, device=DEVICE)
    C = X_t @ X_t.T
    r_xy, rows_x, rows_y, gx, gy = pcit_tile_inputs(C, sched, PCIT_N // P)
    visits = torch.empty(r_xy.shape, dtype=torch.int32, device=DEVICE)
    got = pcit_filter_cuda(r_xy, rows_x, rows_y, gx, gy, visits=visits)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = plain_pcit_chunked(r_xy, rows_x, rows_y, gx, gy)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    n_diff = compare_keep(got, want, r_xy, rows_x, rows_y, gx, gy, "B3")
    ms = cuda_ms(lambda: ops.pcit_filter(r_xy, rows_x, rows_y, gx, gy),
                 reps=2)
    trios = int(visits.long().sum())
    b_ms, b_by = bound(nbytes(r_xy, rows_x, rows_y, gx, gy, got),
                       float(trios) * PCIT_OPS)
    full = r_xy.numel() * rows_x.shape[-1]
    say(f"B3 pcit_filter {tuple(r_xy.shape)} x Z={rows_x.shape[-1]}: keep "
        f"differs at {n_diff} of {got.numel()} entries (all within "
        f"{BOUNDARY_TOL} of the boundary), kept {float(got.float().mean()):.4f};"
        f" visited {trios} of {full} trios; kernel {ms:.3f} ms, plain "
        f"{plain_ms:.3f} ms (host clock, row chunks), bound {b_ms:.3f} ms "
        f"({b_by})")
    report["pcit_filter"] = dict(max_abs_err=float(n_diff > 0), ms=ms,
                                 plain_ms=plain_ms, bound_ms=b_ms,
                                 bound_by=b_by, library_ms=None,
                                 differing=n_diff, visited_trios=trios)


def phase_selfcheck() -> None:
    from repro_torch.core import selfcheck
    for p in (2, 5, 8):
        selfcheck.main(p, device=DEVICE)


def phase_nbody(report: dict) -> None:
    from repro_torch.apps.nbody import distributed_forces, leapfrog_step
    from repro_torch.core.comm import SingleProcessComm
    from repro_torch.kernels import ops

    comm = SingleProcessComm(P, DEVICE)
    bodies = torch.as_tensor(make_bodies(NBODY_N, 2), device=DEVICE)
    vel = torch.zeros(NBODY_N, 3, device=DEVICE)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    times = []
    state = bodies
    first = None
    for _ in range(NBODY_STEPS):
        t0 = time.perf_counter()
        forces = distributed_forces(state, comm, use_kernel=True)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        if first is None:
            first = forces
        state, vel = leapfrog_step(state, vel, 1e-3, forces)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    report["pairwise_batch"]["launches"] = counts["pairwise_batch"]
    check(counts["pairwise_batch"] > 0, "n-body: B1 was never launched")
    check(first.shape == (NBODY_N, 3) and torch.isfinite(first).all(),
          "n-body: forces not finite or of the wrong shape")
    check(torch.isfinite(state).all() and torch.isfinite(vel).all(),
          "n-body: leapfrog state not finite")
    plain = distributed_forces(bodies, comm, mode="scan", use_kernel=False)
    rel = float((first - plain).abs().max() / plain.abs().max())
    check(rel < 1e-4, f"n-body: kernel path vs plain scan path rel err "
          f"{rel:.3e} >= 1e-4")
    say(f"nbody N={NBODY_N} P={P}: force evaluation "
        f"{', '.join(f'{t:.2f}' for t in times)} ms (host clock, "
        f"synchronized), peak {peak / 2**30:.3f} GiB, B1 launches "
        f"{counts['pairwise_batch']} over {NBODY_STEPS} evaluations, "
        f"vs plain scan path rel err {rel:.3e}")


def phase_pcit(report: dict) -> None:
    from repro_torch.apps.pcit import (correlation_reference, pcit_reference,
                                       run_quorum_pcit, standardize)
    from repro_torch.core.comm import SingleProcessComm
    from repro_torch.kernels import ops

    comm = SingleProcessComm(P, DEVICE)
    X = make_expression(PCIT_N, PCIT_G, PCIT_RANK, 1)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    corr, keep = run_quorum_pcit(X, comm, use_kernels=True)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    report["pairwise_corr"]["launches"] = counts["pairwise_corr"]
    report["pcit_filter"]["launches"] = counts["pcit_filter"]
    check(counts["pairwise_corr"] > 0 and counts["pcit_filter"] > 0,
          f"PCIT: kernels not launched on the main path: {counts}")
    check(corr.shape == (PCIT_N, PCIT_N) and keep.shape == (PCIT_N, PCIT_N),
          "PCIT: wrong output shapes")
    check(torch.isfinite(corr).all(), "PCIT: non-finite correlations")
    Xs = torch.as_tensor(standardize(X), device=DEVICE)
    C = Xs @ Xs.T
    err = float((corr - C).abs().max())
    check(torch.allclose(corr, C, rtol=1e-4, atol=1e-5),
          f"PCIT: corr vs Xs @ Xs.T max abs err {err:.3e}")
    del C
    # sampled keep tiles (a diagonal one and two off-diagonal ones) against
    # the plain filter on the pipeline's own correlation rows
    block = PCIT_N // P
    ids = torch.arange(block, device=DEVICE)
    n_diff = 0
    for xb, yb in [(0, 0), (1, P - 2), (P - 1, P // 2 - 1)]:
        xs = slice(xb * block, (xb + 1) * block)
        ys = slice(yb * block, (yb + 1) * block)
        args = (corr[None, xs, ys].contiguous(), corr[None, xs], corr[None, ys],
                (xb * block + ids)[None], (yb * block + ids)[None])
        want = plain_pcit_chunked(*args)
        n_diff += compare_keep(keep[None, xs, ys], want, *args, "PCIT keep")
    say(f"pcit N={PCIT_N} G={PCIT_G} P={P}: {secs * 1e3:.1f} ms (host clock, "
        f"synchronized), peak {peak / 2**30:.3f} GiB, B2 launches "
        f"{counts['pairwise_corr']}, B3 launches {counts['pcit_filter']}, "
        f"corr max abs err {err:.3e}, kept {float(keep.float().mean()):.4f}, "
        f"sampled keep tiles differ at {n_diff} entries (within boundary)")
    del corr, keep
    # the full pipeline on the card against the O(N^3) numpy reference
    rng = np.random.default_rng(0)
    Xsm = (rng.normal(size=(64, 6)) @ rng.normal(size=(6, 24))
           + 0.4 * rng.normal(size=(64, 24))).astype(np.float32)
    corr, keep = run_quorum_pcit(Xsm, comm, use_kernels=True)
    np.testing.assert_allclose(corr.cpu().numpy(), correlation_reference(Xsm),
                               rtol=1e-4, atol=1e-5)
    check((keep.cpu().numpy() == pcit_reference(Xsm)).all(),
          "PCIT N=64: keep differs from pcit_reference")
    say("pcit N=64 G=24 P=8 on the card == numpy pcit_reference")


KERNELS = {
    "pairwise_batch": ("src/repro_torch/csrc/pairwise_batch.cu",
                       "src/repro/kernels/pairwise_batch.py:97"),
    "pairwise_corr": ("src/repro_torch/csrc/pairwise_corr.cu",
                      "src/repro/kernels/pairwise_corr.py:52"),
    "pcit_filter": ("src/repro_torch/csrc/pcit_filter.cu",
                    "src/repro/kernels/pcit_filter.py:79"),
}


def main() -> int:
    if not torch.cuda.is_available():
        say("FAIL: torch.cuda.is_available() is false; this smoke run needs "
            "a CUDA device")
        return 2
    if not (ROOT / "src" / "repro_torch" / "csrc").is_dir():
        say(f"FAIL: no src/repro_torch beside {Path(__file__).name}; run it "
            "from the root of a checkout")
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    say(f"card: {smi}; torch {torch.__version__} cuda {torch.version.cuda}")

    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    lib = _build.build()
    _build.library()
    say(f"phase 1: kernels built in {time.perf_counter() - t0:.2f} s "
        f"({lib})")
    say((lib.parent / "build.log").read_text())

    report: dict = {}
    phases = [("kernels vs plain versions", lambda: phase_kernels(report)),
              ("engine selfcheck", phase_selfcheck),
              ("n-body main path", lambda: phase_nbody(report)),
              ("PCIT main path", lambda: phase_pcit(report))]
    for i, (name, fn) in enumerate(phases, start=2):
        t0 = time.perf_counter()
        say(f"== phase {i}: {name}")
        fn()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        say(f"== phase {i} OK ({time.perf_counter() - t0:.1f} s)")

    rows = []
    for name, (source, replaces) in KERNELS.items():
        r = report[name]
        rows.append({"name": name, "route": "cuda", "source": source,
                     "replaces": replaces, "launches": r["launches"],
                     "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                     "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                     "bound_by": r["bound_by"],
                     "library_ms": r["library_ms"]})
    say(json.dumps({"kernels": rows}))
    say(smi)
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
