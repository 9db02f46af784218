"""Time B9's float32 routes at the four cells PERF.md's kernel table keeps.

    python3 scripts/flash_f32_cells.py [--src DIR] [--reps N] [--library]
                                       [--split] [--attention] [--margins]

Cells (one H100; CUDA events, warmed up, the mean of ``--reps`` launches):
  * forward, a full quorum pair: partials of q [8, 4096, 40, 128], k / v
    [8, 4096, 8, 128], float32, not causal (qwen3-14b's widths, T = 32,768
    over P = 8 blocks, as ``chip_smoke.py``'s phase_kernels_lm);
  * forward, the diagonal pair: the same, causal;
  * backward, float32 at starcoder2-3b's training shape: q [2, 4096, 24,
    128], k / v [2, 4096, 2, 128], causal;
  * backward, bfloat16 at hd 256: q [1, 4096, 8, 256], k / v [1, 4096, 2,
    256], causal (the tf32x3 route: hd above 128).
Each line gives the kernel's ms, its bound at the fp32 FFMA rate (67
TFLOP/s; bf16 tensor cores, 989, for the bf16 cell) and at the split's
TF32 rate (495 TFLOP/s, 3 products a multiply-add in float32; in bf16 S
and dP one, the others two: 16 hd a visible pair), both shares, and with
``--library`` scaled_dot_product_attention's time on the same tensors
(forward; backward through autograd; TF32 off), and with ``--split``
each backward kernel's device ms (torch.profiler).  ``--attention``
also times float32 quorum and ring attention end to end (host clock,
synchronized, three runs each) on ``chip_smoke.py`` phase 17's inputs
(qwen3-14b's widths, T = 32,768, P = 8).  ``--margins`` reads the f32
partials' worst shares of their 1e-5 rule against the plain flash block
over ``tests/test_torch_kernels_gpu.py``'s FLASH_PART_CELLS.  ``--src`` imports
``repro_torch`` from another checkout's ``src`` (a parent commit unpacked
beside this one), so two versions can be timed in one call.  The last line
is one JSON object of the cells' numbers, the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import torch

PEAK_FP32, PEAK_BF16, PEAK_TF32, PEAK_BYTES = 67e12, 989e12, 495e12, 3.35e12


def visible_pairs(Tq: int, Tk: int, causal: bool) -> int:
    if not causal:
        return Tq * Tk
    return sum(min(Tk, i + Tk - Tq + 1) for i in range(Tq))


def cuda_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def bound_ms(n_bytes: float, ops: float, peak: float) -> float:
    return max(n_bytes / PEAK_BYTES, ops / peak) * 1e3


def kernel_split(fn) -> dict:
    """{kernel name: device ms} over one call of ``fn`` (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.device_time_total > 0 and not e.key.startswith("cuda"):
            name = e.key.replace("(anonymous namespace)::", "")
            name = name.removeprefix("void ").split("(")[0][:60]
            out[name] = out.get(name, 0.0) + e.device_time_total / 1e3
    return out


# tests/test_torch_kernels_gpu.py's FLASH_PART_CELLS: (B, Tq, Tk, KV, G, hd)
PART_CELLS = [(2, 100, 100, 2, 1, 64), (1, 70, 200, 1, 5, 80),
              (2, 130, 130, 2, 5, 128), (1, 96, 40, 1, 5, 64),
              (1, 127, 127, 1, 2, 16), (1, 128, 128, 2, 1, 96),
              (2, 129, 129, 1, 3, 128), (1, 257, 257, 1, 2, 64),
              (1, 129, 257, 1, 2, 256), (1, 257, 127, 1, 1, 128),
              (1, 127, 129, 2, 5, 256), (1, 129, 129, 1, 2, 36),
              (1, 4096, 4096, 1, 2, 256)]


def partial_share(got, want) -> float:
    """Worst share of the f32 partials' rule over (o, m, l): 1e-5 |want| +
    1e-5 max(1, max |want|) for o, 1e-5 |want| + 1e-5 for m and l."""
    return max(float(((a - w).abs() / (1e-5 * w.abs() + 1e-5 * (
        max(1.0, float(w.abs().max())) if i == 0 else 1.0))).max())
        for i, (a, w) in enumerate(zip(got, want)))


def margins(ops, ref) -> list:
    """(share, cell, causal) over PART_CELLS in float32, worst first; the
    inputs as the test file makes them."""
    out = []
    for B, Tq, Tk, KV, G, hd in PART_CELLS:
        for causal in (True, False):
            g = torch.Generator(device="cuda").manual_seed(Tk + hd)
            q = torch.randn(B, Tq, KV * G, hd, device="cuda", generator=g)
            k = torch.randn(B, Tk, KV, hd, device="cuda", generator=g)
            v = torch.randn(B, Tk, KV, hd, device="cuda", generator=g)
            out.append((partial_share(ops.flash_block(q, k, v, causal=causal),
                                      ref.flash_block(q, k, v,
                                                      causal=causal)),
                        (B, Tq, Tk, KV, G, hd), causal))
    return sorted(out, reverse=True)


def attention_ms() -> dict:
    """Float32 quorum and ring attention end to end, three runs each."""
    import time
    from repro_torch.apps.attention import distributed_attention
    from repro_torch.core.comm import SingleProcessComm
    from repro_torch.kernels import ops
    g = torch.Generator(device="cuda").manual_seed(23)
    q, k, v = (torch.randn(1, 32768, h, 128, generator=g, device="cuda")
               for h in (40, 8, 8))
    comm = SingleProcessComm(8, "cuda")
    out = {}
    for strategy in ("quorum", "ring"):
        ts = []
        for _ in range(3):
            ops.reset_launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            distributed_attention(q, k, v, comm, strategy=strategy)
            torch.cuda.synchronize()
            ts.append((time.perf_counter() - t0) * 1e3)
        out[strategy] = dict(ms=ts,
                             launches=ops.launch_counts()["flash_attention"])
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(Path(__file__).resolve().parents[1]
                                         / "src"))
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--library", action="store_true")
    ap.add_argument("--attention", action="store_true")
    ap.add_argument("--margins", action="store_true")
    ap.add_argument("--split", action="store_true",
                    help="device ms of each kernel of one call "
                         "(torch.profiler)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, args.src)
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.flash_attention import (
        bwd_route_of, flash_attention_bwd_cuda, flash_attention_cuda,
        route_of)
    torch.backends.cuda.matmul.allow_tf32 = False
    F = torch.nn.functional
    dev = torch.device("cuda")
    out = {}
    for name, B, T, H, KV, hd, causal in (("fwd_full", 8, 4096, 40, 8, 128,
                                           False),
                                          ("fwd_diag", 8, 4096, 40, 8, 128,
                                           True)):
        g = torch.Generator(device=dev).manual_seed(21)
        q = torch.randn(B, T, H, hd, generator=g, device=dev)
        k, v = (torch.randn(B, T, KV, hd, generator=g, device=dev)
                for _ in range(2))
        got = ops.flash_block(q, k, v, causal=causal)
        ms = cuda_ms(lambda: ops.flash_block(q, k, v, causal=causal),
                     args.reps)
        ops_n = 4.0 * hd * visible_pairs(T, T, causal) * B * H
        nb = nbytes(q, k, v, *got)
        cell = dict(route=route_of(q.dtype), ms=ms,
                    bound_fp32_ms=bound_ms(nb, ops_n, PEAK_FP32),
                    bound_split_ms=bound_ms(nb, 3 * ops_n, PEAK_TF32))
        if args.library:
            qs, ks, vs = (t.transpose(1, 2).contiguous() for t in (q, k, v))
            cell["sdpa_ms"] = cuda_ms(
                lambda: F.scaled_dot_product_attention(
                    qs, ks, vs, is_causal=causal, enable_gqa=True), 1)
            del qs, ks, vs
        out[name] = cell
        del q, k, v, got
    for name, B, T, H, KV, hd, dtype in (("bwd_f32", 2, 4096, 24, 2, 128,
                                          torch.float32),
                                         ("bwd_hd256_bf16", 1, 4096, 8, 2,
                                          256, torch.bfloat16)):
        g = torch.Generator(device=dev).manual_seed(31 + hd)
        q, do = (torch.randn(B, T, H, hd, generator=g, device=dev).to(dtype)
                 for _ in range(2))
        k, v = (torch.randn(B, T, KV, hd, generator=g, device=dev).to(dtype)
                for _ in range(2))
        o, lse = flash_attention_cuda(q, k, v, causal=True, with_lse=True)
        got = flash_attention_bwd_cuda(q, k, v, o, lse, do, causal=True)
        ms = cuda_ms(lambda: flash_attention_bwd_cuda(q, k, v, o, lse, do,
                                                      causal=True),
                     args.reps)
        if args.split:
            cell_split = kernel_split(lambda: flash_attention_bwd_cuda(
                q, k, v, o, lse, do, causal=True))
        pairs = visible_pairs(T, T, True) * B * H
        nb = nbytes(q, k, v, o, lse, do, *got)
        split_ops = (30 if dtype == torch.float32 else 16) * hd * pairs
        cell = dict(route=bwd_route_of(dtype, hd), ms=ms,
                    bound_ms=bound_ms(nb, 10.0 * hd * pairs,
                                      PEAK_FP32 if dtype == torch.float32
                                      else PEAK_BF16),
                    bound_split_ms=bound_ms(nb, split_ops, PEAK_TF32))
        if args.split:
            cell["kernels_ms"] = cell_split
        if args.library:
            qs, ks, vs = (t.transpose(1, 2).contiguous().requires_grad_(True)
                          for t in (q, k, v))
            y = F.scaled_dot_product_attention(qs, ks, vs, is_causal=True,
                                               enable_gqa=True)
            dos = do.transpose(1, 2).contiguous()
            cell["sdpa_bwd_ms"] = cuda_ms(lambda: torch.autograd.grad(
                y, (qs, ks, vs), dos, retain_graph=True), 1)
            del qs, ks, vs, y, dos
        out[name] = cell
        del q, k, v, o, lse, do, got
    for name, c in out.items():
        b = c.get("bound_fp32_ms", c.get("bound_ms"))
        print(f"{name} ({c['route']}): {c['ms']:.3f} ms; bound {b:.3f} ms "
              f"({b / c['ms']:.3f} of it), split's bound "
              f"{c['bound_split_ms']:.3f} ms "
              f"({c['bound_split_ms'] / c['ms']:.3f}); library "
              f"{c.get('sdpa_ms', c.get('sdpa_bwd_ms', 'not timed'))}"
              + (f"; kernels {c['kernels_ms']}" if "kernels_ms" in c
                 else ""), flush=True)
    extra = {}
    if args.attention:
        extra["attention_f32"] = attention_ms()
        print(f"f32 quorum / ring attention (ms, three runs): "
              f"{extra['attention_f32']}", flush=True)
    if args.margins:
        extra["margins"] = margins(ops, ref)[:5]
        print(f"f32 partial shares, worst five: {extra['margins']}",
              flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(json.dumps({"src": args.src, "card": smi, "cells": out, **extra}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
