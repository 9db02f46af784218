#!/usr/bin/env python3
"""Time mamba2-130m's decode step and B10's single-step launch on one GPU.

    python3 scripts/decode_step_time.py [--steps 256] [--rounds 3]

Uses the ``src/repro_torch`` beside this script.  Builds the full
mamba2-130m config (random bf16 parameters from seed 0), and per round:

- the host-clock time of ``--steps`` decode steps at batch 4 (the
  ``serve()`` batch of ``chip_smoke.py``), synchronized, in ms per step;
- B10 at a decode step's shape ([4, 1, 24, 64], chunk 1) by CUDA events
  over 200 launches, in ms per launch (the card waits for the host
  between launches, so this includes the wrapper's host time).

Decoding issues about 1,400 PyTorch calls a step, so the step time tracks
the host: compare two checkouts only within one machine, in turns
(A, B, B, A).  Prints the card's name and power limit.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=256)
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("FAIL: needs a CUDA device")
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch.steps import build_serve_step
    from repro_torch.models import lm

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()[0]
    cfg = get_config("mamba2_130m")
    params = lm.init_params(cfg, seed=0, device="cuda")
    step = build_serve_step(cfg)
    batch = 4
    g = torch.Generator(device="cuda").manual_seed(1)
    toks = torch.randint(0, cfg.vocab_size, (batch, args.steps), generator=g,
                         device="cuda")
    H, Pd, N = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    x = torch.randn(batch, 1, H, Pd, generator=g, device="cuda")
    dt = 0.01 + 0.19 * torch.rand(batch, 1, H, generator=g, device="cuda")
    A = -(0.5 + 1.5 * torch.rand(H, generator=g, device="cuda"))
    Bm = torch.randn(batch, 1, N, generator=g, device="cuda")
    Cm = torch.randn(batch, 1, N, generator=g, device="cuda")
    for r in range(args.rounds + 1):       # round 0 warms up
        state = lm.init_decode_state(cfg, batch, args.steps, device="cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for t in range(args.steps):
            _, state = step(params, state, toks[:, t:t + 1])
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) * 1e3 / args.steps
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        ops.ssd_intra_chunk(x, dt, A, Bm, Cm, chunk=1)
        torch.cuda.synchronize()
        start.record()
        for _ in range(200):
            ops.ssd_intra_chunk(x, dt, A, Bm, Cm, chunk=1)
        end.record()
        torch.cuda.synchronize()
        if r:
            print(f"round {r}: decode step {step_ms:.3f} ms (batch {batch}, "
                  f"{args.steps} steps, host clock), B10 at L = 1 "
                  f"{start.elapsed_time(end) / 200:.4f} ms per launch",
                  flush=True)
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
