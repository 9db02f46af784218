#!/usr/bin/env python3
"""The dry run's bytes against the card's allocator in a fresh process.

    python3 scripts/alloc_tails.py

Uses the ``chip_smoke.py`` and ``src/repro_torch`` beside this script.
Makes, one after another and each freed before the next, the three
resident states that ``chip_smoke.py`` phase 35 (b) reads: mamba2-130m's
parameters and AdamW moments, qwen3-14b's parameters, starcoder2-3b's
parameters and AdamW moments (random bf16 parameters from seed 0), and
checks each as that phase does (``chip_smoke.dry_run_bytes``).  In
``chip_smoke.py`` the states are made late, when earlier phases have left
the caching allocator large free blocks; here the first of them lands in
new segments, where a tensor over 1 MiB may keep an unsplit tail of at
most 1 MiB in its block.  Prints, per state, the predicted bytes, what
the allocator's counters rose by and which tensors kept a tail, and the
card's name and power limit.  Needs a CUDA card and about 60 GiB on it.
"""

from __future__ import annotations

import gc
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    if not torch.cuda.is_available():
        print("FAIL: needs a CUDA device")
        return 2
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.models import lm
    from repro_torch.optim import adamw_init

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"card: {smi}; torch {torch.__version__}", flush=True)
    report: dict = {}
    for arch, kind, batch, seq, with_opt in (
            ("mamba2_130m", "train", cs.MAMBA_B, cs.MAMBA_T, True),
            ("qwen3_14b", "prefill", cs.QWEN_B, cs.QWEN_T, False),
            ("starcoder2_3b", "train", cs.STAR_B, cs.STAR_T, True)):
        before = cs.alloc_counters()
        params = lm.init_params(get_config(arch), seed=0, device="cuda")
        trees = {"params": params}
        if with_opt:
            trees["opt"] = adamw_init(params)
        cs.record_resident(report, arch, before, **trees)
        report["dry_run"][arch].update(kind=kind, batch=batch, seq=seq)
        del params, trees
        gc.collect()
    try:
        cs.dry_run_bytes(report)
    except cs.CheckFailed as e:
        print(f"FAIL: {e}")
        return 1
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
