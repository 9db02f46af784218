"""Run phase 39 of chip_smoke.py alone (the decode step on a mesh of
ranks) on a machine with a CUDA card: builds the kernels, runs
the phase, and prints its lines and the ``dist_*`` figures it adds to
the kernels line.

    python3 scripts/chip_phase39.py
"""

import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke  # noqa: E402

if __name__ == "__main__":
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    _build.build()
    _build.library()
    print(f"kernels built in {time.perf_counter() - t0:.1f} s", flush=True)
    report = {name: {} for name in chip_smoke.KERNELS}
    t0 = time.perf_counter()
    chip_smoke.phase_distributed_decode(report, smi)
    print(f"phase 39 took {time.perf_counter() - t0:.1f} s")
    print({name: {k: v for k, v in r.items() if k.startswith("dist_")}
           for name, r in report.items() if r})
