#!/usr/bin/env python3
"""B7 / B8 bf16 on the tensor cores with other chunk lengths, on the card.

    python3 scripts/pair_q_chunks.py [--chunks 16,32,64,128] [--plain-joins]

Compiles ``csrc/pairwise_topk_q.cu`` and ``csrc/pairwise_threshold_q.cu``
once for each chunk length c (``-DREPRO_BF16_CHUNK``, the kernels'
``kChunk`` in ``csrc/chunk_join.cuh``: d a tensor-core accumulator sums
before it joins the row's float32 sum), and with ``--plain-joins`` also
with the chunks joined by plain adds instead of the compensated ones
(``-DREPRO_BF16_PLAIN_JOINS``), each pair into a library of its own.  For every variant
it prints B8's worst error against a float64 evaluation over phase 10's
cells (``chip_smoke.wide_rows``: [1, 2, 200, d] codes, 6 seeds, dot top-512;
standard normal and clustered non-negative rows) as a share of the plain
float32 version's, and B7's and B8's time at d = 960 on device 0's tiles of
65,536 clustered rows (``chip_smoke.wide_kernel_times``) with whether that
variant passes phase 40's check of device 0's outputs.  Run from the root
of a checkout on a machine with a CUDA card; it imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
import tempfile
from pathlib import Path
from unittest import mock

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

WIDTHS = (128, 200, 256, 960, 1040, 4096)
SOURCES = ("pairwise_topk_q", "pairwise_threshold_q")


def build_variants(variants, out: Path) -> dict:
    """{(c, kahan): the loaded library of that variant's two kernels}: the
    sources as they are, built with -DREPRO_BF16_CHUNK=c (and
    -DREPRO_BF16_PLAIN_JOINS without ``kahan``; csrc/chunk_join.cuh)."""
    from repro_torch.kernels import _build
    nvcc, procs = _build.nvcc_path(), []
    for c, kahan in variants:
        for name in SOURCES:
            flags = _build._flags(f"{name}.cu", c)
            if not kahan:
                flags += ("-DREPRO_BF16_PLAIN_JOINS",)
            procs.append(subprocess.Popen(
                [nvcc, *flags, "-c", str(_build.CSRC / f"{name}.cu"),
                 "-o", str(out / f"{name}_c{c}_{int(kahan)}.o")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    for p in procs:
        text, _ = p.communicate()
        if p.returncode:
            raise RuntimeError(text)
    libs = {}
    for c, kahan in variants:
        so = out / f"lib_c{c}_{int(kahan)}.so"
        subprocess.run([nvcc, "-shared", "-o", str(so)]
                       + [str(out / f"{n}_c{c}_{int(kahan)}.o")
                          for n in SOURCES], check=True)
        lib = ctypes.CDLL(str(so))
        for name in ("repro_pairwise_topk_q", "repro_pairwise_threshold_q"):
            fn = getattr(lib, name)
            fn.argtypes = _build.SIGNATURES[name]
            fn.restype = ctypes.c_int
        libs[(c, kahan)] = lib
    return libs


def codes_of(kind: str, d: int, seed: int) -> torch.Tensor:
    g = torch.Generator(device="cuda").manual_seed(1000 * d + seed)
    if kind == "normal":
        x = torch.randn(1, 2, 200, d, generator=g, device="cuda")
    else:
        cen = torch.rand(8, d, generator=g, device="cuda")
        pick = torch.randint(8, (400,), generator=g, device="cuda")
        x = (cen[pick] + 0.3 * torch.randn(400, d, generator=g,
                                           device="cuda")).clamp(min=0.0)
    return x.reshape(1, 2, 200, d).to(torch.bfloat16)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--chunks", default="16,32,64,128")
    ap.add_argument("--plain-joins", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("FAIL: no CUDA device")
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    import chip_smoke as cs
    from repro_torch.core import quant
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels.pairwise_batch_q import pairwise_topk_q_cuda

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"card: {smi}; torch {torch.__version__}", flush=True)
    chunks = [int(c) for c in args.chunks.split(",")]
    variants = [(c, True) for c in chunks]
    if args.plain_joins:
        variants += [(c, False) for c in chunks]
    libs = build_variants(variants, Path(tempfile.mkdtemp()))
    names = {v: f"c{v[0]}{'' if v[1] else ' plain'}" for v in variants}
    mb = torch.tensor([cs.WIDE_META], dtype=torch.int32, device="cuda")
    lo, hi = [0, 0, 1], [0, 1, 1]
    kw = dict(topk=512, block_rows=200, metric="dot")
    for kind in ("normal", "clustered"):
        for d in WIDTHS:
            err = {v: 0.0 for v in variants}
            plain = 0.0
            for seed in range(6):
                codes = codes_of(kind, d, seed)
                flat = codes.double().reshape(400, d)
                s64 = flat @ flat.T
                sd = torch.ones(1, 2, 2, device="cuda")
                sq = (codes.float() ** 2).sum(-1)
                wv, wi = ref.pairwise_topk_q(codes, sd[..., 0], sq, lo, hi,
                                             mb, **kw)
                plain = max(plain, cs.f64_list_err(wv, wi, s64))
                for v in variants:
                    with mock.patch.object(_build, "library",
                                           lambda v=v: libs[v]):
                        gv, gi = pairwise_topk_q_cuda(
                            codes, sd, sq, lo, hi, mb, route="tensor_cores",
                            **kw)
                    err[v] = max(err[v], cs.f64_list_err(gv, gi, s64))
            print(f"{kind} d={d}: plain float32 {plain:.3e}; "
                  + ", ".join(f"{names[v]} {err[v]:.3e} "
                              f"({err[v] / plain:.2f})" for v in variants),
                  flush=True)
    X, _xn, thr = cs.join_data(960, 65_536, cs.WIDE_SEED)
    qc = quant.quantize_corpus(X, cs.P, 65_536 // cs.P, "bf16")
    del X, _xn
    for v in variants:
        with mock.patch.object(_build, "library", lambda v=v: libs[v]):
            try:
                t = cs.wide_kernel_times(qc, thr)
                verdict = "passes"
            except cs.CheckFailed as e:
                verdict = f"fails ({e})"
                t = cs.wide_kernel_times(qc, thr, checks=False)
        print(f"{names[v]}: phase 40's check of device 0 {verdict}",
              flush=True)
        print(f"time {names[v]}, d = 960, 65,536 rows: "
              + "; ".join(f"{k} every device {t[k]['ms']:.3f} ms, device 0 "
                          f"tensor cores {t[k]['dev0_tensor_cores_ms']:.3f}"
                          f", simt {t[k]['dev0_simt_ms']:.3f}"
                          for k in ("B7", "B8")), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
