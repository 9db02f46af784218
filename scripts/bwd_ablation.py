#!/usr/bin/env python3
"""Where B9's wgmma backward spends its time: the kernel
(``src/repro_torch/csrc/flash_attention_bwd_tc.cu``) built as it is and with
one more phase taken out per variant, each timed with CUDA events at
starcoder2-3b's training shape and whisper's encoder shape.

    python3 scripts/bwd_ablation.py

Needs a CUDA card and nvcc.  The variants are text edits of the source
(each asserts that the text it edits is there, so a changed kernel fails
loudly rather than timing something else) built into ``build/ablation/``:

  as_is         the kernel;
  no_acquire    without the dQ chain's wait (blocks race on dq);
  no_prefetch   also without copying the dQ so far into shared memory;
  no_dq         also without the dQ product and its sum;
  no_exp        also with P = S (no ex2);
  no_s_dp       also without the S^T and dP^T products;
  no_dv_dk      also without the dV and dK products (what is left: the
                ring's loads, the barriers and the elementwise work);
  no_loads      also without the ring's loads after the first two units;
  no_dq_section also without what was left of the dQ phase (its wgmma
                fence, commit and wait, and the sum's shared-memory reads).

The variants after ``as_is`` compute wrong gradients: they time phases,
nothing else.  Prints the card's name and power limit and one line per
(shape, variant).
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402

SHAPES = (("starcoder2 train", 2, 4096, 24, 2, 128, True),
          ("whisper encoder", 8, 1500, 20, 20, 64, False))


def edit(text: str, old: str, new: str) -> str:
    if old not in text:
        raise SystemExit(f"the kernel no longer holds {old!r}: update the "
                         "variant")
    return text.replace(old, new)


def variants(src: str) -> dict:
    never = "int KV, int hd, int nsl, int causal, float scale) {"
    src = edit(src, never, never + "\n  const bool never = scale < 0.f;")
    out = {"as_is": src}
    v = edit(src, "      wait_for(ctr, kt);\n", "")
    out["no_acquire"] = v
    v = edit(v, "        cp_async16(sAcc", "        if (never) cp_async16(sAcc")
    out["no_prefetch"] = v
    v = edit(v, "      mma_dq(dqa, sDS,", "      if (never) mma_dq(dqa, sDS,")
    v = edit(v, "        if (kt == last) {", "        if (never && kt == last) {")
    v = edit(v, "        } else {\n          __stcg(",
             "        } else if (never) {\n          __stcg(")
    out["no_dq"] = v
    v = edit(v, "          s[i] = exp2_approx(fmaf(", "          s[i] = (fmaf(")
    out["no_exp"] = v
    v = edit(v, "      mma_keys<HDP>(s, sK", "      if (never) mma_keys<HDP>(s, sK")
    v = edit(v, "      mma_keys<HDP>(dp, sV", "      if (never) mma_keys<HDP>(dp, sV")
    out["no_s_dp"] = v
    v = edit(v, "      mma_acc<HDP>(dva, pa,", "      if (never) mma_acc<HDP>(dva, pa,")
    v = edit(v, "      mma_acc<HDP>(dka, dsa,", "      if (never) mma_acc<HDP>(dka, dsa,")
    out["no_dv_dk"] = v
    v = edit(v, "    if (u + 2 < nunits) load_unit(u + 2, st);",
             "    if (never) load_unit(u + 2, st);")
    out["no_loads"] = v
    out["no_dq_section"] = edit(
        v, "    if (wg < C::kNDQ) {\n      float dqa[32];",
        "    if (never && wg < C::kNDQ) {\n      float dqa[32];")
    return out


def build(name: str, text: str, out: Path):
    src = out / f"{name}.cu"
    src.write_text(text)
    lib = out / f"{name}.so"
    return lib, subprocess.Popen(
        [_build.nvcc_path(), *_build.FLAGS, "-I", str(_build.CSRC), "-shared",
         "-o", str(lib), str(src)], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("FAIL: no CUDA device")
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()[0]
    print(f"card: {smi}", flush=True)
    out = ROOT / "build" / "ablation"
    out.mkdir(parents=True, exist_ok=True)
    text = (_build.CSRC / "flash_attention_bwd_tc.cu").read_text()
    jobs = {n: build(n, t, out) for n, t in variants(text).items()}
    fns = {}
    for name, (lib, proc) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            print(log)
            return 1
        fn = ctypes.CDLL(str(lib)).repro_flash_attention_bwd_tc
        fn.argtypes = _build.SIGNATURES["repro_flash_attention_bwd_tc"]
        fn.restype = ctypes.c_int
        fns[name] = fn
    f32 = torch.float32
    for label, B, T, H, KV, hd, causal in SHAPES:
        g = torch.Generator(device="cuda").manual_seed(1)
        q, do = (torch.randn(B, T, H, hd, generator=g, device="cuda")
                 .bfloat16() for _ in range(2))
        k, v = (torch.randn(B, T, KV, hd, generator=g, device="cuda")
                .bfloat16() for _ in range(2))
        o, lse = fa.flash_attention_cuda(q, k, v, causal=causal,
                                         with_lse=True)
        plan = fa.bwd_plan(B, T, T, H, KV, hd, causal)
        TqP = plan.nqt * plan.bq
        D = torch.empty(B, H, TqP, dtype=f32, device="cuda")
        L = torch.empty_like(D)
        acc = torch.empty(B, H, TqP, plan.hdp, dtype=f32, device="cuda")
        ctr = torch.empty(B, H, plan.nqt, dtype=torch.int32, device="cuda")
        dkp = torch.empty(plan.slices, B, T, KV, hd, dtype=f32, device="cuda")
        dvp = torch.empty_like(dkp)
        dq, dk, dv = torch.empty_like(q), torch.empty_like(k), \
            torch.empty_like(v)
        ptrs = [t.data_ptr() for t in (q, k, v, o, lse, do, D, L, acc, ctr,
                                       dkp, dvp, dq, dk, dv)]
        for name, fn in fns.items():
            def call():
                rc = fn(*ptrs, B, T, T, H, KV, hd, int(causal), plan.slices,
                        torch.cuda.current_stream().cuda_stream)
                _build.check(rc, name)
            call()
            torch.cuda.synchronize()
            e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            e0.record()
            for _ in range(5):
                call()
            e1.record()
            torch.cuda.synchronize()
            print(f"{label} q {tuple(q.shape)} kv {tuple(k.shape)} "
                  f"causal={causal} slices={plan.slices} {name}: "
                  f"{e0.elapsed_time(e1) / 5:.3f} ms", flush=True)
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
