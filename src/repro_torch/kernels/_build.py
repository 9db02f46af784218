"""Build and load the port's CUDA kernels (``repro_torch/csrc/*.cu``).

Every source is compiled by its own ``nvcc`` process, all started at once,
into an object file for ``sm_90a``; the objects are linked into one shared
library with a plain C interface, loaded with ``ctypes``.  The build lands
in ``build/repro_torch/<hash>/`` at the root of the checkout (git-ignored),
keyed on the hash of the sources and flags, at the first call that needs
it — so a fresh checkout builds everything on its first kernel launch.
Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
SOURCES = ("pairwise_batch.cu", "pairwise_corr.cu", "pcit_filter.cu",
           "query_topk.cu", "pairwise_threshold.cu", "pairwise_topk.cu",
           "pairwise_threshold_q.cu", "pairwise_topk_q.cu",
           "flash_attention.cu", "flash_attention_tc.cu",
           "flash_attention_bwd.cu", "flash_attention_bwd_tc.cu",
           "ssd_chunk.cu", "ssd_chunk_bwd.cu")
# headers the sources include (part of the build key)
HEADERS = ("pair_tile.cuh", "hopper.cuh", "topk_select.cuh",
           "compact.cuh", "row_norms.cuh", "flash_bwd.cuh", "tf32x3.cuh",
           "chunk_join.cuh")
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# the PCIT filter's output is a threshold decision: no FMA contraction and
# IEEE division / sqrt, so each step rounds as the plain version's ops do
FILE_FLAGS = {"pcit_filter.cu": ("-fmad=false", "-prec-div=true",
                                 "-prec-sqrt=true", "-ftz=false"),
              # the quantized kernels' dequant epilogue and error band
              # round op for op as the plain versions' ops do
              "pairwise_threshold_q.cu": ("-fmad=false",),
              "pairwise_topk_q.cu": ("-fmad=false",)}
LIB_NAME = "librepro_torch_kernels.so"

_vp, _i, _f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ll = ctypes.c_longlong
SIGNATURES = {
    # quorum, lo, hi, w, list, partial, out, B, k, block, n_pairs,
    # softening, stream
    "repro_pairwise_batch_forces": [_vp] * 7 + [_i] * 4 + [_f, _vp],
    # a, b, c, batch, M, N, K, stream
    "repro_pairwise_corr": [_vp] * 3 + [_i] * 4 + [_vp],
    # r_xy, rows_x, rows_y, gx, gy, keep, visits, stats, batch, M, N, Z,
    # prefilter, stream
    "repro_pcit_filter": [_vp] * 8 + [_i] * 5 + [_vp],
    # a, b, c, out, n, exact, stream
    "repro_pcit_probe": [_vp] * 4 + [_i] * 2 + [_vp],
    # stack, queries, mask, gidx, list_v, list_i, list_full, out_v, out_i,
    # P, k, block, d, Q, topk, l2, stream
    "repro_query_topk": [_vp] * 9 + [_i] * 7 + [_vp],
    # rows per chunk list of the first query_topk pass
    "repro_query_topk_chunk_rows": [],
    # quorum, lo, hi, meta, norms, hot, row_count, row_off, out_v, out_i,
    # out_j, count, P, k, block, d, n_pairs, block_rows, threshold,
    # capacity, l2, stream
    "repro_pairwise_threshold": [_vp] * 12 + [_i] * 6 + [_f, _ll, _i, _vp],
    # quorum, lo, hi, meta, norms, list_v, list_i, out_v, out_i,
    # P, k, block, d, n_pairs, block_rows, topk, tp, l2, score_only, stream
    "repro_pairwise_topk": [_vp] * 9 + [_i] * 10 + [_vp],
    # q, sd, sq, lo, hi, meta, list_v, list_i, out_v, out_i,
    # P, k, block, d, n_pairs, block_rows, topk, tp, l2, bf16, route, stream
    "repro_pairwise_topk_q": [_vp] * 10 + [_i] * 11 + [_vp],
    # q, sd, l1, sq, lo, hi, meta, hot, warp_hot, row_count, row_off,
    # out_v, out_i, out_j, count, P, k, block, d, n_pairs, block_rows,
    # threshold, capacity, l2, bf16, route, stream
    "repro_pairwise_threshold_q": [_vp] * 15 + [_i] * 6 + [_f, _ll]
    + [_i] * 3 + [_vp],
    # q, k, v, o, m, l, lse, row_valid, B, Tq, Tk, H, KV, hd, the (batch,
    # time, head) strides of q, k and v, causal, partial, stream: float32
    # (TF32 tensor cores, three products)
    "repro_flash_attention": [_vp] * 8 + [_i] * 6 + [_ll] * 9 + [_i] * 2
    + [_vp],
    # the same for bfloat16 (wgmma)
    "repro_flash_attention_tc": [_vp] * 8 + [_i] * 6 + [_ll] * 9 + [_i] * 2
    + [_vp],
    # q, k, v, o, lse, do, D, dq, dk, dv, B, Tq, Tk, H, KV, hd, causal,
    # bf16, stream: B9's backward (TF32 tensor cores)
    "repro_flash_attention_bwd": [_vp] * 10 + [_i] * 8 + [_vp],
    # q, k, v, o, lse, do, D, lse rows, dq accumulator, chain counters, dk
    # and dv slice partials, dq, dk, dv, B, Tq, Tk, H, KV, hd, causal,
    # slices, stream: B9's backward in bfloat16 (wgmma)
    "repro_flash_attention_bwd_tc": [_vp] * 15 + [_i] * 8 + [_vp],
    # x, dt, A, B, C, y, S, cd, batch, T, H, P, N, chunk, the (batch, time,
    # head) strides of x, the (batch, time) strides of B and C, stream
    "repro_ssd_chunk": [_vp] * 8 + [_i] * 6 + [_ll] * 7 + [_vp],
    # x, dt, A, B, C, dy, dS, dcd, dx, ddt, dA partials, dB, dC, dCB
    # partials, C B^T, dB partials, e dt, batch, T, H, P, N, chunk, K
    # blocks of dB's S term, the strides as above, stream: B10's backward
    "repro_ssd_chunk_bwd": [_vp] * 17 + [_i] * 7 + [_ll] * 7 + [_vp],
}


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc`` (default
    ``/usr/local/cuda``), else ``nvcc`` on the PATH."""
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built "
                           "(set CUDA_HOME or put nvcc on the PATH)")
    return found


# the sources that include chunk_join.cuh: B7's and B8's bf16 chunk length
CHUNKED = ("pairwise_threshold_q.cu", "pairwise_topk_q.cu")


def _flags(src: str, chunk: int | None = None) -> tuple:
    """nvcc's flags for ``src``; B7 and B8 also take their bf16 chunk
    length, ``chunk`` (default ``pairwise_batch_q.BF16_CHUNK``), as
    ``-DREPRO_BF16_CHUNK``."""
    flags = FLAGS + FILE_FLAGS.get(src, ())
    if src not in CHUNKED:
        return flags
    from .pairwise_batch_q import BF16_CHUNK
    return flags + (f"-DREPRO_BF16_CHUNK={chunk or BF16_CHUNK}",)


def build_key() -> str:
    """Hash of every source, header and flag set — the build directory's
    name."""
    h = hashlib.sha256()
    for src in SOURCES:
        h.update(src.encode())
        h.update(" ".join(_flags(src)).encode())
        h.update((CSRC / src).read_bytes())
    for hdr in HEADERS:
        h.update(hdr.encode())
        h.update((CSRC / hdr).read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile (if not already built for these sources) and return the
    shared library's path.  The compiler's ``-Xptxas -v`` report (registers,
    shared memory, spills per kernel) is kept in ``build.log`` beside it."""
    out_dir = BUILD_ROOT / build_key()
    lib = out_dir / LIB_NAME
    if lib.exists():
        return lib
    BUILD_ROOT.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    tmp = Path(tempfile.mkdtemp(dir=BUILD_ROOT))
    try:
        procs = []
        for src in SOURCES:
            obj = tmp / (src + ".o")
            cmd = [nvcc, *_flags(src), "-c", str(CSRC / src), "-o", str(obj)]
            procs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        log, failed = [], []
        for src, _obj, proc in procs:
            text, _ = proc.communicate()
            log.append(f"== {src} (rc={proc.returncode})\n{text}")
            if proc.returncode:
                failed.append(src)
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(log))
        link = subprocess.run(
            [nvcc, "-shared", "-o", str(tmp / LIB_NAME),
             *(str(obj) for _src, obj, _p in procs)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode:
            raise RuntimeError(f"linking {LIB_NAME} failed:\n{link.stdout}")
        (tmp / "build.log").write_text("\n".join(log))
        try:
            os.replace(tmp, out_dir)  # atomic: a concurrent build may win
        except OSError:
            if not lib.exists():
                raise
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return lib


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library with every entry point's ``argtypes`` /
    ``restype`` declared (built on first use)."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def check(rc: int, name: str) -> None:
    """Raise if a C entry point returned a CUDA error from its launch."""
    if rc:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError {rc}")


def stream_of(t: torch.Tensor) -> int:
    """PyTorch's current CUDA stream on ``t``'s device (kernels launch on
    it and never synchronize)."""
    return torch.cuda.current_stream(t.device).cuda_stream


def require_cuda(name: str, *tensors: torch.Tensor) -> None:
    """Raise unless every tensor lies on one CUDA device."""
    devs = {t.device for t in tensors}
    if len(devs) != 1 or next(iter(devs)).type != "cuda":
        raise ValueError(f"{name}: the CUDA kernel needs every tensor on one "
                         f"CUDA device, got {sorted(map(str, devs))}")
