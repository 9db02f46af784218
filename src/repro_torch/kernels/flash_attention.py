"""B9: flash attention with an online softmax, hand-written CUDA.

Replaces the Pallas kernel ``repro/kernels/flash_attention.py:
flash_attention_pallas`` (body ``_flash_kernel``), the block-pair compute
of quorum and ring attention (``apps/attention.py``) and the 4-d
``ops.flash_attention``.  Two kernels, chosen by dtype alone
(:func:`route_of`):

* bfloat16 (``"wgmma"``, ``repro_torch/csrc/flash_attention_tc.cu``): Q·Kᵀ
  and P·V on Hopper's bf16 tensor cores (``wgmma``), P·V as two bf16
  products P_hi·V + P_lo·V so that p keeps about 16 bits and the f32
  partials stay within 1e-5 of the plain version; bound by the bf16
  tensor cores (4 * hd operations per visible (query, key) pair at 989
  TFLOP/s; the split issues 6 * hd).
* float32 (``"simt"``, ``repro_torch/csrc/flash_attention.cu``): fp32
  arithmetic outside the tensor cores (67 TFLOP/s); TF32 would break the
  same limits.

The TPU kernel carries the row statistics across its sequential kv grid
axis in VMEM scratch; here a block owns (batch*head, a q tile) and loops
over kv tiles, skipping the tiles past the causal diagonal.  Both read
q / k / v in their ``[B, T, H|KV, hd]`` layout with strides and index kv
head ``h // G``, so nothing is transposed or broadcast first.
The ``partial`` epilogue writes the unnormalized accumulator with the row
max and row sum (the (o, m, l) partial of ``apps/attention.py``) instead
of the normalized output, and ``row_valid`` turns whole batch rows into
the merge identity without computing them.

The normalized epilogue can also write the row's log-sum-exp
(``with_lse``: m + log l [B, Tq, H] float32), which the backward needs.

The backward (:func:`flash_attention_bwd_cuda`) has no Pallas
counterpart: the JAX package differentiates its plain attention with XLA,
and these kernels compute that gradient (dq, dk, dv) from q, k, v, o, lse
and dO in two launches (dq with the D = rowsum(dO * O) prologue, then
dk / dv a block per kv-head key tile walking its G query heads), no
atomics.  Two routes, by dtype and head width (:func:`bwd_route_of`):
``"mma"`` (``csrc/flash_attention_bwd_tc.cu``, bf16 with hd a multiple of
8 up to 128: every product on ``mma.sync`` bf16 tensor cores, P and dS
rounded to bf16 as their products' operands) and ``"simt"``
(``csrc/flash_attention_bwd.cu``, float32 arithmetic; float32 inputs and
the other bf16 widths).  ``ops.flash_attention`` reaches them through a
``torch.autograd.Function`` on a CUDA tensor that needs a gradient.

The plain versions beside them are :func:`flash_attention_plain`,
:func:`flash_block_plain` and :func:`flash_attention_bwd_plain`; the
device dispatch is :func:`repro_torch.kernels.ops.flash_attention` /
``ops.flash_block``.
"""

from __future__ import annotations

import torch

from . import _build
from .ref import flash_attention as flash_attention_plain
from .ref import flash_attention_bwd as flash_attention_bwd_plain
from .ref import flash_block as flash_block_plain

__all__ = ["flash_attention_cuda", "flash_attention_bwd_cuda",
           "flash_attention_plain", "flash_attention_bwd_plain",
           "flash_block_plain", "launches", "bwd_launches", "route_of",
           "bwd_route_of"]

#: forward kernel launches since the count was last set to 0 (both routes)
launches = 0
#: backward calls (two kernel launches each: dq, then dk / dv)
bwd_launches = 0


def route_of(dtype: torch.dtype) -> str:
    """The kernel a CUDA call in ``dtype`` launches: ``"wgmma"`` for
    bfloat16 (every hd in 1..256, padded to 64, 128 or 256), ``"simt"`` for
    float32."""
    return "wgmma" if dtype == torch.bfloat16 else "simt"


def bwd_route_of(dtype: torch.dtype, hd: int) -> str:
    """The backward kernels a CUDA call launches: ``"mma"`` for bfloat16
    with hd a multiple of 8 up to 128, else ``"simt"``."""
    return "mma" if dtype == torch.bfloat16 and hd % 8 == 0 and hd <= 128 \
        else "simt"


def _check(q, k, v):
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"need q [B, Tq, H, hd] and k / v [B, Tk, KV, hd], "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, Tq, H, hd = q.shape
    if k.shape[0] != B or k.shape[3] != hd or H % k.shape[2]:
        raise ValueError(f"k / v {tuple(k.shape)} do not fit q "
                         f"{tuple(q.shape)} (H must be a multiple of KV)")
    if q.dtype not in (torch.float32, torch.bfloat16) or \
            k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"q, k, v must share float32 or bfloat16, got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    if not 1 <= hd <= 256:
        raise ValueError(f"head_dim must be in 1..256, got {hd}")


def _last_contiguous(t: torch.Tensor) -> torch.Tensor:
    return t if t.stride(-1) == 1 else t.contiguous()


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool, partial: bool = False,
                         row_valid: torch.Tensor | None = None,
                         with_lse: bool = False):
    """q [B, Tq, H, hd], k / v [B, Tk, KV, hd] (float32 or bfloat16, one
    CUDA device).  ``partial=False``: the normalized output [B, Tq, H, hd]
    in q's dtype, as ``ref.flash_attention``.  ``partial=True``: ``(o, m,
    l)`` float32 — o [B, Tq, H, hd] unnormalized, m / l [B, Tq, H] — as
    ``ref.flash_block``.  ``row_valid`` [B] (bool or integer): rows whose
    flag is 0 are written as the merge identity (o = 0, m = NEG_INF,
    l = 0).  ``with_lse`` (normalized output only): also the row
    log-sum-exp [B, Tq, H] float32, returned as ``(o, lse)``; ``o`` is the
    same either way.  bfloat16 launches the ``wgmma`` kernel, float32 the
    SIMT one (:func:`route_of`); either way one launch, counted in
    ``launches``."""
    global launches
    _check(q, k, v)
    if with_lse and (partial or row_valid is not None):
        raise ValueError("with_lse is for the normalized output of every "
                         "row (no partial, no row_valid)")
    _build.require_cuda("flash_attention", q, k, v)
    q, k, v = (_last_contiguous(t) for t in (q, k, v))
    B, Tq, H, hd = q.shape
    Tk, KV = k.shape[1], k.shape[2]
    dev = q.device
    if partial:
        o = torch.empty(B, Tq, H, hd, dtype=torch.float32, device=dev)
        m = torch.empty(B, Tq, H, dtype=torch.float32, device=dev)
        l = torch.empty(B, Tq, H, dtype=torch.float32, device=dev)
    else:
        o = torch.empty(B, Tq, H, hd, dtype=q.dtype, device=dev)
        m = l = None
    lse = (torch.empty(B, Tq, H, dtype=torch.float32, device=dev)
           if with_lse else None)
    valid = None
    if row_valid is not None:
        valid = torch.as_tensor(row_valid, device=dev).reshape(-1)
        if valid.numel() != B:
            raise ValueError(f"row_valid has {valid.numel()} flags for "
                             f"{B} rows")
        valid = valid.to(torch.int32).contiguous()
    out = (o, m, l) if partial else (o, lse) if with_lse else o
    if o.numel() == 0:
        return out
    if Tk == 0:
        raise ValueError("flash_attention needs at least one key")
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            m.data_ptr() if partial else None,
            l.data_ptr() if partial else None,
            lse.data_ptr() if with_lse else None,
            valid.data_ptr() if valid is not None else None,
            B, Tq, Tk, H, KV, hd, *q.stride()[:3], *k.stride()[:3],
            *v.stride()[:3], int(causal), int(partial))
    lib = _build.library()
    fn = (lib.repro_flash_attention_tc if route_of(q.dtype) == "wgmma"
          else lib.repro_flash_attention)
    with torch.cuda.device(dev):
        rc = fn(*args, _build.stream_of(q))
    _build.check(rc, "flash_attention")
    launches += 1
    return out


def flash_attention_bwd_cuda(q, k, v, o, lse, do, *, causal: bool):
    """The gradient of :func:`flash_attention_cuda`'s normalized output:
    q / o / do [B, Tq, H, hd], k / v [B, Tk, KV, hd] (one dtype, float32 or
    bfloat16), lse [B, Tq, H] float32 from the forward's ``with_lse`` ->
    (dq, dk, dv) in q's dtype, dk / dv summed over each kv head's G query
    heads.  Two kernel launches on the current stream (dq with the D
    prologue, then dk / dv) of the route :func:`bwd_route_of` names,
    counted once in ``bwd_launches``."""
    global bwd_launches
    _check(q, k, v)
    _build.require_cuda("flash_attention_bwd", q, k, v, o, lse, do)
    if o.shape != q.shape or do.shape != q.shape or o.dtype != q.dtype \
            or do.dtype != q.dtype:
        raise ValueError(f"o and do must match q {tuple(q.shape)} "
                         f"{q.dtype}, got {tuple(o.shape)} {o.dtype} and "
                         f"{tuple(do.shape)} {do.dtype}")
    B, Tq, H, hd = q.shape
    Tk, KV = k.shape[1], k.shape[2]
    if lse.shape != (B, Tq, H) or lse.dtype != torch.float32:
        raise ValueError(f"lse must be [B, Tq, H] = {(B, Tq, H)} float32, "
                         f"got {tuple(lse.shape)} {lse.dtype}")
    # contiguous, and 16-byte aligned for the mma route's vector loads (a
    # fresh copy is)
    q, k, v, o, lse, do = (
        t if t.is_contiguous() and t.data_ptr() % 16 == 0
        else t.clone(memory_format=torch.contiguous_format)
        for t in (q, k, v, o, lse, do))
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), \
        torch.empty_like(v)
    if q.numel() == 0 or k.numel() == 0:
        return dq, dk.zero_(), dv.zero_()
    D = torch.empty(B, Tq, H, dtype=torch.float32, device=q.device)
    lib = _build.library()
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), do.data_ptr(), D.data_ptr(), dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), B, Tq, Tk, H, KV, hd, int(causal))
    with torch.cuda.device(q.device):
        if bwd_route_of(q.dtype, hd) == "mma":
            rc = lib.repro_flash_attention_bwd_tc(*args, _build.stream_of(q))
        else:
            rc = lib.repro_flash_attention_bwd(
                *args, int(q.dtype == torch.bfloat16), _build.stream_of(q))
    _build.check(rc, "flash_attention_bwd")
    bwd_launches += 1
    return dq, dk, dv
