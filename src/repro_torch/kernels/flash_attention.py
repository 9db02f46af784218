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

The plain versions beside it are :func:`flash_attention_plain` and
:func:`flash_block_plain`; the device dispatch is
:func:`repro_torch.kernels.ops.flash_attention` / ``ops.flash_block``.
"""

from __future__ import annotations

import torch

from . import _build
from .ref import flash_attention as flash_attention_plain
from .ref import flash_block as flash_block_plain

__all__ = ["flash_attention_cuda", "flash_attention_plain",
           "flash_block_plain", "launches", "route_of"]

#: kernel launches since the count was last set to 0 (both routes)
launches = 0


def route_of(dtype: torch.dtype) -> str:
    """The kernel a CUDA call in ``dtype`` launches: ``"wgmma"`` for
    bfloat16 (every hd in 1..256, padded to 64, 128 or 256), ``"simt"`` for
    float32."""
    return "wgmma" if dtype == torch.bfloat16 else "simt"


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
                         row_valid: torch.Tensor | None = None):
    """q [B, Tq, H, hd], k / v [B, Tk, KV, hd] (float32 or bfloat16, one
    CUDA device).  ``partial=False``: the normalized output [B, Tq, H, hd]
    in q's dtype, as ``ref.flash_attention``.  ``partial=True``: ``(o, m,
    l)`` float32 — o [B, Tq, H, hd] unnormalized, m / l [B, Tq, H] — as
    ``ref.flash_block``.  ``row_valid`` [B] (bool or integer): rows whose
    flag is 0 are written as the merge identity (o = 0, m = NEG_INF,
    l = 0).  bfloat16 launches the ``wgmma`` kernel, float32 the SIMT one
    (:func:`route_of`); either way one launch, counted in ``launches``."""
    global launches
    _check(q, k, v)
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
    valid = None
    if row_valid is not None:
        valid = torch.as_tensor(row_valid, device=dev).reshape(-1)
        if valid.numel() != B:
            raise ValueError(f"row_valid has {valid.numel()} flags for "
                             f"{B} rows")
        valid = valid.to(torch.int32).contiguous()
    if o.numel() == 0:
        return (o, m, l) if partial else o
    if Tk == 0:
        raise ValueError("flash_attention needs at least one key")
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            m.data_ptr() if partial else None,
            l.data_ptr() if partial else None,
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
    return (o, m, l) if partial else o
