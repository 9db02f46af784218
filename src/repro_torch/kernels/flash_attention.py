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
* float32 (``"tf32x3"``, ``repro_torch/csrc/flash_attention.cu``): Q·Kᵀ
  and P·V on the TF32 tensor cores (``wgmma`` at hd <= 128, ``mma.sync``
  at hd 256) as three products of a hi / lo split of each operand
  (``csrc/tf32x3.cuh``).  One TF32 product keeps 10 mantissa bits and
  puts the f32 partials far outside their 1e-5 rule; the split keeps them
  within it, as float32 arithmetic does (``tests/test_torch_flash_tf32x3.py``
  emulates both on the CPU; against a float64 evaluation on the card the
  kernel reads below the plain float32 version, PERF.md).  Bound by the
  TF32 tensor cores: 12 * hd TF32 operations per visible pair at 495
  TFLOP/s.

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
and dO, no float atomics, every sum in a fixed order.  Two routes, by
dtype and head width (:func:`bwd_route_of`):

* ``"wgmma"`` (``csrc/flash_attention_bwd_tc.cu``, bf16 with hd a
  multiple of 8 up to 128): a prologue (D = rowsum(dO * O)), one fused
  launch of a block per (128-key tile, b, kv head, slice of the kv head's
  G query heads) that forms S and dP once per visible pair on ``wgmma``
  and passes each query tile's dQ from key tile to key tile through an
  integer counter, and, when the heads are cut into s > 1 slices, a sum of
  the slices' dK / dV partials.  :func:`bwd_plan` is its launch plan.
* ``"tf32x3"`` (``csrc/flash_attention_bwd.cu``, float32 inputs and the
  other bf16 widths): the TF32 tensor cores with the same three-product
  split (bf16 inputs are exact in TF32, so their products take one or
  two); dq with the D prologue, then dk / dv a block per kv-head key tile
  walking its G query heads.

``ops.flash_attention`` reaches them through a ``torch.autograd.Function``
on a CUDA tensor that needs a gradient.

The plain versions beside them are :func:`flash_attention_plain`,
:func:`flash_block_plain` and :func:`flash_attention_bwd_plain`; the
device dispatch is :func:`repro_torch.kernels.ops.flash_attention` /
``ops.flash_block``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from . import _build
from .ref import flash_attention as flash_attention_plain
from .ref import flash_attention_bwd as flash_attention_bwd_plain
from .ref import flash_block as flash_block_plain

__all__ = ["flash_attention_cuda", "flash_attention_bwd_cuda",
           "flash_attention_plain", "flash_attention_bwd_plain",
           "flash_block_plain", "launches", "bwd_launches", "route_of",
           "bwd_route_of", "BwdPlan", "bwd_plan"]

#: forward kernel launches since the count was last set to 0 (both routes)
launches = 0
#: backward calls (each two or three kernel launches of one route)
bwd_launches = 0

#: query rows a unit and keys a block of the ``"wgmma"`` backward
BWD_BQ, BWD_BK = 64, 128
#: streaming multiprocessors of the H100 SXM, for the slice count
SMS = 132


def route_of(dtype: torch.dtype) -> str:
    """The kernel a CUDA call in ``dtype`` launches: ``"wgmma"`` for
    bfloat16 (every hd in 1..256, padded to 64, 128 or 256), ``"tf32x3"``
    for float32 (the TF32 tensor cores, three products a multiply-add)."""
    return "wgmma" if dtype == torch.bfloat16 else "tf32x3"


def bwd_route_of(dtype: torch.dtype, hd: int) -> str:
    """The backward kernels a CUDA call launches: ``"wgmma"`` for bfloat16
    with hd a multiple of 8 up to 128, else ``"tf32x3"`` (the TF32 tensor
    cores; float32 operands as three products, bfloat16 ones exact)."""
    return "wgmma" if dtype == torch.bfloat16 and hd % 8 == 0 \
        and hd <= 128 else "tf32x3"


@dataclass(frozen=True)
class BwdPlan:
    """The launch plan of the ``"wgmma"`` backward (what
    ``csrc/flash_attention_bwd_tc.cu`` computes from the same numbers).

    Block ``i`` of the fused launch owns key tile ``kt = i // ncol`` (keys
    ``[kt * bk, kt * bk + bk)``) of batch row ``b``, kv head ``kvh`` and head
    slice ``sl``, with ``i % ncol = (b * KV + kvh) * slices + sl``: blocks
    are numbered key-tile-major.  It walks its units (:meth:`units`): the
    query tiles of ``bq`` rows from the last down to :meth:`qt0`, and in
    each the slice's heads in order.  Query tile ``qt`` of head ``h`` sums
    its dQ over key tiles ``0 .. chain_len[qt] - 1`` in that order: a block
    only ever waits on the block ``ncol`` indices before it."""

    B: int
    Tq: int
    Tk: int
    H: int
    KV: int
    hd: int
    causal: bool
    slices: int
    bq: int = BWD_BQ
    bk: int = BWD_BK

    @property
    def G(self) -> int:
        return self.H // self.KV

    @property
    def hdp(self) -> int:
        """hd padded to the kernel's tile width (64 or 128)."""
        return 64 if self.hd <= 64 else 128

    @property
    def nqt(self) -> int:
        return -(-self.Tq // self.bq)

    @property
    def nkt(self) -> int:
        return -(-self.Tk // self.bk)

    @property
    def ncol(self) -> int:
        return self.B * self.KV * self.slices

    @property
    def blocks(self) -> int:
        return self.nkt * self.ncol

    def head_slice(self, sl: int) -> range:
        """The query heads (0 .. G - 1 within the kv head) of slice sl."""
        return range(sl * self.G // self.slices,
                     (sl + 1) * self.G // self.slices)

    def block(self, i: int) -> tuple[int, int, int, int]:
        """(kt, b, kvh, sl) of block i."""
        kt, c = divmod(i, self.ncol)
        bk, sl = divmod(c, self.slices)
        b, kvh = divmod(bk, self.KV)
        return kt, b, kvh, sl

    def qt0(self, kt: int) -> int:
        """The first query tile with a row that sees a key of tile kt (with
        causal Tq > Tk the first rows see no key and weigh every key)."""
        off = self.Tk - self.Tq
        if self.causal and off >= 0:
            return max(0, kt * self.bk - off) // self.bq
        return 0

    def units(self, kt: int, sl: int) -> list[tuple[int, int]]:
        """(query tile, head within the kv head) of a block, in its order."""
        return [(qt, g) for qt in range(self.nqt - 1, self.qt0(kt) - 1, -1)
                for g in self.head_slice(sl)]

    def skips(self, kt: int, w: int, qt: int) -> bool:
        """Whether warpgroup w (keys ``kt * bk + 64 w ..``) of a block skips
        query tile qt: none of its keys is visible to the tile's rows (and
        no row sees no key), so its P and dS are 0."""
        kw0, q0, off = kt * self.bk + 64 * w, qt * self.bq, self.Tk - self.Tq
        return kw0 >= self.Tk or (self.causal and q0 + off >= 0 and
                                  kw0 > min(q0 + self.bq, self.Tq) - 1 + off)

    def issued_ops(self) -> int:
        """Tensor-core operations the fused launch issues (padding and
        masked entries included): per unit, each warpgroup that does not
        skip forms S^T, dP^T, dV and dK (2 * 64 * bq * hdp each), and the
        block forms dQ (2 * bq * bk * hdp)."""
        per_wg = 4 * 2 * 64 * self.bq * self.hdp
        dq = 2 * self.bq * self.bk * self.hdp
        total = 0
        for kt in range(self.nkt):
            for qt in range(self.qt0(kt), self.nqt):
                total += dq + per_wg * sum(not self.skips(kt, w, qt)
                                           for w in range(self.bk // 64))
        return total * self.B * self.H

    @property
    def chain_len(self) -> tuple[int, ...]:
        """Key tiles in each query tile's dQ chain (tiles 0 .. n - 1)."""
        off = self.Tk - self.Tq
        if self.causal and off >= 0:
            return tuple(min(self.nkt - 1,
                             (qt * self.bq + self.bq - 1 + off) // self.bk)
                         + 1 for qt in range(self.nqt))
        return (self.nkt,) * self.nqt


def bwd_plan(B: int, Tq: int, Tk: int, H: int, KV: int, hd: int,
             causal: bool, *, slices: int | None = None,
             sms: int = SMS) -> BwdPlan:
    """The ``"wgmma"`` backward's launch plan.  The slice count (unless
    given) is the least that gives the fused launch about three blocks per
    SM, ``B * KV * nkt * s >= 3 * sms``, at most G: starcoder2's training
    shape (B 2, KV 2, Tk 4,096: 128 key tiles) takes 4, whisper's encoder
    (B 8, KV 20, Tk 1,500: 1,920) 1."""
    G = H // KV
    if slices is None:
        tiles = B * KV * -(-Tk // BWD_BK)
        slices = min(G, max(1, math.ceil(3 * sms / max(tiles, 1))))
    if not 1 <= slices <= G:
        raise ValueError(f"slices must be in 1..{G}, got {slices}")
    return BwdPlan(B, Tq, Tk, H, KV, hd, bool(causal), slices)


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


def visible_pairs(Tq: int, Tk: int, causal: bool) -> int:
    """(query, key) pairs a head attends over: every pair, or with causal
    masking (end-aligned) row i's first ``i + Tk - Tq + 1`` keys."""
    if not causal:
        return Tq * Tk
    lo = max(0, Tq - Tk)                   # rows before lo see no key
    first, last = lo + Tk - Tq + 1, Tk     # row lo's keys, row Tq - 1's
    return (Tq - lo) * (first + last) // 2 if Tq > lo else 0


def operations(B: int, Tq: int, Tk: int, H: int, hd: int, causal: bool,
               backward: bool = False) -> float:
    """The algorithm's operations (the bound of PERF.md's table): 4 hd per
    visible pair and head forward (q.k, p.v), 10 hd backward (S, dP, dV,
    dQ, dK)."""
    return (10.0 if backward else 4.0) * hd * B * H * \
        visible_pairs(Tq, Tk, causal)


def _outputs(q, partial: bool, with_lse: bool, row_valid):
    """(o, m, l, lse, valid): what a forward call writes, on ``q``'s
    device, as either route allocates it (m / l / lse / valid None where
    the call has none)."""
    B, Tq, H, hd = q.shape
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
    return o, m, l, lse, valid


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
    ``tf32x3`` one (:func:`route_of`); either way one launch, counted in
    ``launches``.  On ``meta`` tensors (a dry run) the outputs are
    allocated as here and nothing launches or counts."""
    global launches
    _check(q, k, v)
    if with_lse and (partial or row_valid is not None):
        raise ValueError("with_lse is for the normalized output of every "
                         "row (no partial, no row_valid)")
    meta = _build.on_meta(q, k, v)
    if not meta:
        _build.require_cuda("flash_attention", q, k, v)
    q, k, v = (_last_contiguous(t) for t in (q, k, v))
    B, Tq, H, hd = q.shape
    Tk, KV = k.shape[1], k.shape[2]
    o, m, l, lse, valid = _outputs(q, partial, with_lse, row_valid)
    out = (o, m, l) if partial else (o, lse) if with_lse else o
    if o.numel() == 0:
        return out
    if Tk == 0:
        raise ValueError("flash_attention needs at least one key")
    if meta:
        _build.meta_call("flash_attention",
                         operations(B, Tq, Tk, H, hd, causal), (q, k, v),
                         [t for t in (o, m, l, lse) if t is not None])
        return out
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
    with torch.cuda.device(q.device):
        rc = fn(*args, _build.stream_of(q))
    _build.check(rc, "flash_attention")
    launches += 1
    return out


def flash_attention_bwd_cuda(q, k, v, o, lse, do, *, causal: bool):
    """The gradient of :func:`flash_attention_cuda`'s normalized output:
    q / o / do [B, Tq, H, hd], k / v [B, Tk, KV, hd] (one dtype, float32 or
    bfloat16), lse [B, Tq, H] float32 from the forward's ``with_lse`` ->
    (dq, dk, dv) in q's dtype, dk / dv summed over each kv head's G query
    heads.  The kernels of the route :func:`bwd_route_of` names, on the
    current stream: ``"wgmma"`` the prologue, the fused launch and (with
    s > 1 head slices) the slice sum, as :func:`bwd_plan` lays them out;
    ``"tf32x3"`` dq with the D prologue, then dk / dv.  Counted once in
    ``bwd_launches``.  On ``meta`` tensors the outputs and the route's
    scratch (at the H100's :data:`SMS`) are allocated as here and nothing
    launches or counts."""
    global bwd_launches
    _check(q, k, v)
    meta = _build.on_meta(q, k, v, o, lse, do)
    if not meta:
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
    # contiguous, and 16-byte aligned for the wgmma route's 16-byte copies
    # (a fresh copy is)
    q, k, v, o, lse, do = (
        t if t.is_contiguous() and t.data_ptr() % 16 == 0
        else t.clone(memory_format=torch.contiguous_format)
        for t in (q, k, v, o, lse, do))
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), \
        torch.empty_like(v)
    if q.numel() == 0 or k.numel() == 0:
        return dq, dk.zero_(), dv.zero_()
    route = bwd_route_of(q.dtype, hd)
    sms = SMS if meta else \
        torch.cuda.get_device_properties(q.device).multi_processor_count
    plan, D, scratch = _bwd_scratch(route, B, Tq, Tk, H, KV, hd, causal,
                                    sms, q.device)
    if meta:
        _build.meta_call("flash_attention_bwd",
                         operations(B, Tq, Tk, H, hd, causal, True),
                         (q, k, v, o, lse, do), (dq, dk, dv))
        return dq, dk, dv
    lib = _build.library()
    with torch.cuda.device(q.device):
        if route == "wgmma":
            lse_rows, dq_acc, counters, dkp, dvp = scratch
            rc = lib.repro_flash_attention_bwd_tc(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                lse.data_ptr(), do.data_ptr(), D.data_ptr(),
                lse_rows.data_ptr(), dq_acc.data_ptr(), counters.data_ptr(),
                None if dkp is None else dkp.data_ptr(),
                None if dvp is None else dvp.data_ptr(), dq.data_ptr(),
                dk.data_ptr(), dv.data_ptr(), B, Tq, Tk, H, KV, hd,
                int(causal), plan.slices, _build.stream_of(q))
        else:
            rc = lib.repro_flash_attention_bwd(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                lse.data_ptr(), do.data_ptr(), D.data_ptr(), dq.data_ptr(),
                dk.data_ptr(), dv.data_ptr(), B, Tq, Tk, H, KV, hd,
                int(causal), int(q.dtype == torch.bfloat16),
                _build.stream_of(q))
    _build.check(rc, "flash_attention_bwd")
    bwd_launches += 1
    return dq, dk, dv


def _bwd_scratch(route: str, B: int, Tq: int, Tk: int, H: int, KV: int,
                 hd: int, causal: bool, sms: int, dev):
    """(plan, D, scratch) of a backward call on ``route``, as either route
    allocates them: the ``"wgmma"`` plan for ``sms`` SMs with D and its
    (lse_rows, dq_acc, counters, dK / dV slice partials or None), or
    (None, D, ()) for ``"tf32x3"``."""
    f32 = torch.float32
    if route != "wgmma":
        return None, torch.empty(B, Tq, H, dtype=f32, device=dev), ()
    plan = bwd_plan(B, Tq, Tk, H, KV, hd, causal, sms=sms)
    TqP = plan.nqt * plan.bq
    D = torch.empty(B, H, TqP, dtype=f32, device=dev)
    lse_rows = torch.empty(B, H, TqP, dtype=f32, device=dev)
    dq_acc = torch.empty(B, H, TqP, plan.hdp, dtype=f32, device=dev)
    counters = torch.empty(B, H, plan.nqt, dtype=torch.int32, device=dev)
    dkp = dvp = None
    if plan.slices > 1:
        dkp, dvp = (torch.empty(plan.slices, B, Tk, KV, hd, dtype=f32,
                                device=dev) for _ in range(2))
    return plan, D, (lse_rows, dq_acc, counters, dkp, dvp)
