"""Quorum sequence-parallel block attention (port of
``repro/apps/attention.py``).

Causal attention over sequence blocks is the triangular all-pairs
problem: every (q-block, kv-block) pair with kv <= q must meet on some
device.  Ring attention moves (k, v) P - 1 times; the quorum schedule
gathers q, k and v with k - 1 ~ sqrt(P) shifts, computes each causal pair
once at its owner and routes the partial results home with k - 1 more
shifts (DESIGN.md section 2).  Partials combine under the exact flash
monoid on (o, m, l) — associative and commutative, so the order of the
scatter does not matter.

The devices this process holds are the leading axis of the comm layer
(:mod:`repro_torch.core.comm`; L = P in one process, 1 a rank under
``DistributedComm``): a per-device block is ``[L, B, T/P, H|KV, hd]``, and
one block pair runs for all L devices at once, as one launch of kernel B9
(``kernels/flash_attention.py``) over the flattened ``[L*B]`` rows on a
CUDA device.  The schedule's invalid (device, pair) slots — a
pair whose kv block lies after its q block — are the merge identity; the
kernel writes the identity for them without computing them.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from ..core.comm import Comm
from ..core.scheduler import CausalSchedule, build_causal_schedule
from ..core.sweep import quorum_gather, quorum_scatter
from ..kernels import ops
from ..kernels.ref import NEG_INF
from ..obs import trace as obs_trace

__all__ = ["NEG_INF", "flash_block", "merge_partials", "empty_partial",
           "quorum_attention", "ring_attention", "distributed_attention",
           "reference_attention"]

Partial = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


# ---------------------------------------------------------------------------
# Block-pair flash attention and the (o, m, l) monoid
# ---------------------------------------------------------------------------

def flash_block(q, k, v, *, causal_diag: bool, valid=None) -> Partial:
    """Partial attention of one (q-block, kv-block) pair.

    q: [B, Tq, H, hd]; k / v: [B, Tk, KV, hd].  Returns (o [B, Tq, H, hd]
    float32, UNNORMALIZED — o = sum exp(s - m) v; m [B, Tq, H] row max;
    l [B, Tq, H] row sum-exp).  ``causal_diag`` applies the triangular mask
    (the d = 0 self block).  ``valid`` [B]: rows whose flag is 0 are the
    merge identity (o = 0, m = NEG_INF, l = 0).  Kernel B9 on a CUDA
    device; the reference's jnp body, op for op, on the CPU.
    """
    return ops.flash_block(q, k, v, causal=causal_diag, row_valid=valid)


def merge_partials(a: Partial, b: Partial) -> Partial:
    """Exact flash monoid on (o, m, l) with unnormalized o."""
    oa, ma, la = a
    ob, mb, lb = b
    m = torch.maximum(ma, mb)
    ca = torch.exp(ma - m)
    cb = torch.exp(mb - m)
    return (oa * ca[..., None] + ob * cb[..., None], m, la * ca + lb * cb)


def empty_partial(shape_q, H: int, dtype=torch.float32,
                  device=None) -> Partial:
    """Identity element of the flash (o, m, l) merge monoid for blocks of
    ``shape_q`` = (..., Tq, hd) and H heads."""
    *lead, Tq, hd = shape_q
    return (torch.zeros(*lead, Tq, H, hd, dtype=dtype, device=device),
            torch.full((*lead, Tq, H), NEG_INF, dtype=dtype, device=device),
            torch.zeros(*lead, Tq, H, dtype=dtype, device=device))


def _normalize(part: Partial, dtype) -> torch.Tensor:
    o, _m, l = part
    return (o / torch.clamp_min(l, 1e-30)[..., None]).to(dtype)


def _pair(q, k, v, *, causal_diag: bool, valid) -> Partial:
    """flash_block over the [L, B, ...] device axis as one [L*B] batch."""
    P, B = q.shape[:2]
    flat = [t.reshape(P * B, *t.shape[2:]) for t in (q, k, v)]
    rows = torch.as_tensor(valid, device=q.device).repeat_interleave(B)
    part = flash_block(*flat, causal_diag=causal_diag, valid=rows)
    return tuple(t.reshape(P, B, *t.shape[1:]) for t in part)


# ---------------------------------------------------------------------------
# Quorum attention
# ---------------------------------------------------------------------------

def quorum_attention(q, k, v, comm: Comm, *,
                     schedule: Optional[CausalSchedule] = None):
    """The counterpart of the reference's ``quorum_attention_local``, for
    the L = ``len(comm.local)`` devices this process holds at once.  q:
    [L, B, T/P, H, hd] (local device i holds sequence block
    ``comm.local[i]``); k / v: [L, B, T/P, KV, hd].  Returns the normalized
    context [L, B, T/P, H, hd] in q's dtype.
    """
    L, B, Tq, H, hd = q.shape
    P = comm.P
    sched = build_causal_schedule(P) if schedule is None else schedule
    if sched.P != P or L != len(comm.local):
        raise ValueError(f"schedule P={sched.P} and comm P={P} differ, or "
                         f"the blocks' leading {L} is not the comm's "
                         f"{len(comm.local)} local device(s)")
    # the k resident (q, k, v) blocks, one [L, ...] tuple per slot
    slots = quorum_gather((q, k, v), sched, comm,
                          overlap_fn=lambda _slot, blk: blk)
    valid = comm.local_rows(torch.as_tensor(sched.valid)).to(q.device)
    acc: list = [None] * sched.k
    for s in range(sched.n_pairs):   # ~P pairs, each one batched launch
        lo, hi = (int(x) for x in sched.pair_slots[s])
        d = int(sched.pair_diff[s])
        part = _pair(slots[hi][0], slots[lo][1], slots[lo][2],
                     causal_diag=(d == 0), valid=valid[:, s])
        # merging into the identity returns the partial itself
        acc[hi] = part if acc[hi] is None else merge_partials(acc[hi], part)
    del slots
    for s, part in enumerate(acc):
        if part is None:
            acc[s] = empty_partial((L, B, Tq, hd), H, device=q.device)
    # route partials back to the q-block owners under the flash monoid
    total = quorum_scatter(acc, sched, comm, reduce_fn=merge_partials)
    return _normalize(total, q.dtype)


# ---------------------------------------------------------------------------
# Ring attention baseline (P - 1 shifts)
# ---------------------------------------------------------------------------

def ring_attention(q, k, v, comm: Comm):
    """Classic ring: rotate (k, v) P - 1 times, accumulating causal
    partials.  q: [L, B, T/P, H, hd]; k / v: [L, B, T/P, KV, hd] (the L
    devices this process holds).  At step t device i holds kv block
    (i - t) % P: the diagonal block at t = 0, a visible block at t > 0 iff
    i >= t.  Returns [L, B, T/P, H, hd] in q's dtype.
    """
    P, L = comm.P, q.shape[0]
    i = comm.axis_index()                       # [L] global device ids
    tr = obs_trace.get_tracer()
    acc = None
    kc, vc = k, v
    for t in range(P):
        src = (i - t) % P
        part = _pair(q, kc, vc, causal_diag=(t == 0), valid=src <= i)
        acc = part if acc is None else merge_partials(acc, part)
        if t + 1 < P:
            if tr:
                tr.count("comm.ppermute.ring_hops")
                tr.count("comm.ppermute.ring_bytes",
                         (obs_trace.nbytes_of(kc) + obs_trace.nbytes_of(vc))
                         // L)
            kc, vc = comm.ppermute(kc, -1), comm.ppermute(vc, -1)
    return _normalize(acc, q.dtype)


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------

def distributed_attention(q, k, v, comm: Comm, *,
                          strategy: str = "quorum"):
    """q: [B, T, H, hd]; k / v: [B, T, KV, hd]; T split over the comm's P
    devices block-major (device i holds tokens [i*T/P, (i+1)*T/P)), so
    cyclic block indices coincide with position order.  Each process moves
    only its own devices' blocks to its device.  Returns the causal
    attention output of this process's positions in q's dtype on the
    comm's device: [B, T, H, hd] under ``SingleProcessComm``, positions
    ``[r*T/P, (r+1)*T/P)`` ([B, T/P, H, hd]) on rank r under
    ``DistributedComm``.
    """
    P = comm.P
    B, T, H, hd = q.shape
    if T % P:
        raise ValueError(f"T={T} does not divide by P={P}")
    if k.shape[:2] != (B, T) or v.shape != k.shape or H % k.shape[2]:
        raise ValueError(f"k / v {tuple(k.shape)} do not fit q "
                         f"{tuple(q.shape)}")

    def blocks(t):
        t = comm.local_rows(t.reshape(B, P, T // P, *t.shape[2:])
                            .transpose(0, 1))
        return t.to(comm.device).contiguous()

    qb, kb, vb = blocks(q), blocks(k), blocks(v)
    if strategy == "quorum":
        out = quorum_attention(qb, kb, vb, comm)
    elif strategy == "ring":
        out = ring_attention(qb, kb, vb, comm)
    else:
        raise ValueError(f"unknown strategy {strategy!r}: quorum or ring")
    return out.transpose(0, 1).reshape(B, -1, H, hd)


def reference_attention(q, k, v):
    """Plain causal full attention oracle."""
    B, T, H, hd = q.shape
    KV = k.shape[2]
    qg = q.reshape(B, T, KV, H // KV, hd)
    s = torch.einsum("bqkgh,bskh->bkgqs", qg.float() / math.sqrt(hd),
                     k.float())
    msk = torch.ones(T, T, dtype=torch.bool, device=q.device).tril()
    s = torch.where(msk, s, NEG_INF)
    w = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqs,bskh->bkgqh", w, v.float())
    return o.reshape(B, H, T, hd).permute(0, 2, 1, 3).to(q.dtype)
