"""B10: the Mamba2 SSD intra-chunk step, hand-written CUDA, and the
inter-chunk recurrence around it.

Replaces the Pallas kernel ``repro/kernels/ssd_chunk.py:ssd_chunk_pallas``
(body ``_ssd_kernel``), the intra-chunk part of every Mamba2 layer
(``models/ssm.py:ssd_chunked``) and of ``ops.ssd_chunk``.  Source:
``repro_torch/csrc/ssd_chunk.cu``.

What bounds it on the H100: fp32 arithmetic outside the tensor cores
(67 TFLOP/s).  B and C are one group shared by every head, so the
function needs C B^T below the diagonal once per (batch row, chunk), then
per head its decay-weighted product with x and the chunk state S.  The
TPU kernel takes one (bh, chunk) cell per grid step with its B and C
repeated per head; here one block owns a (batch row, chunk) cell and
walks its heads 8 at a time (a block per 8 heads where the cells are too
few to fill the card).  It forms the lower strip of C B^T once per 64-row
tile for every head, factors the decay out of the product below the
diagonal tile (``exp(cums_i - cums_j) = u_i v_j`` about one reference
row, both factors <= 1 where every dt * A <= 0), takes the explicit
masked exponent on the diagonal tile and for any head with some dt * A >
0, and forms S as one product over the chunk; every product runs on an
8 x 16 register tile a thread (the file's header has the design).

Its gradient, "B10 bwd" (:func:`ssd_chunk_bwd_cuda`, source
``repro_torch/csrc/ssd_chunk_bwd.cu``), has no Pallas counterpart: the
JAX package's train step differentiates its plain scan with XLA.  It is
bound the same way (4 P operations per visible pair and head, 4 N P per
position and head, 6 N per visible pair once per (batch row, chunk)), and
every product runs on the forward's 8 x 16 register tile with 16-byte
operand loads through a two-stage cp.async ring.  Four launches (the file's
header has the design): C B^T once per (batch row, chunk); dx (u = B dS at
N's own width, then W^T dy) and G (G = dy x^T, its row and column sums in
doubles, dCB summed over the heads) with a block per 8 heads; dB and dC,
whose S term is one product over the heads and P, split by heads over
blocks where the cells are too few (:func:`bwd_s_splits`, then a fifth
launch sums the partials in order).  No atomics: two launches give the
same bits.  Its plain version is :func:`ssd_intra_chunk_bwd_plain`.

The O(nc) inter-chunk recurrence is framework code, as in the
reference's ``ops.ssd_chunk``: :func:`ssd_inter_chunk` walks the chunk
states with one fused multiply-add per chunk and forms every chunk's
inter-chunk output in one batched matmul.

The plain version beside the kernel is :func:`ssd_intra_chunk_plain`;
the device dispatch is :func:`repro_torch.kernels.ops.ssd_intra_chunk`.
"""

from __future__ import annotations

import torch

from . import _build
from .flash_attention import SMS
from .ref import ssd_intra_chunk as ssd_intra_chunk_plain
from .ref import ssd_intra_chunk_bwd as ssd_intra_chunk_bwd_plain

__all__ = ["ssd_chunk_cuda", "ssd_chunk_bwd_cuda", "ssd_intra_chunk_plain",
           "ssd_intra_chunk_bwd_plain", "ssd_inter_chunk", "launches",
           "bwd_launches"]

#: kernel launches since the count was last set to 0
launches = 0
#: backward kernel launches (a call of ``ssd_chunk_bwd_cuda``) since then
bwd_launches = 0

#: heads of a group of the backward kernel (a warp each in its G pass)
BWD_HEADS = 8
#: blocks (batch row, chunk, N tiles) per SM of the last kernel below which
#: blocks split dB's S term by heads
BWD_S_SPLIT_BELOW = 0.5


def bwd_s_splits(cells: int, N: int, H: int, sms: int) -> int:
    """Blocks that split dB's S term by heads for each (batch row, chunk, N
    tiles) of the dB / dC kernel: 1 where those fill half the card, else
    enough for about two blocks per SM, each a whole number of heads."""
    tile = 16 if N <= 16 else 32 if N <= 32 else 64 if N <= 64 else 128
    blocks = cells * -(-N // tile)
    if blocks >= BWD_S_SPLIT_BELOW * sms:
        return 1
    per = -(-H // -(-2 * sms // blocks))
    return -(-H // per)


MAX_CHUNK, MAX_HEAD_DIM, MAX_STATE = 256, 128, 256


def operations(Bsz: int, T: int, H: int, Pd: int, N: int, L: int,
               backward: bool = False) -> float:
    """The algorithm's operations (the bound of PERF.md's table), over the
    visible pairs (j <= i) of each chunk of L: forward 2 N per pair once
    per (batch row, chunk) for C B^T, and per head 2 Pd per pair and 2 N
    Pd per position; backward 6 N per pair once per (batch row, chunk),
    and per head 4 Pd per pair and 4 N Pd per position."""
    nc, tri = T // L, L * (L + 1) // 2
    if backward:
        return Bsz * nc * (H * (4.0 * Pd * tri + 4.0 * N * Pd * L)
                           + 6.0 * N * tri)
    return Bsz * nc * (2.0 * N * tri
                       + H * (2.0 * Pd * tri + 2.0 * L * N * Pd))


def _check_args(x, dt, A, Bm, Cm, chunk: int) -> None:
    """Raise unless x [B, T, H, P], dt [B, T, H], A [H] and Bm / Cm
    [B, T, N] fit together and T divides into chunks of ``chunk``."""
    if x.dim() != 4 or dt.dim() != 3 or A.dim() != 1 or Bm.dim() != 3 \
            or Cm.shape != Bm.shape:
        raise ValueError(
            f"need x [B, T, H, P], dt [B, T, H], A [H], B / C [B, T, N]; "
            f"got {tuple(x.shape)}, {tuple(dt.shape)}, {tuple(A.shape)}, "
            f"{tuple(Bm.shape)}, {tuple(Cm.shape)}")
    Bsz, T, H, _ = x.shape
    if tuple(dt.shape) != (Bsz, T, H) or A.shape[0] != H \
            or tuple(Bm.shape[:2]) != (Bsz, T):
        raise ValueError("x, dt, A, B and C disagree on batch, length or "
                         "heads")
    if chunk < 1 or T % chunk:
        raise ValueError(f"T={T} does not divide into chunks of {chunk}")


def _check_f32(name: str, tensors: dict, meta: bool) -> None:
    if not meta:
        _build.require_cuda(name, *tensors.values())
    for what, t in tensors.items():
        if t.dtype != torch.float32:
            raise ValueError(f"{name} takes float32, got {what} {t.dtype}")


def ssd_chunk_cuda(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                   Bm: torch.Tensor, Cm: torch.Tensor, *, chunk: int):
    """x [B, T, H, P], dt [B, T, H], A [H], Bm / Cm [B, T, N], float32 on
    one CUDA device (x, Bm, Cm may be strided views with a contiguous last
    axis).  Returns ``(y_intra [B, T, H, P], S [B, nc, H, N, P], cd [B, T,
    H])`` float32, as ``ref.ssd_intra_chunk``."""
    global launches
    _check_args(x, dt, A, Bm, Cm, chunk)
    meta = _build.on_meta(x, dt, A, Bm, Cm)
    _check_f32("ssd_chunk", dict(x=x, dt=dt, A=A, B=Bm, C=Cm), meta)
    Bsz, T, H, P = x.shape
    N = Bm.shape[-1]
    if chunk > MAX_CHUNK or P > MAX_HEAD_DIM or N > MAX_STATE:
        raise ValueError(f"ssd_chunk supports chunk <= {MAX_CHUNK}, "
                         f"P <= {MAX_HEAD_DIM}, N <= {MAX_STATE}; got "
                         f"{chunk}, {P}, {N}")
    x, Bm, Cm = (t if t.stride(-1) == 1 else t.contiguous()
                 for t in (x, Bm, Cm))
    dt, A = dt.contiguous(), A.contiguous()
    nc = T // chunk
    dev = x.device
    y = torch.empty(Bsz, T, H, P, dtype=torch.float32, device=dev)
    S = torch.empty(Bsz, nc, H, N, P, dtype=torch.float32, device=dev)
    cd = torch.empty(Bsz, T, H, dtype=torch.float32, device=dev)
    if y.numel() == 0:
        return y, S, cd
    if meta:
        _build.meta_call("ssd_chunk", operations(Bsz, T, H, P, N, chunk),
                         (x, dt, A, Bm, Cm), (y, S, cd))
        return y, S, cd
    with torch.cuda.device(dev):
        rc = _build.library().repro_ssd_chunk(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
            Cm.data_ptr(), y.data_ptr(), S.data_ptr(), cd.data_ptr(), Bsz,
            T, H, P, N, chunk, *x.stride()[:3], *Bm.stride()[:2],
            *Cm.stride()[:2], _build.stream_of(x))
    _build.check(rc, "ssd_chunk")
    launches += 1
    return y, S, cd


def ssd_chunk_bwd_cuda(x, dt, A, Bm, Cm, dy, dS, dcd, *, chunk: int):
    """B10's backward: the forward's inputs (as :func:`ssd_chunk_cuda`
    takes them) and the gradients dy [B, T, H, P], dS [B, nc, H, N, P],
    dcd [B, T, H] of its outputs (each may be None: zero), float32 on one
    CUDA device.  Returns ``(dx, ddt, dA, dB, dC)`` float32, as
    ``ref.ssd_intra_chunk_bwd``; dA is the sum of the kernel's [B, nc, H]
    partials."""
    global bwd_launches
    _check_args(x, dt, A, Bm, Cm, chunk)
    Bsz, T, H, P = x.shape
    N = Bm.shape[-1]
    nc = T // chunk
    grads = {}
    for name, t, shape in (("dy", dy, (Bsz, T, H, P)),
                           ("dS", dS, (Bsz, nc, H, N, P)),
                           ("dcd", dcd, (Bsz, T, H))):
        if t is None:
            continue
        if tuple(t.shape) != shape:
            raise ValueError(f"ssd_chunk_bwd: {name} has shape "
                             f"{tuple(t.shape)}, expected {shape}")
        grads[name] = t
    meta = _build.on_meta(x, dt, A, Bm, Cm, *grads.values())
    _check_f32("ssd_chunk_bwd", dict(x=x, dt=dt, A=A, B=Bm, C=Cm, **grads),
               meta)
    if chunk > MAX_CHUNK or P > MAX_HEAD_DIM or N > MAX_STATE:
        raise ValueError(f"ssd_chunk_bwd supports chunk <= {MAX_CHUNK}, "
                         f"P <= {MAX_HEAD_DIM}, N <= {MAX_STATE}; got "
                         f"{chunk}, {P}, {N}")
    x, Bm, Cm = (t if t.stride(-1) == 1 else t.contiguous()
                 for t in (x, Bm, Cm))
    dt, A = dt.contiguous(), A.contiguous()
    dev = x.device
    dy = torch.zeros_like(x, memory_format=torch.contiguous_format) \
        if dy is None else dy.contiguous()
    dS = None if dS is None else dS.contiguous()
    dcd = None if dcd is None else dcd.contiguous()
    f32 = dict(dtype=torch.float32, device=dev)
    dx = torch.empty(Bsz, T, H, P, **f32)
    ddt = torch.empty(Bsz, T, H, **f32)
    dB = torch.empty(Bsz, T, N, **f32)
    dC = torch.empty(Bsz, T, N, **f32)
    if dx.numel() == 0:
        return (dx.zero_(), ddt.zero_(), torch.zeros(H, **f32), dB.zero_(),
                dC.zero_())
    sms = SMS if meta else \
        torch.cuda.get_device_properties(dev).multi_processor_count
    kbs, db_part, cb_part, dcb_part, dA_part, dend = _bwd_scratch(
        Bsz, T, H, N, chunk, dS is not None, sms, dev)
    if meta:
        _build.meta_call("ssd_chunk_bwd",
                         operations(Bsz, T, H, P, N, chunk, True),
                         (x, dt, A, Bm, Cm, dy, *(t for t in (dS, dcd)
                                                  if t is not None)),
                         (dx, ddt, dA_part, dB, dC))
        return dx, ddt, dA_part.sum((0, 1)), dB, dC
    with torch.cuda.device(dev):
        ptr = (lambda t: None if t is None else t.data_ptr())
        rc = _build.library().repro_ssd_chunk_bwd(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
            Cm.data_ptr(), dy.data_ptr(), ptr(dS), ptr(dcd), dx.data_ptr(),
            ddt.data_ptr(), dA_part.data_ptr(), dB.data_ptr(), dC.data_ptr(),
            dcb_part.data_ptr(), cb_part.data_ptr(), ptr(db_part),
            dend.data_ptr(), Bsz, T, H, P, N, chunk, kbs,
            *x.stride()[:3], *Bm.stride()[:2], *Cm.stride()[:2],
            _build.stream_of(x))
    _build.check(rc, "ssd_chunk_bwd")
    bwd_launches += 1
    return dx, ddt, dA_part.sum((0, 1)), dB, dC


def _bwd_scratch(Bsz: int, T: int, H: int, N: int, chunk: int,
                 has_dS: bool, sms: int, dev):
    """(kbs, dB's S-term partials or None, C B^T, dCB partials, dA
    partials, dend) of a backward call for ``sms`` SMs, as either route
    allocates them."""
    f32 = dict(dtype=torch.float32, device=dev)
    nc, groups = T // chunk, -(-H // BWD_HEADS)
    kbs = bwd_s_splits(Bsz * nc, N, H, sms) if has_dS else 1
    db_part = torch.empty(kbs, Bsz, T, N, **f32) if kbs > 1 else None
    # C B^T of each (batch row, chunk), and a dCB partial per group of
    # heads, [chunk, chunk] with rows padded to 16 bytes
    ldc = -(-chunk // 4) * 4
    cb_part = torch.empty(Bsz, nc, chunk, ldc, **f32)
    dcb_part = torch.empty(Bsz, nc, groups, chunk, ldc, **f32)
    dA_part = torch.empty(Bsz, nc, H, **f32)
    dend = torch.empty(Bsz, T, H, **f32)
    return kbs, db_part, cb_part, dcb_part, dA_part, dend


def ssd_inter_chunk(y_intra: torch.Tensor, S: torch.Tensor, cd: torch.Tensor,
                    Cm: torch.Tensor, *, chunk: int, h0=None):
    """The inter-chunk recurrence of the chunked SSD scan.

    y_intra [B, T, H, P], S [B, nc, H, N, P] and cd [B, T, H] (the
    intra-chunk step's outputs), Cm [B, T, N], h0 [B, H, N, P] or None.
    With h_0 = h0 (zeros) and h_{c+1} = cd_{c, L-1} h_c + S_c, chunk c
    adds C_t cd_t h_c at each of its positions t.  Returns ``(y [B, T, H,
    P], h_nc [B, H, N, P])`` float32; y is ``y_intra`` updated in place,
    except where an input needs a gradient: then the same arithmetic runs
    out of place, for autograd.
    """
    Bsz, T, H, P = y_intra.shape
    nc = T // chunk
    N = Cm.shape[-1]
    cd_c = cd.reshape(Bsz, nc, chunk, H)
    cd_last = cd_c[:, :, -1, :, None, None]                 # [B, nc, H, 1, 1]
    grad = torch.is_grad_enabled() and any(
        torch.is_tensor(t) and t.requires_grad
        for t in (y_intra, S, cd, Cm, h0))
    if grad:
        h = (torch.zeros(Bsz, H, N, P, dtype=torch.float32,
                         device=y_intra.device) if h0 is None else h0.float())
        states = [h]
        for c in range(nc):
            h = torch.addcmul(S[:, c], cd_last[:, c], h)
            states.append(h)
        hs = torch.stack(states)
    else:
        hs = torch.empty(nc + 1, Bsz, H, N, P, dtype=torch.float32,
                         device=y_intra.device)
        if h0 is None:
            hs[0].zero_()
        else:
            hs[0].copy_(h0)
        for c in range(nc):
            torch.addcmul(S[:, c], cd_last[:, c], hs[c], out=hs[c + 1])
    h_prev = hs[:-1].permute(1, 0, 3, 2, 4).reshape(Bsz * nc, N, H * P)
    y_inter = torch.bmm(Cm.float().reshape(Bsz * nc, chunk, N), h_prev)
    y_inter = y_inter.view(Bsz, nc, chunk, H, P)
    if grad:
        y_inter = y_inter * cd_c[..., None]
        return y_intra + y_inter.view(Bsz, T, H, P), hs[-1]
    y_inter.mul_(cd_c[..., None])
    y = y_intra.add_(y_inter.view(Bsz, T, H, P))
    return y, hs[-1].clone()
