"""Mamba2 (SSD — state-space duality) block: chunked forward and O(1)-state
decode step (port of ``repro/models/ssm.py``).

Per head (scalar A, state size N, head dim P):
    h_t = exp(dt_t * A) * h_{t-1} + dt_t * B_t x_t^T      (h: [N, P])
    y_t = C_t^T h_t + D * x_t
The chunked algorithm (arXiv:2405.21060) computes within-chunk interactions
as masked matmuls and carries chunk-final states from chunk to chunk.  The
intra-chunk part is ``ops.ssd_intra_chunk`` (kernel B10,
``kernels/ssd_chunk.py``, on a CUDA device; its plain version on the CPU)
and the inter-chunk recurrence runs in PyTorch on either device.

With ``tp`` (a mesh's "model" group, ``launch.mesh.TensorParallel``) a
prompt's input is the rank's part of the sequence: it is gathered along
T (the scan needs all of it), and the rank computes its ``H / model``
heads: their columns of ``z``, ``x`` and ``dt`` and all of ``B`` / ``C``
from the whole fused ``in_proj``, its ``x`` channels with ``B`` and ``C``
through the convolution, the scan on its heads, the gated RMSNorm with
its sum of squares over ``d_inner`` summed over the ranks, and its rows
of ``out_proj``, whose partial products are reduce-scattered back along
T.  Where ``out_proj`` came whole (heads the extent does not divide),
every rank runs the block on all heads and keeps its own rows.

At decode under a mesh (``tp`` in its decode mode, ``state`` the rank's
shards: ``ssm`` its heads, ``conv`` its contiguous ``1 / model`` of the
conv channels where they divide) the token is whole on every rank: each
rank advances the conv tails of the channels it stores, the ranks'
one-token conv outputs are gathered over "model", and the rank runs
B10 (``ops.ssd_intra_chunk`` at chunk 1) on its heads, with the gated
norm's squares summed over "model" and its ``out_proj`` rows' products
summed over "model".
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..kernels import ops
from ..kernels.ssd_chunk import ssd_inter_chunk
from .common import ParamDef, Tree, is_split, rmsnorm

__all__ = ["MambaBlock", "ssm_defs", "ssd_chunked", "mamba_block",
           "init_ssm_state", "mamba_decode_step"]


def ssm_defs(cfg) -> Tree:
    """Mamba2 block ParamDefs (in/out proj, conv, dt/A/D)."""
    d, di = cfg.d_model, cfg.d_inner
    N, H = cfg.ssm_state, cfg.ssm_heads
    conv_ch = di + 2 * N  # conv over x, B, C streams (mamba2 layout)
    return {
        "in_proj": ParamDef((d, 2 * di + 2 * N + H), ("F", "T")),  # z,x,B,C,dt
        "conv_w": ParamDef((cfg.ssm_conv, conv_ch), (None, "T"), scale=1.0),
        "conv_b": ParamDef((conv_ch,), ("T",), "zeros"),
        "A_log": ParamDef((H,), (None,), "ones"),
        "D": ParamDef((H,), (None,), "ones"),
        "dt_bias": ParamDef((H,), (None,), "zeros"),
        "norm": ParamDef((di,), (None,), "ones"),
        "out_proj": ParamDef((di, d), ("T", "F"), scale=cfg.out_scale),
    }


def _split_proj(cfg, proj):
    di, N, H = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    return torch.split(proj, [di, di + 2 * N, H], dim=-1)   # z, xBC, dt


def _causal_conv(cfg, p, xBC, conv_state=None):
    """Depthwise causal conv width W over [B, T, C]; optional carried state
    [B, W-1, C] for decode.  Returns (out, new_state)."""
    W = cfg.ssm_conv
    if conv_state is None:
        pad = torch.zeros(xBC.shape[0], W - 1, xBC.shape[2], dtype=xBC.dtype,
                          device=xBC.device)
    else:
        pad = conv_state
    xp = torch.cat([pad, xBC], dim=1)                    # [B, T+W-1, C]
    T = xBC.shape[1]
    out = sum(xp[:, i:i + T] * p["conv_w"][i] for i in range(W))
    out = F.silu(out + p["conv_b"])
    new_state = xp[:, -(W - 1):] if W > 1 else pad
    return out, new_state


def ssd_chunked(x, dt, A, Bm, Cm, chunk: int, h0=None):
    """Chunked SSD scan.

    x: [B, T, H, P]; dt: [B, T, H] (>0); A: [H] (<0); Bm / Cm: [B, T, N];
    h0: [B, H, N, P] or None (zeros).  Returns y [B, T, H, P] and the final
    state [B, H, N, P], float32: the intra-chunk step (kernel B10 on a
    CUDA device, its plain version on the CPU), then the inter-chunk
    recurrence from h0.
    """
    T = x.shape[1]
    if T % chunk:
        raise ValueError(f"T={T} does not divide into chunks of {chunk}")
    y_intra, S, cd = ops.ssd_intra_chunk(x, dt, A, Bm, Cm, chunk=chunk)
    return ssd_inter_chunk(y_intra, S, cd, Cm, chunk=chunk, h0=h0)


def mamba_block(cfg, p: Tree, x, *, state=None, tp=None):
    """Full Mamba2 block over [B, T, d].  state=None for a prompt.

    Returns (out [B, T, d], new_state dict) — state carries (conv, ssm) for
    decode continuation.  With ``tp`` (a prompt, or a decode step with
    the rank's state shards): see the module docstring; the state is
    then the rank's heads'.
    """
    if tp is not None and state is not None:
        return _mamba_decode_heads(cfg, p, x, state, tp)
    if tp is not None:
        x = tp.gather_seq(x)
        if not is_split(p["out_proj"], cfg.d_inner, 0, tp):
            out, new = mamba_block(cfg, p, x)
            return tp.own(out), new
        return _mamba_heads(cfg, p, x, tp)
    B, T, d = x.shape
    di, N, H, Pd = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    proj = x @ p["in_proj"]                             # [B, T, 2di+2N+H]
    z, xBC, dt = _split_proj(cfg, proj)
    conv_state = None if state is None else state["conv"]
    xBC, new_conv = _causal_conv(cfg, p, xBC, conv_state)
    xs, Bm, Cm = torch.split(xBC, [di, N, N], dim=-1)
    dt = F.softplus(dt.float() + p["dt_bias"])          # [B, T, H]
    A = -torch.exp(p["A_log"].float())                  # [H] negative
    xh = xs.reshape(B, T, H, Pd).float()

    chunk = min(cfg.ssm_chunk, T)
    h0 = None if state is None else state["ssm"]
    y, hT = ssd_chunked(xh, dt, A, Bm.float(), Cm.float(), chunk, h0=h0)
    y = y + p["D"][None, None, :, None] * xh
    y = y.reshape(B, T, di).to(x.dtype)
    y = rmsnorm(y * F.silu(z), p["norm"])
    out = y @ p["out_proj"]
    return out, {"conv": new_conv, "ssm": hT}


def _mamba_heads(cfg, p: Tree, x, tp):
    """:func:`mamba_block` of a prompt on the rank's heads of the whole
    sequence ``x``: the partial output reduce-scattered along T."""
    B, T, _d = x.shape
    di, N, Pd = cfg.d_inner, cfg.ssm_state, cfg.ssm_head_dim
    H = cfg.ssm_heads // tp.size
    dl = H * Pd
    j = tp.index
    dev = x.device

    def cols(*runs):
        return torch.cat([torch.arange(a, a + n, device=dev)
                          for a, n in runs])
    w = p["in_proj"].index_select(1, cols(
        (j * dl, dl), (di + j * dl, dl), (2 * di, 2 * N),
        (2 * di + 2 * N + j * H, H)))
    z, xBC, dt = torch.split(x @ w, [dl, dl + 2 * N, H], dim=-1)
    ch = cols((j * dl, dl), (di, 2 * N))
    xBC, new_conv = _causal_conv(cfg, {"conv_w": p["conv_w"].index_select(
        1, ch), "conv_b": p["conv_b"].index_select(0, ch)}, xBC)
    xs, Bm, Cm = torch.split(xBC, [dl, N, N], dim=-1)
    heads = slice(j * H, (j + 1) * H)
    dt = F.softplus(dt.float() + p["dt_bias"][heads])
    A = -torch.exp(p["A_log"][heads].float())
    xh = xs.reshape(B, T, H, Pd).float()
    y, hT = ssd_chunked(xh, dt, A, Bm.float(), Cm.float(),
                        min(cfg.ssm_chunk, T))
    y = y + p["D"][heads][None, None, :, None] * xh
    return _gated_out(cfg, p, y.reshape(B, T, dl).to(x.dtype), z, tp), \
        {"conv": new_conv, "ssm": hT}


def _gated_out(cfg, p: Tree, y, z, tp):
    """The rank's heads' ``y`` gated by ``z``, RMS-normed over all d_inner
    channels (the squares summed over the ranks) and through its rows of
    ``out_proj``: the partial output summed over "model" (reduce-scattered
    along T for a prompt)."""
    dl = y.shape[-1]
    y = y * F.silu(z)
    y32 = y.float()
    ss = tp.copy(tp.reduce(torch.sum(y32 * y32, dim=-1, keepdim=True)))
    y = (y32 * torch.rsqrt(ss / cfg.d_inner + 1e-6)).to(y.dtype) \
        * p["norm"][tp.index * dl:(tp.index + 1) * dl]
    return tp.scatter_seq(y @ p["out_proj"])


def _mamba_decode_heads(cfg, p: Tree, x, state: Tree, tp):
    """One decode token [B, 1, d] (whole on every rank along "model") with
    the rank's state shards -> (out [B, 1, d], every rank's sum; the new
    state shards).  The conv runs on the channels whose tails the rank
    stores (all of them where ``conv`` is whole), and the one-token
    outputs are gathered; the scan runs on the rank's heads where
    ``out_proj`` is split, else on all of them."""
    B = x.shape[0]
    di, N, H, Pd = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, \
        cfg.ssm_head_dim
    j = tp.index
    z, xBC, dt = _split_proj(cfg, x @ p["in_proj"])
    cl = state["conv"].shape[-1]
    if cl != xBC.shape[-1]:
        ch = slice(j * cl, (j + 1) * cl)
        out, new_conv = _causal_conv(
            cfg, {"conv_w": p["conv_w"][:, ch], "conv_b": p["conv_b"][ch]},
            xBC[..., ch], state["conv"])
        xBC = torch.cat(list(tp.gather(out).unbind(0)), dim=-1)
    else:
        xBC, new_conv = _causal_conv(cfg, p, xBC, state["conv"])
    xs, Bm, Cm = torch.split(xBC, [di, N, N], dim=-1)
    split = is_split(p["out_proj"], di, 0, tp)
    Hl = H // tp.size if split else H
    heads = slice(j * Hl, (j + 1) * Hl) if split else slice(0, H)
    dl = Hl * Pd
    xs, z = xs[..., heads.start * Pd:heads.stop * Pd], \
        z[..., heads.start * Pd:heads.stop * Pd]
    dt = F.softplus(dt[..., heads].float() + p["dt_bias"][heads])
    A = -torch.exp(p["A_log"][heads].float())
    xh = xs.reshape(B, 1, Hl, Pd).float()
    y, hT = ssd_chunked(xh, dt, A, Bm.float(), Cm.float(), 1,
                        h0=state["ssm"])
    y = y + p["D"][heads][None, None, :, None] * xh
    y = y.reshape(B, 1, dl).to(x.dtype)
    if split:
        out = _gated_out(cfg, p, y, z, tp)
    else:
        out = rmsnorm(y * F.silu(z), p["norm"]) @ p["out_proj"]
    return out, {"conv": new_conv, "ssm": hT}


def init_ssm_state(cfg, batch: int, device=None) -> Tree:
    """Zeroed decode-time SSM carry (conv tail + state)."""
    di, N = cfg.d_inner, cfg.ssm_state
    H, Pd = cfg.ssm_heads, cfg.ssm_head_dim
    return {
        "conv": torch.zeros(batch, cfg.ssm_conv - 1, di + 2 * N,
                            dtype=cfg.dtype, device=device),
        "ssm": torch.zeros(batch, H, N, Pd, dtype=torch.float32,
                           device=device),
    }


def mamba_decode_step(cfg, p: Tree, x, state: Tree):
    """One-token decode [B, 1, d] with carried (conv, ssm) state ->
    (out [B, 1, d], new state)."""
    return mamba_block(cfg, p, x, state=state)


class MambaBlock(nn.Module):
    """One Mamba2 layer as a module: the parameters of :func:`ssm_defs`
    (frozen) and :func:`mamba_block` as its forward."""

    def __init__(self, cfg, params: Tree):
        super().__init__()
        self.cfg = cfg
        self.params = nn.ParameterDict(
            {k: nn.Parameter(v, requires_grad=False)
             for k, v in params.items()})

    def forward(self, x, state=None):
        """x [B, T, d] -> (out [B, T, d], new (conv, ssm) state)."""
        return mamba_block(self.cfg, dict(self.params), x, state=state)
