"""GQA attention: self attention, cross-attention and cached decode (port
of ``repro/models/attention.py``).

Self attention without a window — causal for a decoder, full for an
encoder — goes through ``ops.flash_attention`` at every length: on a CUDA
tensor that is kernel B9 (``kernels/flash_attention.py``, the counterpart
of the Pallas kernel ``repro/kernels/flash_attention.py`` that the
reference's header maps this block-pair computation to), on a CPU tensor
its plain version.  The reference picks masked :func:`sdpa` below
``attn_block_threshold`` and :func:`blocked_sdpa` at and above it; both
compute the function B9 computes, and B9 masks its own ragged edges, so
this branch has no threshold.

Sliding-window attention keeps the reference's choice (:func:`banded_sdpa`
at T >= 2W with T % W == 0, :func:`blocked_sdpa` at and above the
threshold, masked :func:`sdpa` otherwise), and decode and cross-attention
are plain products: the reference computes them outside any kernel.

With ``tp`` (a mesh's "model" group, ``launch.mesh.TensorParallel``) the
input is the rank's part of the sequence: it is gathered along T, the
rank projects its own heads (``wq`` / ``wk`` / ``wv`` split over
"model"), applies the positions of the whole sequence, attends on
``H / model | KV / model`` heads, and its row-parallel ``wo`` products are
reduce-scattered back along T.  Where the K / V heads are whole (fewer
than the "model" extent) the rank takes those its query heads read;
where the query heads are whole, every rank attends on all of them and
keeps its own rows.

At decode under a mesh (:func:`decode_attention` with ``tp`` in its
decode mode and ``seq``) the token is whole on every rank and the cache
is the rank's shard of ``launch/steps.py``'s ``_cache_spec`` layout:
(a) K / V heads over "model": the rank's query heads read its own K / V
heads, and its row-parallel ``wo`` products are summed over "model";
(b) slots over the dp axes (a batch they do not divide): each rank
attends over its ``S / dp`` consecutive slots, and the float32 partials
are merged with one maximum and one sum over ``seq``; (c) head_dim over
"model" (K / V heads the extent does not divide): the queries are
gathered, each rank's partial scores on its head_dim slice are summed
over "model", and the context on its slice is gathered back.  The cache
never moves.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from ..kernels import ops
from .common import ParamDef, Tree, apply_mrope, apply_rope, is_split, rmsnorm

NEG_INF = -1e30


def attn_defs(cfg) -> Tree:
    """Attention block ParamDefs (GQA q/k/v/o + norms)."""
    d, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    defs = {
        "wq": ParamDef((d, H, hd), ("F", "T", None), fan_in=d),
        "wk": ParamDef((d, KV, hd), ("F", "T", None), fan_in=d),
        "wv": ParamDef((d, KV, hd), ("F", "T", None), fan_in=d),
        "wo": ParamDef((H, hd, d), ("T", None, "F"), scale=cfg.out_scale,
                       fan_in=H * hd),
    }
    if cfg.qk_norm:
        defs["q_norm"] = ParamDef((hd,), (None,), "ones")
        defs["k_norm"] = ParamDef((hd,), (None,), "ones")
    return defs


def causal_window_bias(Tq: int, Tk: int, *, causal: bool,
                       window: Optional[int], q_offset=0,
                       device=None) -> torch.Tensor:
    """[Tq, Tk] additive float32 mask.  q_offset = abs position of query 0
    minus abs position of key 0 (decode / blockwise)."""
    q = torch.arange(Tq, device=device)[:, None] + q_offset
    k = torch.arange(Tk, device=device)[None, :]
    ok = torch.ones(Tq, Tk, dtype=torch.bool, device=device)
    if causal:
        ok &= k <= q
    if window is not None:
        ok &= k > q - window
    return torch.where(ok, 0.0, NEG_INF).to(torch.float32)


def _project(x, w):
    """x [B, T, d] @ w [d, heads, hd] -> [B, T, heads, hd]."""
    return (x @ w.flatten(1)).unflatten(-1, w.shape[1:])


def _out(ctx, wo):
    """ctx [B, T, H, hd] @ wo [H, hd, d] -> [B, T, d]."""
    return ctx.flatten(2) @ wo.flatten(0, 1)


def qkv_project(cfg, p: Tree, x, positions):
    """x: [B, T, d] -> q [B, T, H, hd], k/v [B, T, KV, hd] with positions
    encoded.  positions: [B, T] integers, or [B, T, 3] for M-RoPE."""
    q, k, v = (_project(x, p[w]) for w in ("wq", "wk", "wv"))
    if cfg.qk_norm:
        q = rmsnorm(q, p["q_norm"])
        k = rmsnorm(k, p["k_norm"])
    if cfg.pos == "rope":
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    elif cfg.pos == "mrope":
        pos3 = positions if positions.dim() == 3 else \
            positions[..., None].expand(*positions.shape, 3)
        q = apply_mrope(q, pos3, cfg.rope_theta, cfg.mrope_sections)
        k = apply_mrope(k, pos3, cfg.rope_theta, cfg.mrope_sections)
    return q, k, v


def sdpa(q, k, v, bias: Optional[torch.Tensor] = None):
    """Grouped scaled-dot-product attention in float32.

    q: [B, Tq, H, hd]; k/v: [B, Tk, KV, hd]; H % KV == 0.  bias: additive
    float32, broadcastable to [Tq, Tk] over the trailing dims.  Returns
    [B, Tq, H, hd] in q's dtype.
    """
    B, Tq, H, hd = q.shape
    KV = k.shape[2]
    qg = q.reshape(B, Tq, KV, H // KV, hd)
    logits = torch.einsum("bqkgh,bskh->bkgqs", qg.float() / math.sqrt(hd),
                          k.float())                  # [B, KV, G, Tq, Tk]
    if bias is not None:
        logits = logits + bias
    w = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgqs,bskh->bqkgh", w, v.float())
    return out.reshape(B, Tq, H, hd).to(q.dtype)


def blocked_sdpa(q, k, v, *, causal: bool, window: Optional[int],
                 block_k: int):
    """Flash-style online-softmax attention over kv blocks of ``block_k``
    (the last block may be ragged); never materializes [Tq, Tk]."""
    B, Tq, H, hd = q.shape
    Tk, KV = k.shape[1], k.shape[2]
    G = H // KV
    dev = q.device
    qg = q.reshape(B, Tq, KV, G, hd).float() / math.sqrt(hd)
    q_pos = torch.arange(Tq, device=dev)[:, None]
    acc = torch.zeros(B, KV, G, Tq, hd, dtype=torch.float32, device=dev)
    m = torch.full((B, KV, G, Tq), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros(B, KV, G, Tq, dtype=torch.float32, device=dev)
    for k0 in range(0, Tk, block_k):
        kc, vc = k[:, k0:k0 + block_k].float(), v[:, k0:k0 + block_k].float()
        s = torch.einsum("bqkgh,bskh->bkgqs", qg, kc)
        k_pos = k0 + torch.arange(kc.shape[1], device=dev)[None, :]
        ok = torch.ones(Tq, kc.shape[1], dtype=torch.bool, device=dev)
        if causal:
            ok &= k_pos <= q_pos
        if window is not None:
            ok &= k_pos > q_pos - window
        s = torch.where(ok, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        c = torch.exp(m - m_new)
        p_ = torch.exp(s - m_new[..., None])
        l = l * c + p_.sum(dim=-1)
        acc = acc * c[..., None] + torch.einsum("bkgqs,bskh->bkgqh", p_, vc)
        m = m_new
    out = acc / l.clamp_min(1e-30)[..., None]
    return out.reshape(B, H, Tq, hd).transpose(1, 2).to(q.dtype)


def banded_sdpa(q, k, v, *, window: int):
    """Sliding-window attention in O(T * 2W): q blocks of W attend to the
    (previous, own) kv blocks only."""
    B, T, H, hd = q.shape
    KV = k.shape[2]
    G = H // KV
    W = window
    if T % W:
        raise ValueError(f"T={T} is not a multiple of the window {W}")
    nb = T // W
    dev = q.device
    qg = q.reshape(B, nb, W, KV, G, hd).float() / math.sqrt(hd)
    kb = k.reshape(B, nb, W, KV, hd)
    vb = v.reshape(B, nb, W, KV, hd)
    # previous block (zeros before block 0)
    k2 = torch.cat([torch.cat([torch.zeros_like(kb[:, :1]), kb[:, :-1]], 1),
                    kb], dim=2)                          # [B, nb, 2W, KV, hd]
    v2 = torch.cat([torch.cat([torch.zeros_like(vb[:, :1]), vb[:, :-1]], 1),
                    vb], dim=2)
    s = torch.einsum("bnqkgh,bnskh->bnkgqs", qg, k2.float())
    q_pos = torch.arange(W, device=dev)[:, None] + W      # within [0, 2W)
    k_pos = torch.arange(2 * W, device=dev)[None, :]
    ok = (k_pos <= q_pos) & (k_pos > q_pos - W)
    first = torch.arange(nb, device=dev)[:, None, None] == 0
    ok = ok[None] & (~first | (k_pos >= W))               # [nb, W, 2W]
    s = torch.where(ok[None, :, None, None], s, NEG_INF)
    w = torch.softmax(s, dim=-1)
    o = torch.einsum("bnkgqs,bnskh->bnkgqh", w, v2.float())
    o = o.reshape(B, nb, H, W, hd).transpose(2, 3)
    return o.reshape(B, T, H, hd).to(q.dtype)


def attention(cfg, p: Tree, x, positions, *, causal=True,
              window: Optional[int] = None, tp=None):
    """Self attention over [B, T, d].

    Without a window: ``ops.flash_attention`` (kernel B9 on a CUDA tensor,
    its plain version on a CPU tensor) at every T.  With one: banded at
    T >= 2W with T % W == 0, blocked (online softmax) at T >=
    ``cfg.attn_block_threshold``, masked sdpa otherwise.  With ``tp``: see
    the module docstring.
    """
    if tp is None:
        q, k, v = qkv_project(cfg, p, x, positions)
        return _out(_attend(cfg, q, k, v, causal, window), p["wo"])
    x = tp.gather_seq(x)
    p, split = _rank_heads(cfg, p, tp)
    q, k, v = qkv_project(cfg, p, x, positions)
    out = _out(_attend(cfg, q, k, v, causal, window), p["wo"])
    return tp.scatter_seq(out) if split else tp.own(out)


def _attend(cfg, q, k, v, causal, window):
    T = q.shape[1]
    if window is None:
        return ops.flash_attention(q, k, v, causal=causal)
    if causal and T >= 2 * window and T % window == 0:
        return banded_sdpa(q, k, v, window=window)
    if T >= cfg.attn_block_threshold:
        return blocked_sdpa(q, k, v, causal=causal, window=window,
                            block_k=cfg.attn_block_k)
    bias = causal_window_bias(T, T, causal=causal, window=window,
                              device=q.device)
    return sdpa(q, k, v, bias)


def _rank_heads(cfg, p: Tree, tp):
    """(the parameters of the rank's heads, whether the heads are split):
    a split ``wq`` is the rank's query heads, and ``wk`` / ``wv`` are cut
    to the K / V heads they read where they came whole."""
    H, KV = cfg.n_heads, cfg.n_kv_heads
    if not is_split(p["wq"], H, 1, tp):
        return p, False
    if not is_split(p["wk"], KV, 1, tp):
        idx = torch.as_tensor(kv_heads(H, KV, tp.size, tp.index),
                              device=p["wk"].device)
        p = dict(p, wk=p["wk"].index_select(1, idx),
                 wv=p["wv"].index_select(1, idx))
    return p, True


def kv_heads(H: int, KV: int, size: int, index: int):
    """The K / V heads rank ``index`` of ``size`` needs for its query heads
    ``[index * H / size, (index + 1) * H / size)`` of H in groups of
    ``H / KV``: each one once where the rank's heads fall into whole
    groups of equal size, else one a query head."""
    n, G = H // size, H // KV
    want = [(index * n + i) // G for i in range(n)]
    uniq = sorted(set(want))
    if n % len(uniq) == 0 and want == [u for u in uniq
                                       for _ in range(n // len(uniq))]:
        return uniq
    return want


def cross_attention(cfg, p: Tree, x,
                    memory_kv: Tuple[torch.Tensor, torch.Tensor], tp=None,
                    seq=None):
    """Decoder cross-attention; memory_kv = (k, v) [B, S, KV, hd]
    precomputed by :func:`cross_kv` (with ``tp``: of the rank's heads, from
    the whole memory, and ``x`` the rank's part of the sequence).  At
    decode under a mesh (``tp`` in its decode mode, or ``seq``) the K / V
    are the rank's shards of the cache layout, as in
    :func:`decode_attention`."""
    if seq is not None or (tp is not None and not tp.seq):
        q = _project(x, p["wq"])
        if cfg.qk_norm:
            q = rmsnorm(q, p["q_norm"])
        k, v = memory_kv
        ok = torch.ones(k.shape[1], dtype=torch.bool, device=k.device)
        return _cached_out(cfg, p, q, k, v, ok, tp, seq)
    if tp is not None:
        x = tp.gather_seq(x)
        p, split = _rank_heads(cfg, p, tp)
    q = _project(x, p["wq"])
    if cfg.qk_norm:
        q = rmsnorm(q, p["q_norm"])
    out = _out(sdpa(q, *memory_kv), p["wo"])
    if tp is None:
        return out
    return tp.scatter_seq(out) if split else tp.own(out)


def cross_kv(cfg, p: Tree, memory, tp=None):
    """Cross-attention K/V from the encoder output [B, S, d] (with
    ``tp``: the whole memory, and the K / V heads of the rank's query
    heads)."""
    if tp is not None:
        p, _split = _rank_heads(cfg, p, tp)
    k, v = _project(memory, p["wk"]), _project(memory, p["wv"])
    if cfg.qk_norm:
        k = rmsnorm(k, p["k_norm"])
    return k, v


# ---------------------------------------------------------------------------
# Cached decode
# ---------------------------------------------------------------------------

def decode_attention(cfg, p: Tree, x, cache_k, cache_v, pos: int, *,
                     window: Optional[int] = None, tp=None, seq=None):
    """One-token decode: x [B, 1, d]; cache_k/v [B, S, KV, hd]; pos an int.

    Ring-buffer cache: the new K/V lands at slot ``pos % S``; slot s holds
    absolute position ``pos - ((pos - s) mod S)``, which serves both the
    plain (S >= max_len) and the sliding-window (S >= window) layouts.
    RoPE is applied at the absolute position before caching.  The caches
    are updated in place and returned.

    Under a mesh (module docstring) ``tp`` is the "model" group in its
    decode mode and ``seq`` the dp group over which the slots are split
    (None where the batch is): the caches are the rank's shards, x is
    whole, and the output is every rank's sum.
    """
    B, dev = x.shape[0], x.device
    n_seq, i_seq = (1, 0) if seq is None else (seq.size, seq.index)
    S_loc = cache_k.shape[1]
    S = S_loc * n_seq
    positions = torch.full((B, 1), pos, dtype=torch.int32, device=dev)
    q, k_new, v_new = qkv_project(cfg, p, x, positions)
    hl = cache_k.shape[3]
    if hl != cfg.head_dim:           # (c): the rank's head_dim slice
        k_new = k_new[..., tp.index * hl:(tp.index + 1) * hl]
        v_new = v_new[..., tp.index * hl:(tp.index + 1) * hl]
    slot = pos % S
    if slot // S_loc == i_seq:       # this rank holds the slot
        cache_k[:, slot - i_seq * S_loc] = k_new[:, 0].to(cache_k.dtype)
        cache_v[:, slot - i_seq * S_loc] = v_new[:, 0].to(cache_v.dtype)
    s_glob = i_seq * S_loc + torch.arange(S_loc, device=dev)
    abs_pos = pos - torch.remainder(pos - s_glob, S)
    ok = abs_pos >= 0
    if window is not None:
        ok &= abs_pos > pos - window
    if tp is not None or seq is not None:
        return _cached_out(cfg, p, q, cache_k, cache_v, ok, tp, seq), \
            cache_k, cache_v
    bias = torch.where(ok, 0.0, NEG_INF).to(torch.float32)[None, :]
    ctx = sdpa(q, cache_k, cache_v, bias)
    return _out(ctx, p["wo"]), cache_k, cache_v


def _cached_out(cfg, p: Tree, q, k, v, ok, tp, seq):
    """The attention block's output [B, 1, d] (every rank's sum) of the
    queries ``q`` [B, 1, Hq, hd] (the rank's heads where ``wq`` is split,
    else all) over the rank's cache shards ``k`` / ``v`` [B, S_loc, KV_l,
    hd_l], ``ok`` [S_loc] the slots to attend to: layouts (a)-(c) of the
    module docstring."""
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    split = q.shape[2] != H
    if k.shape[3] != hd:                            # (c)
        hl = k.shape[3]
        if split:
            q = torch.cat(list(tp.gather(q).unbind(0)), dim=2)
        qs = q[..., tp.index * hl:(tp.index + 1) * hl]
        s = tp.reduce(_scores(qs, k, hd))
        ctx = torch.cat(list(tp.gather(_merged(s, ok, v, seq)).unbind(0)),
                        dim=-1)
        if split:
            n = H // tp.size
            ctx = ctx[:, :, tp.index * n:(tp.index + 1) * n]
    else:
        if tp is not None and split:
            n, kl = H // tp.size, KV // tp.size
            assert kl == k.shape[2] and kv_heads(H, KV, tp.size, tp.index) \
                == list(range(tp.index * kl, (tp.index + 1) * kl)), \
                "the rank's query heads read other K / V heads than it holds"
        ctx = _merged(_scores(q, k, hd), ok, v, seq)
    out = _out(ctx.to(q.dtype), p["wo"])
    return tp.reduce(out) if split else out


def _scores(q, k, hd: int):
    """float32 scores [B, KV, G, 1, S] of q [B, 1, KV * G, hd_x] against k
    [B, S, KV, hd_x] (hd_x: all of head_dim or a slice; scaled by the whole
    head_dim's root)."""
    B, Tq, Hq, hx = q.shape
    KV = k.shape[2]
    qg = q.reshape(B, Tq, KV, Hq // KV, hx)
    return torch.einsum("bqkgh,bskh->bkgqs", qg.float() / math.sqrt(hd),
                        k.float())


def _merged(s, ok, v, seq):
    """The softmax context [B, 1, KV * G, hv] float32 of scores ``s`` [B,
    KV, G, 1, S_loc] over the slots ``ok`` of this rank and, with ``seq``,
    of the other ranks of that group: one maximum, then one sum of the
    unnormalized context and of the weights."""
    s = s + torch.where(ok, 0.0, NEG_INF).to(torch.float32)
    top = s.amax(dim=-1, keepdim=True)
    if seq is not None:
        top = seq.max(top)
    e = torch.exp(s - top)
    o = torch.einsum("bkgqs,bskh->bkgqh", e, v.float())
    ol = torch.cat([o, e.sum(dim=-1)[..., None]], dim=-1)
    if seq is not None:
        ol = seq.sum(ol)
    ctx = ol[..., :-1] / ol[..., -1:]
    B, KV, G, Tq, hv = ctx.shape
    return ctx.permute(0, 3, 1, 2, 4).reshape(B, Tq, KV * G, hv)
