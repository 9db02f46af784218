"""Decoder-only LM stack covering dense / GQA / MoE / SSM / hybrid / VLM
(port of ``repro/models/lm.py``): layer kinds "A", GQA attention with its
MLP or MoE block, and "M", the Mamba2 block with an optional MoE block or
(hybrid stacks) MLP after it.

The layer stack is a repeating "superblock" pattern (e.g. Jamba's 7 Mamba
+ 1 attention) whose parameters are stacked over ``n_superblocks`` on a
leading axis, as in the reference; the port walks the superblocks in a
plain loop.  With ``cfg.remat`` and grad enabled each superblock (and,
in a pattern of more than one layer, each layer inside it) is recomputed
in the backward pass (``torch.utils.checkpoint``, as the reference's
``jax.checkpoint`` with ``nothing_saveable``).  Training goes through
:func:`loss_fn` (:func:`chunked_ce`: the [B, T, V] logits are never
formed); the serving callers (``launch/steps.py``, :func:`decode_step`)
run under ``torch.inference_mode()``.  Parameters are nested dicts of
tensors built from the ParamDef tables.  Encoder-decoder models are
``models/whisper.py``.

Under a mesh (``launch/steps.py``) the prompt passes take ``comm`` (the
data-parallel group) and ``tp`` (the "model" group,
``launch.mesh.TensorParallel``): between blocks the residual stream is
the rank's part of the sequence, ``[B / dp, T / model, d]`` (the
reference's ``PS(dp, "model", None)`` under ``seq_shard``), with the
norms on it; the blocks compute on "model" (``attention``, ``ssm``,
``moe``, ``common.apply_mlp``), and the loss is vocabulary-parallel
(:func:`chunked_ce`).  The decode step takes the same groups
(:func:`decode_step`), with ``tp`` in its decode mode.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from . import attention as attn
from . import moe as moe_mod
from . import ssm as ssm_mod
from .common import (ParamDef, Tree, apply_mlp, apply_norm, embed_partial,
                     embed_tokens, gathered, init_tree, is_split, mlp_defs,
                     norm_defs, spec_tree, tree_from_numpy, tree_leaves,
                     tree_map)
from .config import ModelConfig


# ---------------------------------------------------------------------------
# Parameter tables
# ---------------------------------------------------------------------------

def _layer_defs(cfg: ModelConfig, kind: str, j: int) -> Tree:
    """One layer's params.  kind: 'A' attention or 'M' mamba; j = index in
    the superblock pattern (controls MoE placement)."""
    defs: Tree = {"norm1": norm_defs(cfg)}
    if kind == "A":
        defs["attn"] = attn.attn_defs(cfg)
        defs["norm2"] = norm_defs(cfg)
        if cfg.is_moe_layer(j):
            defs["moe"] = moe_mod.moe_defs(cfg)
        elif cfg.d_ff > 0:
            defs["mlp"] = mlp_defs(cfg)
    else:  # Mamba layer: its block includes gating; optional MoE/MLP after
        defs["ssm"] = ssm_mod.ssm_defs(cfg)
        if cfg.is_moe_layer(j):
            defs["norm2"] = norm_defs(cfg)
            defs["moe"] = moe_mod.moe_defs(cfg)
        elif cfg.d_ff > 0 and cfg.family == "hybrid":
            defs["norm2"] = norm_defs(cfg)
            defs["mlp"] = mlp_defs(cfg)
    return defs


def model_defs(cfg: ModelConfig) -> Tree:
    """The full LM ParamDef tree (embed, layers, final norm)."""
    V, d = cfg.vocab_size, cfg.d_model
    defs: Tree = {
        "embed": ParamDef((V, d), ("T", "F"), "embed"),
        "final_norm": norm_defs(cfg),
    }
    if not cfg.tie_embeddings:
        defs["unembed"] = ParamDef((d, V), ("F", "T"))
    n_sup = cfg.n_superblocks
    defs["layers"] = {
        f"pos{j}": tree_map(lambda pd: pd.with_leading(n_sup),
                            _layer_defs(cfg, kind, j))
        for j, kind in enumerate(cfg.pattern())
    }
    return defs


def init_params(cfg: ModelConfig, seed: int = 0, device=None) -> Tree:
    """Materialize model_defs with the config init recipes, drawn from a
    ``torch.Generator`` on ``device`` seeded with ``seed``."""
    dev = torch.device("cpu" if device is None else device)
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    return init_tree(model_defs(cfg), gen, cfg.dtype, device=dev)


def param_specs(cfg: ModelConfig) -> Tree:
    """Placeholder PartitionSpec tree matching model_defs."""
    return spec_tree(model_defs(cfg))


def count_params(cfg: ModelConfig) -> int:
    """Exact parameter count from the def tree (no allocation)."""
    return int(sum(int(np.prod(d.shape))
                   for _path, d in tree_leaves(model_defs(cfg))))


def count_active_params(cfg: ModelConfig) -> int:
    """Params touched per token (MoE experts counted at top_k of E)."""
    total = count_params(cfg)
    if cfg.moe_experts == 0:
        return total
    n_moe_layers = sum(cfg.n_superblocks for j in range(len(cfg.pattern()))
                       if cfg.is_moe_layer(j))
    per_expert = 3 * cfg.d_model * cfg.d_ff  # wi, wg, wo
    return total - n_moe_layers * (cfg.moe_experts - cfg.moe_top_k) \
        * per_expert


def params_from_numpy(cfg: ModelConfig, tree: Tree, device=None) -> Tree:
    """The port's parameters from the reference's ``lm.init_params`` tree
    as numpy arrays (stacked ``[n_superblocks, ...]`` layer leaves), cast
    to ``cfg.dtype`` on ``device``.  The tree must match
    :func:`model_defs` key for key and shape for shape."""
    return tree_from_numpy(model_defs(cfg), tree, cfg.dtype, device)


def _unembed(cfg: ModelConfig, params: Tree):
    return gathered(params["embed"]).T if cfg.tie_embeddings \
        else gathered(params["unembed"])


def _index(tree: Tree, i: int) -> Tree:
    return tree_map(lambda a: a[i], tree)


# ---------------------------------------------------------------------------
# Layer application
# ---------------------------------------------------------------------------

def _ffn_residual(cfg: ModelConfig, p: Tree, x, comm=None, tp=None):
    """A layer's second half, after either kind: the pre-norm MoE or MLP
    residual where the layer has one.  Returns (x, aux_loss or None)."""
    if "moe" in p:
        y, aux = moe_mod.apply_moe(cfg, p["moe"],
                                   apply_norm(cfg, p["norm2"], x), comm=comm,
                                   tp=tp)
        return x + y, aux
    if "mlp" in p:
        return x + apply_mlp(cfg, p["mlp"], apply_norm(cfg, p["norm2"], x),
                             tp=tp), None
    return x, None


def _apply_layer(cfg: ModelConfig, kind: str, j: int, p: Tree, x, positions,
                 comm=None, tp=None):
    """One layer of a prompt pass (pre-norm residual blocks).  Returns (x,
    aux_loss or None).  A layer's stored shards are gathered here, inside
    any recomputed region, so the recompute gathers them again."""
    p = gathered(p)
    h = apply_norm(cfg, p["norm1"], x)
    if kind == "A":
        x = x + attn.attention(cfg, p["attn"], h, positions, causal=True,
                               window=cfg.window, tp=tp)
    else:
        y, _state = ssm_mod.mamba_block(cfg, p["ssm"], h, tp=tp)
        x = x + y
    return _ffn_residual(cfg, p, x, comm, tp)


def remat_active(cfg) -> bool:
    """Recompute activations in the backward pass: ``cfg.remat`` and grad
    enabled (serving and inference never recompute)."""
    return cfg.remat and torch.is_grad_enabled()


def _layer_aux(cfg: ModelConfig, kind: str, j: int, p: Tree, x, positions,
               comm=None, tp=None):
    """:func:`_apply_layer` with the aux loss as a tensor (0 where the
    layer has none), the form a checkpointed function returns."""
    x, a = _apply_layer(cfg, kind, j, p, x, positions, comm, tp)
    return x, a if a is not None else torch.zeros(
        (), dtype=torch.float32, device=x.device)


def _superblock(cfg: ModelConfig, params_sb: Tree, x, positions,
                comm=None, tp=None):
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    # nested per-layer remat: without it the backward of a long superblock
    # (jamba: 8 layers) holds every layer's intermediates at once
    nested = remat_active(cfg) and len(cfg.pattern()) > 1
    for j, kind in enumerate(cfg.pattern()):
        p = params_sb[f"pos{j}"]
        if nested:
            x, a = checkpoint(_layer_aux, cfg, kind, j, p, x, positions,
                              comm, tp, use_reentrant=False)
        else:
            x, a = _apply_layer(cfg, kind, j, p, x, positions, comm, tp)
        if a is not None:
            aux = aux + a
    return x, aux


# ---------------------------------------------------------------------------
# Forward / loss
# ---------------------------------------------------------------------------

def embed_inputs(cfg: ModelConfig, params: Tree,
                 batch: Dict[str, torch.Tensor], tp=None):
    """Token (+ optional modality-stub) embedding.  Returns (x [B, T, d],
    positions [B, T]).  ``audio_frames``: the frames [B, T, d] are already
    d_model embeddings (the conv stub); ``vision_patches``: the patch
    embeddings ``vision_embeds`` [B, vis, d], where given, go in front of
    the text tokens (early fusion), and the positions count both.  With
    ``tp``, x is the rank's part of the sequence (frames arrive so) and
    the positions are the whole sequence's."""
    vis = batch.get("vision_embeds") \
        if cfg.frontend == "vision_patches" else None
    if cfg.frontend == "audio_frames":
        x = torch.as_tensor(batch["frames"], device=params["embed"].device)
        x = x.to(cfg.dtype)
    elif tp is not None:
        x = _embed_tp(cfg, params, batch["tokens"], vis, tp)
    else:
        x = embed_tokens(cfg, params, batch["tokens"])
        if vis is not None:
            vis = torch.as_tensor(vis, device=x.device)
            x = torch.cat([vis.to(cfg.dtype), x], dim=1)
    T = x.shape[1] * (1 if tp is None else tp.size)
    positions = torch.arange(T, device=x.device).expand(x.shape[0], T)
    return x, positions


def _embed_tp(cfg: ModelConfig, params: Tree, tokens, vis, tp):
    """:func:`embed_inputs`' rows of the rank's part of the sequence:
    the vision embeddings in front of the text, the text through
    ``embed_tokens`` (a vocabulary-split lookup's partial rows, with zero
    rows in the vision positions, reduce-scattered along T)."""
    if vis is None:
        return embed_tokens(cfg, params, tokens, tp)
    embed = gathered(params["embed"])
    tokens = torch.as_tensor(tokens, device=embed.device).long()
    vis = torch.as_tensor(vis, device=embed.device).to(cfg.dtype)
    if is_split(embed, cfg.vocab_size, 0, tp):
        x = embed_partial(cfg, embed, tokens, tp)
        x = tp.scatter_seq(torch.cat([torch.zeros_like(vis), x], dim=1))
        pad = torch.zeros(tokens.shape + (cfg.d_model,), dtype=cfg.dtype,
                          device=embed.device)
        return x + tp.own(torch.cat([vis, pad], dim=1))
    x = (embed[tokens] * math.sqrt(cfg.d_model)).to(cfg.dtype)
    return tp.own(torch.cat([vis, x], dim=1))


def forward_hidden(cfg: ModelConfig, params: Tree,
                   batch: Dict[str, torch.Tensor], *, comm=None, tp=None):
    """Forward up to (and incl.) the final norm -> (x [B, T, d], aux);
    each superblock recomputed in the backward pass where
    :func:`remat_active`.  ``comm`` (the data-parallel group of a mesh,
    ``launch.mesh.DataParallel``) makes the MoE layers route the global
    batch; ``aux`` is then this rank's share of it.  ``tp`` (its "model"
    group, ``launch.mesh.TensorParallel``) splits each block's compute
    over "model"; x is then the rank's part of the sequence, ``[B,
    T / model, d]``, and ``aux`` the same on every rank along "model"."""
    x, positions = embed_inputs(cfg, params, batch, tp)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    remat = remat_active(cfg)
    for i in range(cfg.n_superblocks):
        sb = _index(params["layers"], i)
        if remat:
            x, a = checkpoint(_superblock, cfg, sb, x, positions, comm, tp,
                              use_reentrant=False)
        else:
            x, a = _superblock(cfg, sb, x, positions, comm, tp)
        aux = aux + a
    return apply_norm(cfg, gathered(params["final_norm"]), x), aux


def last_logits(cfg: ModelConfig, params: Tree, x, tp=None):
    """The float32 logits [B, V] of the last position of the final
    hidden states ``x``.  With ``tp`` (x the rank's part of the sequence)
    the last position comes from the rank holding it, and a
    vocabulary-split unembedding's slices are gathered."""
    unembed = _unembed(cfg, params)
    if tp is None:
        return (x[:, -1] @ unembed).float()
    last = tp.gather(x[:, -1])[-1]
    logits = (last @ unembed).float()
    if not is_split(unembed, cfg.vocab_size, 1, tp):
        return logits
    return tp.gather(logits).permute(1, 0, 2).reshape(last.shape[0], -1)


def forward(cfg: ModelConfig, params: Tree, batch: Dict[str, torch.Tensor]):
    """Forward -> (logits [B, T, V] float32, aux_loss scalar).  Materializes
    the full logits: use for short prompts (tests); prefill takes the last
    position only (``launch/steps.py``), training :func:`loss_fn`."""
    x, aux = forward_hidden(cfg, params, batch)
    return (x @ _unembed(cfg, params)).float(), aux


def _ce_chunk(xc, unembed, lc, tp=None):
    """One chunk's (nll sum, z sum, count) of :func:`chunked_ce`.  With
    ``tp`` the logits are the rank's vocabulary slice: the logsumexp
    comes from the maximum and the sum of exponentials over "model", the
    gold logit from the rank that owns the label, both summed through
    ``tp.reduce`` (backward: the identity), so each rank's gradient is
    its own slice's and every token counts once."""
    logits = (xc @ unembed).float()                     # [B, chunk, V]
    mask = (lc >= 0).float()
    if tp is None:
        safe = torch.clamp(lc, min=0)
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, safe[..., None])[..., 0]
    else:
        n = logits.shape[-1]
        local = lc - tp.index * n
        top = tp.max(logits.amax(dim=-1))
        gold = torch.gather(logits, -1,
                            local.clamp(0, n - 1)[..., None])[..., 0]
        ex, gold = tp.reduce(torch.stack([
            torch.sum(torch.exp(logits - top[..., None]), dim=-1),
            torch.where((local >= 0) & (local < n), gold, 0.0)]))
        logz = top + torch.log(ex)
    return (torch.sum((logz - gold) * mask), torch.sum((logz * mask) ** 2),
            torch.sum(mask))


def chunked_ce(x_final, unembed, labels, *, chunk: int = 512,
               z_weight: float = 1e-4, tp=None):
    """Cross-entropy over T chunks, so that the full [B, T, V] logits are
    never formed (V runs to 202k in the assigned archs): under grad each
    chunk's logits are recomputed in the backward pass instead of kept.

    x_final: [B, T, d] post-final-norm activations; labels [B, T] (< 0
    masked).  Returns (nll_sum, z_weight * z_sum, count), float32.  With
    ``tp`` (a mesh's "model" group) ``unembed`` is the rank's columns of
    the vocabulary: the loss is vocabulary-parallel, and every rank
    returns the same sums."""
    B, T, _d = x_final.shape
    chunk = min(chunk, T)
    if T % chunk:
        raise ValueError(f"T = {T} is not a multiple of the chunk {chunk}")
    labels = torch.as_tensor(labels, device=x_final.device).long()
    zero = torch.zeros((), dtype=torch.float32, device=x_final.device)
    nll_s, z_s, cnt = zero, zero, zero
    remat = torch.is_grad_enabled()
    for c0 in range(0, T, chunk):
        xc, lc = x_final[:, c0:c0 + chunk], labels[:, c0:c0 + chunk]
        if remat:
            n, z, k = checkpoint(_ce_chunk, xc, unembed, lc, tp,
                                 use_reentrant=False)
        else:
            n, z, k = _ce_chunk(xc, unembed, lc, tp)
        nll_s, z_s, cnt = nll_s + n, z_s + z, cnt + k
    return nll_s, z_weight * z_s, cnt


def sequence_ce(cfg: ModelConfig, x, unembed, labels, tp, **kw):
    """:func:`chunked_ce` of a rank's part of the sequence ``x`` under
    ``tp`` (labels the whole sequence's): vocabulary-parallel on the
    gathered sequence where ``unembed`` is the rank's vocabulary slice,
    else on the rank's tokens with the sums summed over "model"; the sums
    are every rank's along "model".  Without ``tp``, :func:`chunked_ce`
    of ``x``."""
    if tp is None:
        return chunked_ce(x, unembed, labels, **kw)
    if is_split(unembed, cfg.vocab_size, 1, tp):
        return chunked_ce(tp.gather_seq(x), unembed, labels, tp=tp, **kw)
    sums = chunked_ce(x, unembed, tp.own(labels), **kw)
    return tuple(tp.reduce(torch.stack(sums)).unbind(0))


def loss_fn(cfg: ModelConfig, params: Tree, batch: Dict[str, torch.Tensor],
            *, aux_weight: float = 0.01, z_weight: float = 1e-4, comm=None,
            tp=None):
    """Causal LM loss with label masking (labels < 0 are ignored) -> (loss,
    {"ce", "aux", "zloss"}): ``ce + zloss + aux_weight * aux``.  With
    vision embeddings in front of the text, their positions get label -1.

    With ``comm`` (a mesh's data-parallel group, this rank's rows of the
    batch) the mean is over the global batch, as the reference's one
    program takes it: the loss returned is this rank's share, whose
    gradients summed over the group are the reference's, and the metrics
    (and ``"loss"``, the global loss) are the global ones.  With ``tp``
    as well (its "model" group) the blocks and the loss compute on
    "model" (:func:`forward_hidden`, :func:`sequence_ce`)."""
    x, aux = forward_hidden(cfg, params, batch, comm=comm, tp=tp)
    labels = torch.as_tensor(batch["labels"], device=x.device).long()
    T = x.shape[1] * (1 if tp is None else tp.size)
    if cfg.frontend == "vision_patches" and "vision_embeds" in batch:
        pad = labels.new_full((labels.shape[0], T - labels.shape[1]), -1)
        labels = torch.cat([pad, labels], dim=1)
    nll_s, z_s, cnt = sequence_ce(cfg, x, _unembed(cfg, params), labels, tp,
                                  z_weight=z_weight)
    if comm is not None:
        return _global_loss(nll_s, z_s, cnt, aux, aux_weight, comm, tp)
    denom = torch.clamp(cnt, min=1.0)
    ce = nll_s / denom
    zloss = z_s / denom
    return ce + zloss + aux_weight * aux, {"ce": ce, "aux": aux,
                                           "zloss": zloss}


def _global_loss(nll_s, z_s, cnt, aux, aux_weight: float, comm, tp=None):
    """A rank's loss and the global metrics from its rows' sums: the
    count is summed over the data-parallel group first (it carries no
    gradient), so each rank's ``(nll + z) / count + aux_weight * aux``
    sums over the group to the global loss.  Along "model" (``tp``) the
    sums and ``aux`` are every rank's alike; the cross-entropy's
    gradients are each rank's own part already, while ``aux`` is
    computed whole on every rank from the gathered tokens, so each rank
    takes its ``1 / model`` of it."""
    sums = comm.sum(torch.stack([cnt, nll_s, z_s, aux]).detach())
    denom = torch.clamp(sums[0], min=1.0)
    share = aux if tp is None else aux / tp.size
    loss = (nll_s + z_s) / denom + aux_weight * share
    ce, zloss, aux_g = sums[1] / denom, sums[2] / denom, sums[3]
    return loss, {"ce": ce, "aux": aux_g, "zloss": zloss,
                  "loss": ce + zloss + aux_weight * aux_g}


# ---------------------------------------------------------------------------
# Decode (serve_step)
# ---------------------------------------------------------------------------

def init_decode_state(cfg: ModelConfig, batch: int, max_len: int,
                      device=None) -> Tree:
    """Per-pattern-position caches stacked over superblocks: an attention
    layer's ring-buffer k / v [n_sup, batch, S, KV, hd] with S = max_len
    (min(max_len, window) for sliding-window attention), an SSM layer's
    O(1) carry.  ``pos`` is the next write position."""
    n_sup = cfg.n_superblocks
    state: Tree = {"pos": 0, "layers": {}}
    for j, kind in enumerate(cfg.pattern()):
        if kind == "A":
            S = max_len if cfg.window is None else min(max_len, cfg.window)
            shape = (n_sup, batch, S, cfg.n_kv_heads, cfg.head_dim)
            state["layers"][f"pos{j}"] = {
                c: torch.zeros(shape, dtype=cfg.dtype, device=device)
                for c in ("k", "v")}
            continue
        s = ssm_mod.init_ssm_state(cfg, batch, device=device)
        state["layers"][f"pos{j}"] = {
            k: a[None].repeat(n_sup, *([1] * a.dim())) for k, a in s.items()}
    return state


@torch.inference_mode()
def decode_step(cfg: ModelConfig, params: Tree, state: Tree, tokens, *,
                comm=None, seq=None, tp=None) -> Tuple[torch.Tensor, Tree]:
    """One decode step: tokens [B, 1] -> (logits [B, 1, V] float32, new
    state).  The state is donated (as the reference's serve loop donates
    it): its carries are updated in place and it is returned with ``pos``
    advanced.

    Under a mesh (``launch/steps.py``'s serve step) ``params`` are the
    stored shards, gathered a layer at a time, ``state`` holds the rank's
    shards and ``tokens`` its rows; ``tp`` is the "model" group in its
    decode mode: the residual stream ``[B / dp (or B), 1, d]`` is whole on
    every rank, the embedding a vocabulary-split lookup summed over
    "model", each block the rank's heads, columns or experts summed over
    "model", and the logits the rank's vocabulary slice gathered into
    whole rows.  The KV cache is laid out one of three ways
    (``models/attention.py``): B over the dp axes, or, where B does not
    divide, its slots over them (``seq``, the dp group; else ``comm``,
    the dp group the MoE layers count the global batch over); and K / V
    heads over "model", or head_dim where they do not divide."""
    x = embed_tokens(cfg, params, tokens, tp)
    pos = state["pos"]
    for i in range(cfg.n_superblocks):
        params_sb = _index(params["layers"], i)
        for j, kind in enumerate(cfg.pattern()):
            p = gathered(params_sb[f"pos{j}"])
            carry = state["layers"][f"pos{j}"]
            h = apply_norm(cfg, p["norm1"], x)
            if kind == "A":
                y, _k, _v = attn.decode_attention(
                    cfg, p["attn"], h, carry["k"][i], carry["v"][i], pos,
                    window=cfg.window, tp=tp, seq=seq)
            else:
                y, new = ssm_mod.mamba_block(
                    cfg, p["ssm"], h,
                    state={k: a[i] for k, a in carry.items()}, tp=tp)
                for k, a in new.items():
                    carry[k][i].copy_(a)
            x, _aux = _ffn_residual(cfg, p, x + y, comm, tp)
    x = apply_norm(cfg, gathered(params["final_norm"]), x)
    state["pos"] = pos + 1
    return decode_logits(cfg, x, _unembed(cfg, params), tp), state


def decode_logits(cfg: ModelConfig, x, unembed, tp=None):
    """float32 logits [B, 1, V] of the final hidden states ``x`` [B, 1, d];
    with ``tp`` a vocabulary-split ``unembed``'s slices are gathered."""
    logits = (x @ unembed).float()
    if not is_split(unembed, cfg.vocab_size, 1, tp):
        return logits
    return torch.cat(list(tp.gather(logits).unbind(0)), dim=-1)
