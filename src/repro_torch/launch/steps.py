"""Step builders (port of ``repro/launch/steps.py``):

  train   -> train_step(params, opt_state, batch)   (loss, grads, AdamW)
  prefill -> prefill_step(params, batch)            (last-position logits)
  decode  -> serve_step(params, state, tokens)      (one token, carried)

The gradients are ``torch.autograd.grad`` of the family's ``loss_fn``
over the parameter leaves (the reference's ``jax.value_and_grad``); the
serving steps run under ``torch.inference_mode()``.

The input shapes and specs of every (arch x shape) cell, which
``launch/dryrun.py`` lays out: :func:`param_shapes`, :func:`opt_shapes`,
:func:`batch_specs` and :func:`decode_state_specs` return trees of
tensors on the ``meta`` device (shape and dtype, no storage) beside trees
of specs (tuples, one entry a dimension, as ``launch/mesh.py`` resolves
them; a one-axis tuple is written as the axis's name, as jax's
``PartitionSpec`` writes it).  The reference's ``prepare_config`` is not
ported: it sets ``dp_axes``, ``seq_shard`` and ``unroll_inner``, fields
the port's ``ModelConfig`` does not have, since nothing here reads them;
nor is its ``_dp_size``, which nothing in the reference calls.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from ..models import lm, whisper
from ..models.common import Tree, init_tree, tree_leaves, tree_map
from ..models.config import ModelConfig
from ..optim import AdamWConfig, adamw_init, adamw_update
from .mesh import Mesh, Spec, axis_size, dp_axes, fix_spec_tree, \
    resolve_spec_tree

#: the parameter subtrees whose leaves are stacked over layers
STACKED = ("layers", "enc_layers", "dec_layers")


def model_module(cfg: ModelConfig):
    """The model family module (lm or whisper) for this config."""
    return whisper if cfg.encdec else lm


def _unstacked(params: Tree) -> Tree:
    """``params`` with every layer-stacked leaf replaced by the list of
    its per-layer views (``unbind``), which the models index like the
    stacked tensor.  The backward then stacks each leaf's per-layer
    gradients once, where indexing the stacked tensor layer by layer
    would add a full-size zero-padded gradient per layer."""
    return {k: tree_map(lambda a: list(a.unbind(0)), v) if k in STACKED
            else v for k, v in params.items()}


def _leaves(tree: Tree):
    return [leaf for _path, leaf in tree_leaves(tree)]


def _unflatten(like: Tree, leaves) -> Tree:
    it = iter(leaves)
    out: Dict[str, Any] = {}
    for path, _leaf in tree_leaves(like):
        node = out
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = next(it)
    return out


def build_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig, *,
                     accum: int = 1):
    """One optimizer step; ``accum`` > 1 accumulates the gradients of
    that many microbatches (the batch's rows split in order) in float32
    buffers, ``gacc + g.float() / accum``, the loss the same way, and
    averages the metrics over them, as the reference's ``scan`` does.
    The parameters and optimizer state are updated in place (the
    reference donates them) and returned."""
    mod = model_module(cfg)

    def grads_of(params, batch):
        leaves = _leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        try:
            loss, metrics = mod.loss_fn(cfg, _unstacked(params), batch)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        finally:
            for p in leaves:
                p.requires_grad_(False)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(leaves, grads)]
        return loss.detach(), {k: v.detach() for k, v in metrics.items()}, \
            grads

    def train_step(params, opt_state, batch):
        if accum == 1:
            loss, metrics, grads = grads_of(params, batch)
        else:
            rows = len(batch["tokens"])
            if rows % accum:
                raise ValueError(f"batch of {rows} rows does not split "
                                 f"into {accum} microbatches")
            mb = rows // accum
            grads = [torch.zeros(p.shape, dtype=torch.float32,
                                 device=p.device) for p in _leaves(params)]
            loss = None
            metrics_all = []
            for i in range(accum):
                part = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
                l_i, m_i, g_i = grads_of(params, part)
                for acc, g in zip(grads, g_i):
                    acc.add_(g.float() / accum)
                del g_i
                loss = l_i / accum if loss is None else loss + l_i / accum
                metrics_all.append(m_i)
            metrics = {k: torch.stack([m[k] for m in metrics_all]).mean()
                       for k in metrics_all[0]}
        params, opt_state, gnorm = adamw_update(
            opt_cfg, _unflatten(params, grads), opt_state, params)
        return params, opt_state, dict(metrics, loss=loss, grad_norm=gnorm)

    return train_step


def build_prefill_step(cfg: ModelConfig):
    """Returns last-position logits (the sampled-token distribution)."""
    if cfg.encdec:
        @torch.inference_mode()
        def prefill_step(params, batch):
            memory = whisper.encode(cfg, params, batch["frames"])
            logits = whisper.decode_train(cfg, params, batch["tokens"],
                                          memory)
            return logits[:, -1]
        return prefill_step

    @torch.inference_mode()
    def prefill_step(params, batch):
        x, _aux = lm.forward_hidden(cfg, params, batch)
        unembed = params["embed"].T if cfg.tie_embeddings else params["unembed"]
        return (x[:, -1] @ unembed).float()

    return prefill_step


def build_serve_step(cfg: ModelConfig):
    """One-token decode step closure over the model family."""
    mod = model_module(cfg)

    def serve_step(params, state, tokens):
        return mod.decode_step(cfg, params, state, tokens)

    return serve_step


def param_and_opt_specs(cfg: ModelConfig, mesh: Mesh, *,
                        fsdp: Optional[bool] = None):
    """Resolved (param, optimizer-state) spec trees: the parameters'
    placeholders resolved (``fsdp``, by default the config's) and fitted
    to their shapes, the moments' with "F" always on the data axes
    (ZeRO-1)."""
    fsdp = cfg.fsdp if fsdp is None else fsdp
    mod = model_module(cfg)
    placeholders = mod.param_specs(cfg)
    shapes = mod.model_defs(cfg)
    p_specs = fix_spec_tree(
        shapes, resolve_spec_tree(placeholders, mesh, fsdp=fsdp), mesh)
    o_inner = fix_spec_tree(
        shapes, resolve_spec_tree(placeholders, mesh, fsdp=fsdp, zero1=True),
        mesh)
    return p_specs, {"m": o_inner, "v": o_inner, "count": ()}


# ---------------------------------------------------------------------------
# Input shapes (meta tensors) and specs, per shape kind
# ---------------------------------------------------------------------------

#: the encoder-decoder's decode cache length (the reference's ``max_dec``)
WHISPER_MAX_DEC = 1024


def _meta(shape: Tuple[int, ...], dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def _spec(*entries) -> Spec:
    """A spec with each one-axis tuple written as the axis's name."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e
                 for e in entries)


def _ax_if_div(n: int, axes, mesh: Mesh):
    """``axes`` where ``n`` divides by their extent (and is at least as
    large), else None (replicated)."""
    size = axis_size(mesh, axes)
    return axes if n % size == 0 and n >= size else None


def batch_specs(cfg: ModelConfig, shape, mesh: Mesh, *, with_labels: bool):
    """(meta tensors, specs) of a train / prefill batch: the batch over
    the dp axes where it divides; audio frames also over "model" along
    time where that divides; vision embeddings beside the tokens."""
    B, T = shape.global_batch, shape.seq_len
    dp = _ax_if_div(B, dp_axes(mesh), mesh)
    meta: Dict[str, torch.Tensor] = {}
    specs: Dict[str, Spec] = {}
    if cfg.frontend == "audio_frames":
        meta["frames"] = _meta((B, T, cfg.d_model), torch.bfloat16)
        specs["frames"] = _spec(dp, _ax_if_div(T, "model", mesh), None)
        Tt = max(1, T // cfg.dec_ratio)
    else:
        Tt = T
        if cfg.frontend == "vision_patches":
            vis = min(cfg.vis_tokens, T // 2)
            Tt = T - vis
            meta["vision_embeds"] = _meta((B, vis, cfg.d_model),
                                          torch.bfloat16)
            specs["vision_embeds"] = _spec(dp, None, None)
    meta["tokens"] = _meta((B, Tt), torch.int32)
    specs["tokens"] = _spec(dp, None)
    if with_labels:
        meta["labels"] = _meta((B, Tt), torch.int32)
        specs["labels"] = _spec(dp, None)
    return meta, specs


def _cache_spec(cfg: ModelConfig, shape, mesh: Mesh) -> Spec:
    """KV cache [n_sup, B, S, KV, hd] spec of a decode cell: B over the dp
    axes where it divides (decode_32k), else S over them (long_500k); KV
    over "model" where it divides, else head_dim."""
    dp = _ax_if_div(shape.global_batch, dp_axes(mesh), mesh)
    seq_ax = None if dp is not None else dp_axes(mesh)
    kv_ax = _ax_if_div(cfg.n_kv_heads, "model", mesh)
    hd_ax = None if kv_ax is not None else "model"
    return _spec(None, dp, seq_ax, kv_ax, hd_ax)


def decode_state_specs(cfg: ModelConfig, shape, mesh: Mesh):
    """(state meta tree, state spec tree, token meta tensor, token spec)
    of a decode cell.  The state is the family's ``init_decode_state`` at
    the cell's batch and length, on the meta device; its ``pos`` (a
    Python int in the port) is an int32 scalar here, as the step's
    argument is in the reference."""
    B, S = shape.global_batch, shape.seq_len
    dp = _ax_if_div(B, dp_axes(mesh), mesh)
    cache = _cache_spec(cfg, shape, mesh)
    tokens = _meta((B, 1), torch.int32)
    if cfg.encdec:
        memory = _meta((B, S, cfg.d_model), cfg.dtype)
        state = whisper.init_decode_state(cfg, param_shapes(cfg), B,
                                          WHISPER_MAX_DEC, memory)
        # cross K/V [L, B, S_enc, KV, hd]: S_enc over dp when B == 1
        specs: Tree = {"pos": (), "k": cache, "v": cache, "xk": cache,
                       "xv": cache}
    else:
        state = lm.init_decode_state(cfg, B, S, device="meta")
        conv_ch = cfg.d_inner + 2 * cfg.ssm_state
        layers: Tree = {}
        for j, kind in enumerate(cfg.pattern()):
            if kind == "A":
                layers[f"pos{j}"] = {"k": cache, "v": cache}
            else:
                layers[f"pos{j}"] = {
                    "conv": _spec(None, dp, None,
                                  _ax_if_div(conv_ch, "model", mesh)),
                    "ssm": _spec(None, dp,
                                 _ax_if_div(cfg.ssm_heads, "model", mesh),
                                 None, None)}
        specs = {"pos": (), "layers": layers}
    state["pos"] = _meta((), torch.int32)
    return state, specs, tokens, _spec(dp, None)


def param_shapes(cfg: ModelConfig) -> Tree:
    """The parameters as meta tensors, through the family's init recipe
    (``init_tree`` of its ``model_defs``), so shapes and dtypes are the
    init's; nothing is allocated."""
    return init_tree(model_module(cfg).model_defs(cfg), torch.Generator(),
                     cfg.dtype, device="meta")


def opt_shapes(params: Tree) -> Tree:
    """``optim.adamw_init`` of the meta ``params``: float32 moments ``m``
    and ``v`` on the meta device, and the int32 step ``count`` (a host
    scalar in the port) as an int32 meta scalar, the step's argument in
    the reference."""
    state = adamw_init(params)
    state["count"] = _meta((), state["count"].dtype)
    return state
