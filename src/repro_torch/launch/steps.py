"""Step builders (port of ``repro/launch/steps.py``):

  train   -> train_step(params, opt_state, batch)   (loss, grads, AdamW)
  prefill -> prefill_step(params, batch)            (last-position logits)
  decode  -> serve_step(params, state, tokens)      (one token, carried)

The gradients are ``torch.autograd.grad`` of the family's ``loss_fn``
over the parameter leaves (the reference's ``jax.value_and_grad``); the
serving steps run under ``torch.inference_mode()``.  The shape-only
helpers of the dry run (``batch_specs``, ``decode_state_specs``,
``param_shapes``, ``opt_shapes``) come with ``launch/dryrun.py``
(ROADMAP.md A.17 item 6).
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from ..models import lm, whisper
from ..models.common import Tree, tree_leaves, tree_map
from ..models.config import ModelConfig
from ..optim import AdamWConfig, adamw_update
from .mesh import Mesh, fix_spec_tree, resolve_spec_tree

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


def param_and_opt_specs(cfg: ModelConfig, mesh: Mesh, *, fsdp: bool = False):
    """Resolved (param, optimizer-state) spec trees: the parameters'
    placeholders resolved (fsdp as given) and fitted to their shapes, the
    moments' with "F" always on the data axes (ZeRO-1)."""
    mod = model_module(cfg)
    placeholders = mod.param_specs(cfg)
    shapes = mod.model_defs(cfg)
    p_specs = fix_spec_tree(
        shapes, resolve_spec_tree(placeholders, mesh, fsdp=fsdp), mesh)
    o_inner = fix_spec_tree(
        shapes, resolve_spec_tree(placeholders, mesh, fsdp=fsdp, zero1=True),
        mesh)
    return p_specs, {"m": o_inner, "v": o_inner, "count": ()}
