"""Decoder-only LM stack (port of ``repro/models/lm.py`` for layer kinds
"A", dense GQA attention with its MLP, and "M", the Mamba2 block).

The layer stack is a repeating "superblock" pattern whose parameters are
stacked over ``n_superblocks`` on a leading axis, as in the reference; the
port walks the superblocks in a plain loop under ``torch.inference_mode()``
(no remat: it serves, it does not train).  Parameters are nested dicts of
tensors built from the ParamDef tables.  MoE layers, the hybrid MLP and
encoder-decoder models are not ported yet (ROADMAP.md A.17 items 2-3) and
raise ``NotImplementedError``.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import numpy as np
import torch

from . import attention as attn
from . import ssm as ssm_mod
from .common import (ParamDef, Tree, apply_mlp, apply_norm, init_tree,
                     mlp_defs, norm_defs, tree_leaves, tree_map)
from .config import ModelConfig

_NOT_PORTED = "is not ported yet (ROADMAP.md A.17)"


# ---------------------------------------------------------------------------
# Parameter tables
# ---------------------------------------------------------------------------

def _check_ported(cfg: ModelConfig) -> None:
    if cfg.encdec:
        raise NotImplementedError(f"encoder-decoder models {_NOT_PORTED}")
    if cfg.frontend is not None:
        raise NotImplementedError(f"the {cfg.frontend} frontend {_NOT_PORTED}")


def _layer_defs(cfg: ModelConfig, kind: str, j: int) -> Tree:
    """One layer's params.  kind: 'A' attention or 'M' mamba; j = index in
    the superblock pattern (controls MoE placement)."""
    if cfg.is_moe_layer(j):
        raise NotImplementedError(f"MoE layers {_NOT_PORTED}")
    defs: Tree = {"norm1": norm_defs(cfg)}
    if kind == "A":
        defs["attn"] = attn.attn_defs(cfg)
        defs["norm2"] = norm_defs(cfg)
        if cfg.d_ff > 0:
            defs["mlp"] = mlp_defs(cfg)
        return defs
    if cfg.d_ff > 0 and cfg.family == "hybrid":
        raise NotImplementedError(f"the hybrid MLP {_NOT_PORTED}")
    defs["ssm"] = ssm_mod.ssm_defs(cfg)
    return defs


def model_defs(cfg: ModelConfig) -> Tree:
    """The full LM ParamDef tree (embed, layers, final norm)."""
    _check_ported(cfg)
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


def count_params(cfg: ModelConfig) -> int:
    """Exact parameter count from the def tree (no allocation)."""
    return int(sum(int(np.prod(d.shape))
                   for _path, d in tree_leaves(model_defs(cfg))))


def params_from_numpy(cfg: ModelConfig, tree: Tree, device=None) -> Tree:
    """The port's parameters from the reference's ``lm.init_params`` tree
    as numpy arrays (stacked ``[n_superblocks, ...]`` layer leaves), cast
    to ``cfg.dtype`` on ``device``.  The tree must match
    :func:`model_defs` key for key and shape for shape."""
    defs = dict(tree_leaves(model_defs(cfg)))
    got = dict(tree_leaves(tree))
    if set(defs) != set(got):
        raise ValueError(f"parameter trees differ: missing "
                         f"{sorted(set(defs) - set(got))}, unexpected "
                         f"{sorted(set(got) - set(defs))}")
    out: Tree = {}
    for path, d in defs.items():
        a = np.array(got[path], dtype=np.float32)
        if a.shape != tuple(d.shape):
            raise ValueError(f"{'/'.join(path)}: shape {a.shape}, expected "
                             f"{d.shape}")
        node = out
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = torch.as_tensor(a).to(device=device, dtype=cfg.dtype)
    return out


def _unembed(cfg: ModelConfig, params: Tree):
    return params["embed"].T if cfg.tie_embeddings else params["unembed"]


def _index(tree: Tree, i: int) -> Tree:
    return tree_map(lambda a: a[i], tree)


# ---------------------------------------------------------------------------
# Layer application
# ---------------------------------------------------------------------------

def _mlp_residual(cfg: ModelConfig, p: Tree, x):
    """The attention layer's second half: pre-norm MLP residual."""
    if "mlp" not in p:
        return x
    return x + apply_mlp(cfg, p["mlp"], apply_norm(cfg, p["norm2"], x))


def _apply_layer(cfg: ModelConfig, kind: str, j: int, p: Tree, x, positions):
    """One layer of a prompt pass (pre-norm residual blocks).  Returns (x,
    aux_loss)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    h = apply_norm(cfg, p["norm1"], x)
    if kind == "A":
        x = x + attn.attention(cfg, p["attn"], h, positions, causal=True,
                               window=cfg.window)
        return _mlp_residual(cfg, p, x), aux
    y, _state = ssm_mod.mamba_block(cfg, p["ssm"], h)
    return x + y, aux


def _superblock(cfg: ModelConfig, params_sb: Tree, x, positions):
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for j, kind in enumerate(cfg.pattern()):
        x, a = _apply_layer(cfg, kind, j, params_sb[f"pos{j}"], x, positions)
        aux = aux + a
    return x, aux


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def embed_inputs(cfg: ModelConfig, params: Tree, batch: Dict[str, torch.Tensor]):
    """Token embedding.  Returns (x [B, T, d], positions [B, T])."""
    _check_ported(cfg)
    tokens = torch.as_tensor(batch["tokens"], device=params["embed"].device)
    x = (params["embed"][tokens.long()] * math.sqrt(cfg.d_model)).to(cfg.dtype)
    positions = torch.arange(x.shape[1], device=x.device).expand(x.shape[:2])
    return x, positions


@torch.inference_mode()
def forward_hidden(cfg: ModelConfig, params: Tree,
                   batch: Dict[str, torch.Tensor]):
    """Forward up to (and incl.) the final norm -> (x [B, T, d], aux)."""
    x, positions = embed_inputs(cfg, params, batch)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(cfg.n_superblocks):
        x, a = _superblock(cfg, _index(params["layers"], i), x, positions)
        aux = aux + a
    return apply_norm(cfg, params["final_norm"], x), aux


@torch.inference_mode()
def forward(cfg: ModelConfig, params: Tree, batch: Dict[str, torch.Tensor]):
    """Forward -> (logits [B, T, V] float32, aux_loss scalar).  Materializes
    the full logits: use for short prompts (tests); prefill takes the last
    position only (``launch/steps.py``)."""
    x, aux = forward_hidden(cfg, params, batch)
    return (x @ _unembed(cfg, params)).float(), aux


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
def decode_step(cfg: ModelConfig, params: Tree, state: Tree,
                tokens) -> Tuple[torch.Tensor, Tree]:
    """One decode step: tokens [B, 1] -> (logits [B, 1, V] float32, new
    state).  The state is donated (as the reference's serve loop donates
    it): its carries are updated in place and it is returned with ``pos``
    advanced."""
    x, _positions = embed_inputs(cfg, params, {"tokens": tokens})
    pos = state["pos"]
    for i in range(cfg.n_superblocks):
        params_sb = _index(params["layers"], i)
        for j, kind in enumerate(cfg.pattern()):
            p = params_sb[f"pos{j}"]
            carry = state["layers"][f"pos{j}"]
            h = apply_norm(cfg, p["norm1"], x)
            if kind == "A":
                y, _k, _v = attn.decode_attention(
                    cfg, p["attn"], h, carry["k"][i], carry["v"][i], pos,
                    window=cfg.window)
                x = _mlp_residual(cfg, p, x + y)
                continue
            y, new = ssm_mod.mamba_block(
                cfg, p["ssm"], h, state={k: a[i] for k, a in carry.items()})
            x = x + y
            for k, a in new.items():
                carry[k][i].copy_(a)
    x = apply_norm(cfg, params["final_norm"], x)
    logits = (x @ _unembed(cfg, params)).float()
    state["pos"] = pos + 1
    return logits, state
