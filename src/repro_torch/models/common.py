"""Shared building blocks: ParamDef tables and norms (port of the part of
``repro/models/common.py`` the SSM family needs; RoPE, M-RoPE and the MLPs
come with the attention families, ROADMAP.md A.17).

Sharding placeholders in ParamDef specs are kept as data ("T" the tensor
axis, "F" the fsdp axis, None replicated); nothing resolves them yet.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch

Tree = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class ParamDef:
    """Declarative parameter: shape, placeholder spec, init recipe."""
    shape: Tuple[int, ...]
    spec: Tuple[Optional[str], ...]      # placeholder spec, same rank as shape
    init: str = "normal"                 # normal | zeros | ones | embed
    scale: float = 1.0                   # stddev multiplier for "normal"
    fan_in: int = 0                      # contraction size; 0 -> shape[-2]

    def with_leading(self, n: int) -> "ParamDef":
        """Stack n copies along a new leading (layer) axis."""
        return ParamDef((n,) + self.shape, (None,) + self.spec, self.init,
                        self.scale, self.fan_in)


def tree_leaves(tree: Tree, prefix: Tuple[str, ...] = ()):
    """(path, leaf) pairs of a nested dict in sorted-key order (the order
    ``jax.tree.flatten`` walks a dict)."""
    for key in sorted(tree):
        val = tree[key]
        if isinstance(val, dict):
            yield from tree_leaves(val, prefix + (key,))
        else:
            yield prefix + (key,), val


def tree_map(fn, tree: Tree) -> Tree:
    """Apply ``fn`` to every leaf of a nested dict."""
    return {k: tree_map(fn, v) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


def init_tree(defs: Tree, generator: torch.Generator, dtype,
              device=None) -> Tree:
    """Materialize a ParamDef tree into tensors, drawing every "normal" /
    "embed" leaf from ``generator`` in sorted-key order (the recipes of
    the reference's ``init_tree``; the numbers differ from jax.random's).
    """
    out: Tree = {}
    for path, d in tree_leaves(defs):
        if d.init == "zeros":
            a = torch.zeros(d.shape, dtype=dtype, device=device)
        elif d.init == "ones":
            a = torch.ones(d.shape, dtype=dtype, device=device)
        else:
            if d.init == "embed":
                # T5-style: std 1/sqrt(d_model) with a sqrt(d_model)-scaled
                # lookup, so the residual stream starts at rms ~1
                std = d.scale / math.sqrt(max(1, d.shape[-1]))
            else:
                fan_in = d.fan_in or (d.shape[-2] if len(d.shape) >= 2
                                      else d.shape[-1])
                std = d.scale / math.sqrt(max(1, fan_in))
            a = (torch.randn(d.shape, generator=generator, device=device,
                             dtype=torch.float32) * std).to(dtype)
        node = out
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = a
    return out


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def rmsnorm(x, gamma, eps=1e-6):
    """RMSNorm in f32 accumulation, cast back to x.dtype."""
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps)).to(x.dtype) * gamma


def layernorm(x, gamma, beta, eps=1e-5):
    """LayerNorm in f32 accumulation, cast back to x.dtype."""
    x32 = x.float()
    mu = torch.mean(x32, dim=-1, keepdim=True)
    var = torch.var(x32, dim=-1, keepdim=True, unbiased=False)
    out = ((x32 - mu) * torch.rsqrt(var + eps)).to(x.dtype) * gamma
    return out + beta if beta is not None else out


def norm_defs(cfg) -> Tree:
    """ParamDefs for the config's norm flavor."""
    if cfg.norm == "layernorm":
        return {"gamma": ParamDef((cfg.d_model,), (None,), "ones"),
                "beta": ParamDef((cfg.d_model,), (None,), "zeros")}
    return {"gamma": ParamDef((cfg.d_model,), (None,), "ones")}


def apply_norm(cfg, p: Tree, x):
    """Apply the config's norm flavor with params ``p``."""
    if cfg.norm == "layernorm":
        return layernorm(x, p["gamma"], p["beta"])
    return rmsnorm(x, p["gamma"])
