"""Shared building blocks: ParamDef tables, norms, positions, MLPs (port
of ``repro/models/common.py``).

Sharding placeholders in ParamDef specs are kept as data ("T" the tensor
axis, "F" the fsdp axis, None replicated); ``launch/mesh.py`` resolves
them against a mesh record.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

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


def spec_tree(defs: Tree) -> Tree:
    """The placeholder spec tree (same structure as the parameters)."""
    return tree_map(lambda d: d.spec, defs)


def tree_from_numpy(defs: Tree, tree: Tree, dtype, device=None) -> Tree:
    """Tensors of ``dtype`` on ``device`` from a nested dict of numpy
    arrays (the reference's parameters), checked against the ParamDef tree
    ``defs`` key for key and shape for shape."""
    want = dict(tree_leaves(defs))
    got = dict(tree_leaves(tree))
    if set(want) != set(got):
        raise ValueError(f"parameter trees differ: missing "
                         f"{sorted(set(want) - set(got))}, unexpected "
                         f"{sorted(set(got) - set(want))}")
    out: Tree = {}
    for path, d in want.items():
        a = np.array(got[path], dtype=np.float32)
        if a.shape != tuple(d.shape):
            raise ValueError(f"{'/'.join(path)}: shape {a.shape}, expected "
                             f"{d.shape}")
        node = out
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = torch.as_tensor(a).to(device=device, dtype=dtype)
    return out


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


def gathered(tree):
    """``tree`` (a tensor or a dict of them) with every stored shard
    replaced by the tensor the layer computes with: under a mesh the train
    and prefill steps (``launch/steps.py``) hand the models the rank's
    shards as objects whose ``value()`` gathers them (a leaf split over
    "model" stays the rank's "model" shard), and the models call this
    where a parameter is used, so a layer's parameters live only while the
    layer runs.  Tensors pass as they are."""
    if isinstance(tree, dict):
        return {k: gathered(v) for k, v in tree.items()}
    return tree if isinstance(tree, torch.Tensor) else tree.value()


def is_split(t, full: int, dim: int, tp) -> bool:
    """True where a layer under ``tp`` got the rank's "model" shard of a
    parameter (``launch.mesh.leaf_plan``'s "split": ``t.shape[dim]`` is
    the config's ``full`` over the "model" extent), False where it got
    the whole tensor or runs without ``tp``.  Any other width raises."""
    if tp is None or t.shape[dim] == full:
        return False
    if t.shape[dim] * tp.size != full:
        raise ValueError(
            f"a parameter of shape {tuple(t.shape)} is neither whole ({full}"
            f" along dim {dim}) nor a rank's 1/{tp.size} of it")
    return True


def embed_tokens(cfg, params: Tree, tokens, tp=None):
    """Token ids [B, T] -> ``params["embed"]`` rows * sqrt(d_model), in
    the config's dtype, on the embedding's device.  With ``tp`` (the
    "model" group of a mesh, ``launch.mesh.TensorParallel``) the rank's
    part of the sequence, ``[B, T / model, d]``: a vocabulary-split
    embedding looks every token up in the rank's slice (other ids give
    zero rows) and the ranks' sums are reduce-scattered along T; a whole
    one looks up the rank's tokens."""
    embed = gathered(params["embed"])
    tokens = torch.as_tensor(tokens, device=embed.device).long()
    if not is_split(embed, cfg.vocab_size, 0, tp):
        if tp is not None:
            tokens = tp.own(tokens)
        return (embed[tokens] * math.sqrt(cfg.d_model)).to(cfg.dtype)
    return tp.scatter_seq(embed_partial(cfg, embed, tokens, tp))


def embed_partial(cfg, embed_local, tokens, tp):
    """[B, T, d]: the rows of the ids in the rank's vocabulary slice of
    ``embed_local`` * sqrt(d_model), zero elsewhere (one rank's term of
    the lookup)."""
    n = embed_local.shape[0]
    local = tokens - tp.index * n
    own = (local >= 0) & (local < n)
    rows = embed_local[local.clamp(0, n - 1)] * own[..., None]
    return (rows * math.sqrt(cfg.d_model)).to(cfg.dtype)


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


# ---------------------------------------------------------------------------
# Positions: RoPE / M-RoPE / sinusoidal
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float) -> np.ndarray:
    """RoPE inverse frequencies for ``head_dim`` (numpy, host-side)."""
    return 1.0 / (theta ** (np.arange(0, head_dim, 2) / head_dim))


def _rotate(x, ang):
    """Rotate the two halves of x [..., seq, heads, hd] by the float32
    angles [..., seq, hd/2], in float32; cast back to x's dtype."""
    cos = torch.cos(ang)[..., None, :]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def _freqs(hd: int, theta: float, device) -> torch.Tensor:
    """:func:`rope_freqs` in float64 on ``device``, then float32 (formed
    there: a copy from the host would wait for the device each layer)."""
    i = torch.arange(0, hd, 2, dtype=torch.float64, device=device)
    return (1.0 / (theta ** (i / hd))).float()


def apply_rope(x, positions, theta: float):
    """x: [..., seq, heads, head_dim]; positions: [..., seq] integers.  The
    angles are formed in float32, as the reference forms them."""
    freqs = _freqs(x.shape[-1], theta, x.device)               # [hd/2]
    return _rotate(x, positions[..., :, None].float() * freqs)


def apply_mrope(x, positions3, theta: float, sections: Tuple[int, int, int]):
    """M-RoPE (qwen2-vl): rotary over 3 position streams (t, h, w).

    positions3: [..., seq, 3].  Each frequency slot is assigned to one of
    the three sections; text tokens use identical t = h = w positions,
    which makes M-RoPE degenerate to 1-D RoPE exactly.
    """
    hd = x.shape[-1]
    sec = np.asarray(sections, np.int64)
    if sec.sum() != hd // 2:
        raise ValueError(f"M-RoPE sections {tuple(sections)} do not sum to "
                         f"head_dim / 2 = {hd // 2}")
    # frequency slot -> section id
    sid = torch.as_tensor(np.repeat(np.arange(len(sec)), sec),
                          device=x.device)
    pos = positions3.float()[..., sid]                        # [..., seq, hd/2]
    return _rotate(x, pos * _freqs(hd, theta, x.device))


def sincos_positions(seq: int, d_model: int) -> np.ndarray:
    """Whisper-style fixed sinusoidal embeddings [seq, d_model]."""
    pos = np.arange(seq)[:, None]
    i = np.arange(d_model // 2)[None, :]
    ang = pos / (10_000 ** (2 * i / d_model))
    return np.concatenate([np.sin(ang), np.cos(ang)], axis=-1).astype(np.float32)


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------

def mlp_defs(cfg, d_ff: Optional[int] = None) -> Tree:
    """MLP ParamDefs (swiglu or gelu layout per config)."""
    d, f = cfg.d_model, d_ff or cfg.d_ff
    if cfg.mlp == "swiglu":
        return {
            "wi": ParamDef((d, f), ("F", "T")),
            "wg": ParamDef((d, f), ("F", "T")),
            "wo": ParamDef((f, d), ("T", "F"), scale=cfg.out_scale),
        }
    return {
        "wi": ParamDef((d, f), ("F", "T")),
        "wo": ParamDef((f, d), ("T", "F"), scale=cfg.out_scale),
    }


def apply_mlp(cfg, p: Tree, x, tp=None):
    """Apply the config's MLP flavor with params ``p`` (gelu is the tanh
    approximation, ``jax.nn.gelu``'s default).  With ``tp`` and the rank's
    columns of ``wi`` / ``wg`` and rows of ``wo``, ``x`` (the rank's part
    of the sequence) is gathered along T and the partial products are
    reduce-scattered back; whole weights run on the rank's rows."""
    if not is_split(p["wi"], cfg.d_ff, 1, tp):
        return mlp_product(cfg, p, x)
    return tp.scatter_seq(mlp_product(cfg, p, tp.gather_seq(x)))


def mlp_product(cfg, p: Tree, x):
    """The MLP's products on ``x`` with the weights in ``p`` (whole, or a
    rank's columns / rows: then a partial sum)."""
    if cfg.mlp == "swiglu":
        h = F.silu(x @ p["wg"]) * (x @ p["wi"])
    else:
        h = F.gelu(x @ p["wi"], approximate="tanh")
    return h @ p["wo"]
