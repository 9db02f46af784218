"""Gradient compression codecs (port of ``repro/optim/compress.py``):
bf16 with stochastic rounding and per-block absmax int8.

At scale the gradients are reduce-scattered in full precision inside a
pod, compressed once, all-reduced across pods over the slow hop and
decompressed, cutting those bytes 2x (bf16) or 4x (int8).  Leaves are
tensors of a nested dict (keys sorted, as ``jax.tree.flatten`` walks
them).

Stochastic rounding draws from an explicit ``torch.Generator`` where the
reference takes a ``jax.random`` key, and rounds to one of the two bf16
neighbours of x (towards zero, or the next one away from it) with the
probability of its distance to the other, so the result is unbiased.
The reference's step is ``jnp.spacing`` of the float32 value, a float32
ulp, so its draw lands back on the nearest bf16 value; without a
generator both packages cast to bf16 (round to nearest even).
"""

from __future__ import annotations

from typing import Any, Optional

import torch

from ..models.common import Tree

_BLOCK = 256


def _map(fn, tree: Tree, is_leaf=lambda x: not isinstance(x, dict)):
    if is_leaf(tree):
        return fn(tree)
    return {k: _map(fn, v, is_leaf) for k, v in sorted(tree.items())}


def _stochastic_round_bf16(x: torch.Tensor,
                           generator: torch.Generator) -> torch.Tensor:
    """x rounded to a bf16 neighbour: 16 uniform random bits added to the
    low half of the float32 pattern, which is then cut off (a carry moves
    x to the next bf16 value away from zero with probability equal to the
    dropped fraction).  NaN stays NaN."""
    x32 = x.float().contiguous()
    r = torch.randint(0, 1 << 16, x32.shape, generator=generator,
                      device=generator.device, dtype=torch.int32)
    bits = (x32.view(torch.int32) + r.to(x32.device)) & -65536
    out = bits.view(torch.float32)
    return torch.where(torch.isnan(x32), x32, out).to(torch.bfloat16)


def compress_bf16(tree: Tree,
                  generator: Optional[torch.Generator] = None) -> Tree:
    """Cast a gradient tree to bf16 (stochastic rounding with a
    generator, whose draws go leaf by leaf in flatten order)."""
    if generator is None:
        return _map(lambda g: g.to(torch.bfloat16), tree)
    # _map walks the leaves in sorted-key order, so the draws follow it
    return _map(lambda g: _stochastic_round_bf16(g, generator), tree)


def _enc(g: torch.Tensor) -> dict:
    flat = g.float().reshape(-1)
    pad = (-flat.numel()) % _BLOCK
    blocks = torch.nn.functional.pad(flat, (0, pad)).reshape(-1, _BLOCK)
    scale = torch.amax(torch.abs(blocks), dim=1, keepdim=True) / 127.0
    codes = torch.clamp(torch.round(blocks / torch.clamp(scale, min=1e-12)),
                        -127, 127).to(torch.int8)
    return {"codes": codes, "scale": scale, "shape": tuple(g.shape)}


def compress_int8(tree: Tree) -> Tree:
    """Per-block absmax int8: each leaf -> {"codes" int8 [nb, 256],
    "scale" float32 [nb, 1], "shape"}."""
    return _map(_enc, tree)


def _dec(e: dict) -> torch.Tensor:
    flat = (e["codes"].float() * e["scale"]).reshape(-1)
    n = 1
    for s in e["shape"]:
        n *= s
    return flat[:n].reshape(e["shape"])


def decompress_int8(tree: Any) -> Tree:
    """Invert :func:`compress_int8`: rescale block codes back to f32."""
    return _map(_dec, tree,
                is_leaf=lambda x: not isinstance(x, dict) or "codes" in x)
