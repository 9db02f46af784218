"""AdamW with a cosine schedule and global-norm clipping (port of
``repro/optim/adamw.py``).

The moments are float32 trees shaped like the parameters; ``count`` is a
0-d int32 tensor on the host, so the schedule and the bias corrections
are formed there without waiting for the device.  The reference's ZeRO-1
note (moments sharded over the data axis) has no counterpart yet: the
port trains on one device.

:func:`adamw_update` updates the parameters and moments in place under
``torch.no_grad()`` (the reference donates them, ``donate_argnums``), a
leaf at a time in the order of ``jax.tree.flatten`` (dict keys sorted),
and a large leaf in runs of leading-axis rows (a layer of a stacked
leaf), so the float32 temporaries never exceed one run.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict

import torch

from ..models.common import Tree, tree_leaves, tree_map

#: leaves with more elements than this are updated in runs of whole
#: leading-axis rows of at most this many elements (at least one row); the
#: elementwise arithmetic is the same either way
SLICE_ELEMENTS = 1 << 24


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    """AdamW + cosine-schedule hyperparameters."""
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32)


def cosine_lr(cfg: AdamWConfig, step) -> float:
    """Warmup + cosine decay learning rate at ``step`` (an int or a host
    tensor), formed in float32 as the reference forms it."""
    step = _f32(float(step))
    warm = torch.clamp((step + 1) / max(1, cfg.warmup_steps), max=1.0)
    t = torch.clamp((step - cfg.warmup_steps)
                    / max(1, cfg.total_steps - cfg.warmup_steps), 0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * t))
    return float(cfg.lr * warm * (cfg.min_lr_frac
                                  + (1 - cfg.min_lr_frac) * cos))


def adamw_init(params: Tree) -> Dict[str, Any]:
    """Fresh float32 (m, v) trees matching ``params`` and a zero count."""
    def zeros32(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    return {"m": tree_map(zeros32, params), "v": tree_map(zeros32, params),
            "count": torch.zeros((), dtype=torch.int32)}


def _slices(t: torch.Tensor):
    """``t`` whole, or runs of its leading-axis rows when it is large."""
    if t.dim() >= 2 and t.numel() > SLICE_ELEMENTS:
        rows = max(1, SLICE_ELEMENTS // (t.numel() // t.shape[0]))
        return list(torch.split(t, rows))
    return [t]


def global_norm(grads: Tree) -> torch.Tensor:
    """sqrt of the sum of every leaf's float32 squares, summed leaf by
    leaf in flatten order (a 0-d float32 tensor on the leaves' device)."""
    total = None
    for _path, g in tree_leaves(grads):
        s = sum(torch.sum(torch.square(x.float())) for x in _slices(g))
        total = s if total is None else total + s
    return torch.sqrt(total)


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, grads: Tree, opt_state: Dict[str, Any],
                 params: Tree):
    """One AdamW step.  Returns ``(params, opt_state, grad_norm)``; the
    parameter and moment tensors are updated in place and returned."""
    count = opt_state["count"] + 1
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9),
                        max=1.0)
    lr = cosine_lr(cfg, opt_state["count"])
    c32 = _f32(float(count))
    b1c = float(1 - _f32(cfg.b1) ** c32)
    b2c = float(1 - _f32(cfg.b2) ** c32)

    flat_g = dict(tree_leaves(grads))
    flat_m = dict(tree_leaves(opt_state["m"]))
    flat_v = dict(tree_leaves(opt_state["v"]))
    for path, p in tree_leaves(params):
        for ps, gs, ms, vs in zip(_slices(p), _slices(flat_g[path]),
                                  _slices(flat_m[path]),
                                  _slices(flat_v[path])):
            g32 = gs.float() * scale
            ms.mul_(cfg.b1).add_((1 - cfg.b1) * g32)
            vs.mul_(cfg.b2).add_((1 - cfg.b2) * g32 * g32)
            del g32
            p32 = ps.float()
            step = (ms / b1c) / (torch.sqrt(vs / b2c) + cfg.eps) \
                + cfg.weight_decay * p32
            ps.copy_(p32 - lr * step)
    return params, dict(opt_state, count=count), gnorm
