"""AdamW with a cosine schedule and global-norm clipping (port of
``repro/optim/adamw.py``).

The moments are float32 trees shaped like the parameters; ``count`` is a
0-d int32 tensor on the host, so the schedule and the bias corrections
are formed there without waiting for the device.

Under a mesh (``mesh=`` and ``specs=``, ``launch/steps.py``) every tree
holds the rank's shards: the parameters and gradients laid out by the
parameter specs, the moments by the ZeRO-1 specs, which need not refine
the parameters' (``fix_spec_for_shape`` may move the tensor axis to
another dimension).  :func:`global_norm` counts a shard replicated over
ranks once and sums over the mesh; the update runs where the moment's
shard lives: the parameter and gradient are brought to the moment's
layout over the dimensions where the two layouts differ, updated, and
the parameter is written back into its own layout.

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


def global_norm(grads: Tree, mesh=None, specs: Tree = None) -> torch.Tensor:
    """sqrt of the sum of every leaf's float32 squares, summed leaf by
    leaf in flatten order (a 0-d float32 tensor on the leaves' device).
    Under a mesh ``grads`` are the rank's shards laid out by ``specs``: a
    shard that ranks along some axes replicate is counted by the rank at
    coordinate 0 along them only, and the sum is taken over the mesh."""
    total = None
    flat_specs = dict(tree_leaves(specs)) if mesh is not None else {}
    for path, g in tree_leaves(grads):
        if mesh is not None and not _counts_here(mesh, flat_specs[path]):
            continue
        s = sum(torch.sum(torch.square(x.float())) for x in _slices(g))
        total = s if total is None else total + s
    if mesh is not None:
        if total is None:
            total = torch.zeros((), dtype=torch.float32, device=mesh.device)
        total = mesh.all_reduce(total)
    return torch.sqrt(total)


def _counts_here(mesh, spec) -> bool:
    """True where this rank is at coordinate 0 of every axis that does not
    shard a leaf laid out by ``spec``."""
    used = set()
    for entry in spec:
        if entry is not None:
            used.update(entry if isinstance(entry, tuple) else (entry,))
    c = mesh.coords
    return all(c[a] == 0 for a in mesh.axis_names if a not in used)


def _relayout(mesh, t: torch.Tensor, src, dst, dims) -> torch.Tensor:
    """``t``, laid out by ``src`` on the dimensions ``dims``, laid out by
    ``dst`` there instead: gathered over ``src``'s axes on those
    dimensions, then cut by ``dst``'s."""
    keep = [None] * t.dim()
    for d in dims:
        keep[d] = src[d]
    t = mesh.gather(t, tuple(keep))
    keep = [None] * t.dim()
    for d in dims:
        keep[d] = dst[d]
    return mesh.cut(t, tuple(keep))


def _runs(t: torch.Tensor, rows: int):
    return list(torch.split(t, rows)) if rows else [t]


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, grads: Tree, opt_state: Dict[str, Any],
                 params: Tree, *, mesh=None, specs=None):
    """One AdamW step.  Returns ``(params, opt_state, grad_norm)``; the
    parameter and moment tensors are updated in place and returned.
    Under a mesh (``mesh`` bound to ranks, ``specs`` the (parameter,
    moment) spec trees of ``launch.steps.param_and_opt_specs``) the trees
    hold the rank's shards."""
    if mesh is not None and mesh.comm is not None:
        return _sharded_update(cfg, grads, opt_state, params, mesh, specs)
    count, lr, b1c, b2c = _schedule(cfg, opt_state)
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9),
                        max=1.0)

    flat_g = dict(tree_leaves(grads))
    flat_m = dict(tree_leaves(opt_state["m"]))
    flat_v = dict(tree_leaves(opt_state["v"]))
    for path, p in tree_leaves(params):
        for ps, gs, ms, vs in zip(_slices(p), _slices(flat_g[path]),
                                  _slices(flat_m[path]),
                                  _slices(flat_v[path])):
            ps.copy_(_step(cfg, ps, gs, ms, vs, scale, lr, b1c, b2c))
    return params, dict(opt_state, count=count), gnorm


def _step(cfg: AdamWConfig, p, g, m, v, scale, lr: float, b1c: float,
          b2c: float) -> torch.Tensor:
    """One run's update: the moments ``m`` / ``v`` in place, and the new
    parameter values in float32."""
    g32 = g.float() * scale
    m.mul_(cfg.b1).add_((1 - cfg.b1) * g32)
    v.mul_(cfg.b2).add_((1 - cfg.b2) * g32 * g32)
    del g32
    p32 = p.float()
    step = (m / b1c) / (torch.sqrt(v / b2c) + cfg.eps) \
        + cfg.weight_decay * p32
    return p32 - lr * step


def _schedule(cfg: AdamWConfig, opt_state):
    count = opt_state["count"] + 1
    lr = cosine_lr(cfg, opt_state["count"])
    c32 = _f32(float(count))
    return (count, lr, float(1 - _f32(cfg.b1) ** c32),
            float(1 - _f32(cfg.b2) ** c32))


def _sharded_update(cfg, grads, opt_state, params, mesh, specs):
    """:func:`adamw_update` on the rank's shards (see the module
    docstring); one leaf at a time, a large one in runs of its leading
    axis where that axis is whole in both layouts."""
    p_specs, o_specs = specs
    count, lr, b1c, b2c = _schedule(cfg, opt_state)
    gnorm = global_norm(grads, mesh, p_specs)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9),
                        max=1.0)
    flat_g = dict(tree_leaves(grads))
    flat_m = dict(tree_leaves(opt_state["m"]))
    flat_v = dict(tree_leaves(opt_state["v"]))
    flat_ps = dict(tree_leaves(p_specs))
    flat_os = dict(tree_leaves(o_specs["m"]))
    for path, p in tree_leaves(params):
        ps = tuple(flat_ps[path]) + (None,) * (p.dim() - len(flat_ps[path]))
        os_ = tuple(flat_os[path]) + (None,) * (p.dim() - len(flat_os[path]))
        dims = [d for d in range(p.dim()) if ps[d] != os_[d]]
        rows = 0
        if p.dim() >= 2 and p.numel() > SLICE_ELEMENTS and 0 not in dims \
                and ps[0] is None:
            rows = max(1, SLICE_ELEMENTS // (p.numel() // p.shape[0]))
        for pr, gr, mr, vr in zip(_runs(p, rows), _runs(flat_g[path], rows),
                                  _runs(flat_m[path], rows),
                                  _runs(flat_v[path], rows)):
            pm = _relayout(mesh, pr, ps, os_, dims) if dims else pr
            gm = _relayout(mesh, gr, ps, os_, dims) if dims else gr
            new = _step(cfg, pm, gm, mr, vr, scale, lr, b1c, b2c).to(p.dtype)
            pr.copy_(_relayout(mesh, new, os_, ps, dims) if dims else new)
    return params, dict(opt_state, count=count), gnorm
