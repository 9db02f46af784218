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

Under a mesh of ranks (``mesh=``, ``launch.mesh.make_mesh`` bound to a
``core.comm.DistributedComm``, ROADMAP A.15c-d) the train and prefill
steps take and return the rank's shards: the parameters laid out by
:func:`param_and_opt_specs`' parameter specs, the AdamW moments by its
ZeRO-1 specs and the batch by :func:`batch_specs` (:func:`shard_batch`
cuts it).  They compute what the reference's ``jax.jit`` of the same step
with those ``in_shardings`` computes (``repro/launch/dryrun.py``
``_jit_for_cell`` of ``prepare_config``, which sets ``seq_shard``), and
partition the compute on "model" as that program does: the models get
the mesh's data-parallel group (``comm=``) and its "model" group
(``tp=``, ``Mesh.tp``); between blocks a rank holds its ``1 / model`` of
the sequence, ``[B / dp, T / model, d]``, and inside a block it gathers
the sequence and computes its own heads, MLP columns, experts and
vocabulary slice (``models/*``).  Each parameter reaches the models as a
:class:`StoredLeaf`, materialized where it is used
(``models.common.gathered``: a layer's parameters inside the layer, so
under remat the recompute gathers again) as :func:`tp_plan` says: a
``"split"`` leaf gathered over its dp (fsdp) axes only, a ``"gathered"``
or ``"replicated"`` one whole.  The gather's backward
(``Mesh.reduce_grad``) sums the gradient over the ranks that computed
parts of it into a float32 sink holding the rank's shard; the leaves no
spec shards are summed over the mesh once a step, in one buffer
(``Mesh.sum_flat``).

The decode step on a mesh (:func:`build_serve_step` with ``mesh=``, ROADMAP
A.15d(2)) computes what the reference's ``_jit_for_cell`` of a decode cell
computes: ``serve_step`` with the parameters laid out by their specs, the
state by :func:`decode_state_specs` (:func:`shard_decode_state` cuts a
whole one) and the tokens' rows over the dp axes.  At T = 1 the residual
stream is whole on every "model" rank, ``[B / dp (or B), 1, d]``
(``Mesh.tp_decode``): each block computes the rank's heads, columns or
experts and sums its partial output over "model"; the logits are the
rank's rows over the whole vocabulary.  The KV cache ``[n_sup, B, S, KV,
hd]`` is laid out by :func:`_cache_spec` one of three ways, each a branch
of ``models.attention.decode_attention``: B over the dp axes with the K /
V heads over "model" (the rank's query heads read its own K / V heads),
S over the dp axes where B does not divide (each rank attends over its
slots and the partial softmaxes are merged over the dp group), and
head_dim over "model" where the K / V heads do not divide (partial scores
summed over "model").  No cache is gathered.  A Mamba2 layer's ``ssm``
carry is cut by heads and its ``conv`` carry by channels
(``models/ssm.py``).  The state's shards are updated in place.
"""

from __future__ import annotations

import functools
import types
from typing import Any, Dict, Optional, Tuple

import torch

from ..configs.registry import Shape
from ..models import lm, whisper
from ..models.common import Tree, init_tree, tree_leaves, tree_map
from ..models.config import ModelConfig
from ..optim import AdamWConfig, adamw_init, adamw_update
from .mesh import TP_AXIS, Mesh, Spec, axis_size, dp_axes, fix_spec_tree, \
    leaf_plan, resolve_spec_tree, shard_tree

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
                     accum: int = 1, mesh: Optional[Mesh] = None):
    """One optimizer step; ``accum`` > 1 accumulates the gradients of
    that many microbatches (the batch's rows split in order) in float32
    buffers, ``gacc + g.float() / accum``, the loss the same way, and
    averages the metrics over them, as the reference's ``scan`` does.
    The parameters and optimizer state are updated in place (the
    reference donates them) and returned.  With a ``mesh`` of ranks the
    step takes and returns the rank's shards (module docstring)."""
    if _ranked(mesh):
        return _sharded_train_step(cfg, opt_cfg, accum, mesh)
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


def build_prefill_step(cfg: ModelConfig, *, mesh: Optional[Mesh] = None):
    """Returns last-position logits (the sampled-token distribution).
    With a ``mesh`` of ranks the step takes the rank's shards of the
    parameters and the batch, computes its rows and returns the global
    ``[B, V]`` on every rank."""
    if _ranked(mesh):
        return _sharded_prefill_step(cfg, mesh)
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
        return lm.last_logits(cfg, params, x)

    return prefill_step


# ---------------------------------------------------------------------------
# The steps on a mesh of ranks
# ---------------------------------------------------------------------------

def _ranked(mesh: Optional[Mesh]) -> bool:
    """A mesh bound to ranks (``make_mesh`` binds only more than one)."""
    return mesh is not None and mesh.comm is not None


class StoredLeaf:
    """A rank's shard of a tensor laid out by ``spec`` on ``mesh``, in
    the place of the full tensor in a tree the models read: ``value()``
    gives the tensor the layer computes with (``models.common.gathered``),
    as ``plan`` (:func:`launch.mesh.leaf_plan`) says: a ``"split"`` leaf
    gathered over its dp axes only (the rank's "model" shard), any other
    gathered whole.  With a ``sink`` (a parameter in a train step) the
    gather is :class:`_Gather`, whose backward hands ``sink`` the rank's
    float32 shard of the gradient summed over the ranks that computed
    parts of it (``deferred``: the gradient as it is, summed over the
    mesh by the step)."""

    def __init__(self, shard, spec, mesh: Mesh, plan: str, sink=None,
                 anchor=None, deferred: bool = False):
        self.shard, self.spec, self.mesh = shard, tuple(spec), mesh
        self.sink, self.anchor = sink, anchor
        self.plan, self.deferred = plan, deferred

    @property
    def device(self):
        """The device the tensor is gathered on."""
        return self.mesh.device

    @property
    def gather_spec(self) -> Spec:
        """The part of ``spec`` the value is gathered over."""
        if self.plan != "split":
            return self.spec
        return tuple(e if e is not None and self.mesh.is_dp(e) else None
                     for e in self.spec)

    def value(self) -> torch.Tensor:
        """The tensor the layers compute with."""
        if self.sink is not None and torch.is_grad_enabled():
            return _Gather.apply(self.anchor, self)
        shard = torch.as_tensor(self.shard, device=self.mesh.device)
        return self.mesh.gather(shard, self.gather_spec)


class _Gather(torch.autograd.Function):
    """Forward: :meth:`StoredLeaf.value`'s all-gather.  Backward:
    ``Mesh.reduce_grad`` of the gradient into the leaf's sink, or the
    gradient as it is for a ``deferred`` leaf (nothing flows to
    ``anchor``, the tensor that puts the gather on the graph)."""

    @staticmethod
    def forward(ctx, anchor, leaf):
        ctx.leaf = leaf
        return leaf.mesh.gather(leaf.shard, leaf.gather_spec).detach()

    @staticmethod
    def backward(ctx, g):
        leaf = ctx.leaf
        leaf.sink(g.float() if leaf.deferred
                  else leaf.mesh.reduce_grad(g, leaf.spec, leaf.plan))
        return None, None


def _layer_spec(path, spec) -> Spec:
    """A leaf's spec as one layer sees it (a stacked leaf's without its
    layer axis)."""
    return tuple(spec[1:]) if path[0] in STACKED else tuple(spec)


def tp_plan(cfg: ModelConfig, mesh: Mesh) -> Tree:
    """``launch.mesh.leaf_plan`` of every parameter under ``mesh`` (a
    stacked leaf's for one layer's view), from the specs of
    :func:`param_and_opt_specs`: no device, no allocation."""
    p_specs, _o = param_and_opt_specs(cfg, mesh)
    heads = cfg.ssm_heads if cfg.ssm_state else 0
    return _unflatten(p_specs, [
        leaf_plan(path, _layer_spec(path, spec), mesh, ssm_heads=heads)
        for path, spec in tree_leaves(p_specs)])


def _deferred(plan: str, spec: Spec) -> bool:
    """A leaf whose gradient the step sums over the whole mesh at its
    end: replicated over "model" and laid out over no axis."""
    return plan == "replicated" and all(e is None for e in spec)


def _shard_shapes(cfg: ModelConfig, spec_tree: Tree, mesh: Mesh) -> dict:
    """Parameter path -> the shape of the rank's shard laid out by
    ``spec_tree`` (from the shapes of ``model_defs``: nothing is made)."""
    specs = dict(tree_leaves(spec_tree))
    return {path: mesh.shard_shape(tuple(d.shape), specs[path])
            for path, d in tree_leaves(model_module(cfg).model_defs(cfg))}


def _check_shards(cfg: ModelConfig, params: Tree, p_specs: Tree,
                  mesh: Mesh) -> None:
    """Every parameter is the rank's shard of its spec's layout."""
    for path, spec in tree_leaves(p_specs):
        if path[0] in STACKED and spec and spec[0] is not None:
            raise NotImplementedError(
                f"{'/'.join(path)}: the layer axis is sharded ({spec})")
    for path, want in _shard_shapes(cfg, p_specs, mesh).items():
        got = tuple(_find(params, path).shape)
        if got != want:
            raise ValueError(f"{'/'.join(path)}: a shard of {got}, its "
                             f"layout gives {want}")


def _find(tree: Tree, path):
    for key in path:
        tree = tree[key]
    return tree


def _store(params: Tree, p_specs: Tree, plans: Tree, mesh: Mesh,
           grads=None, anchor=None, accum: int = 1) -> Tree:
    """The tree the models read under a mesh: a :class:`StoredLeaf` for
    every parameter (a list of them, one a layer, for a stacked leaf),
    used as ``plans`` say, whose gradient shards are added, over
    ``accum``, into ``grads``."""
    specs = dict(tree_leaves(p_specs))
    flat_plans = dict(tree_leaves(plans))

    def sink(acc):
        if acc is None:
            return None
        if accum == 1:
            return acc.add_
        return lambda g: acc.add_(g / accum)

    def leaf(path, t):
        spec, plan = _layer_spec(path, specs[path]), flat_plans[path]
        acc = None if grads is None else _find(grads, path)
        deferred = _deferred(plan, spec)
        if path[0] not in STACKED:
            return StoredLeaf(t, spec, mesh, plan, sink(acc), anchor,
                              deferred)
        return [StoredLeaf(t[i], spec, mesh, plan,
                           sink(None if acc is None else acc[i]), anchor,
                           deferred)
                for i in range(t.shape[0])]
    return _unflatten(params, [leaf(path, t)
                               for path, t in tree_leaves(params)])


def _sum_replicated(grads: Tree, p_specs: Tree, plans: Tree,
                    mesh: Mesh) -> None:
    """The gradients of the leaves replicated over "model", summed over
    the ranks in two buffers: those no spec shards over the whole mesh
    (their dp sums too), the others over "model" (``reduce_grad`` took
    their dp sums)."""
    flat_plans = dict(tree_leaves(plans))
    whole, model = [], []
    for path, spec in tree_leaves(p_specs):
        plan = flat_plans[path]
        if plan != "replicated":
            continue
        g = _find(grads, path)
        (whole if _deferred(plan, _layer_spec(path, spec)) else
         model).append(g)
    mesh.sum_flat(whole, mesh.axis_names)
    mesh.sum_flat(model, (TP_AXIS,))


def _rows(batch: Dict[str, Any], mesh: Mesh) -> Dict[str, torch.Tensor]:
    """The rank's rows of a :func:`shard_batch` batch on its device, each
    leaf sharded beyond its rows gathered; where "model" computes in
    parallel, audio frames stay the rank's part of the sequence (the
    models' layout between blocks; a length the "model" extent does not
    divide raises)."""
    tp = mesh.tp
    out = {}
    for k, v in batch.items():
        if k == "frames" and tp is not None:
            out[k] = torch.as_tensor(v.shard, device=mesh.device) \
                if isinstance(v, StoredLeaf) and v.spec[1] == TP_AXIS \
                else tp.own(torch.as_tensor(v, device=mesh.device))
        elif isinstance(v, StoredLeaf):
            out[k] = v.value()
        else:
            out[k] = torch.as_tensor(v, device=mesh.device)
    return out


def shard_batch(cfg: ModelConfig, batch: Dict[str, Any], mesh: Mesh):
    """The rank's shard of a global batch (numpy arrays or tensors) laid
    out by :func:`batch_specs`, cut on the host: its rows, and, for a leaf
    also sharded along another dimension (whisper's frames over "model"
    along time), a :class:`StoredLeaf` the step gathers.  A batch whose
    rows do not divide by the dp extent raises."""
    tokens = batch["tokens"]
    B = tokens.shape[0]
    if cfg.frontend == "audio_frames":
        T = batch["frames"].shape[1]
    else:
        T = tokens.shape[1] + (batch["vision_embeds"].shape[1]
                               if "vision_embeds" in batch else 0)
    _meta, specs = batch_specs(
        cfg, types.SimpleNamespace(global_batch=B, seq_len=T), mesh,
        with_labels="labels" in batch)
    dp_size, _i = mesh.index(dp_axes(mesh))
    if dp_size > 1 and specs["tokens"][0] is None:
        raise ValueError(f"a batch of {B} rows does not divide by the "
                         f"{dp_size} data-parallel ranks")
    out: Dict[str, Any] = {}
    for k, v in batch.items():
        spec = specs[k]
        shard = mesh.cut(v, spec)
        rest = (None,) + tuple(spec[1:])
        out[k] = StoredLeaf(shard, rest, mesh, "gathered") \
            if any(e is not None for e in rest) else shard
    return out


def shard_state(cfg: ModelConfig, params: Tree, mesh: Mesh):
    """(the rank's parameter shards, fresh AdamW state on its moment
    shards) from full parameters (on any device): the parameters cut by
    :func:`param_and_opt_specs`' parameter specs, the float32 zero
    moments made at their ZeRO-1 shard shapes on the mesh's device."""
    p_specs, o_specs = param_and_opt_specs(cfg, mesh)
    shapes = _shard_shapes(cfg, o_specs["m"], mesh)

    def zeros():
        return _unflatten(o_specs["m"], [
            torch.zeros(shapes[path], dtype=torch.float32,
                        device=mesh.device)
            for path, _spec in tree_leaves(o_specs["m"])])
    return shard_tree(params, p_specs, mesh), {
        "m": zeros(), "v": zeros(), "count": adamw_init({})["count"]}


def _sharded_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig, accum: int,
                        mesh: Mesh):
    mod = model_module(cfg)
    p_specs, o_specs = param_and_opt_specs(cfg, mesh)
    plans = tp_plan(cfg, mesh)
    dp, tp = mesh.dp, mesh.tp

    def microbatches(batch):
        rows = _rows(batch, mesh)
        if accum == 1:
            return [rows]
        b = rows["tokens"].shape[0]
        B = b * dp.size
        if B % accum or (B // accum) % dp.size:
            raise ValueError(f"a global batch of {B} rows does not split "
                             f"into {accum} microbatches of a multiple of "
                             f"{dp.size} rows")
        mb, share = B // accum, B // accum // dp.size
        every = {k: dp.gather(v).reshape(B, *v.shape[1:])
                 for k, v in rows.items()}
        lo = dp.index * share
        return [{k: v[i * mb + lo:i * mb + lo + share]
                 for k, v in every.items()} for i in range(accum)]

    def train_step(params, opt_state, batch):
        _check_shards(cfg, params, p_specs, mesh)
        grads = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                               device=p.device), params)
        anchor = torch.zeros((), device=mesh.device, requires_grad=True)
        store = _store(params, p_specs, plans, mesh, grads, anchor, accum)
        loss, metrics_all = None, []
        for part in microbatches(batch):
            l_i, m_i = mod.loss_fn(cfg, store, part, comm=dp, tp=tp)
            torch.autograd.backward(l_i)
            m_i = {k: v.detach() for k, v in m_i.items()}
            g_loss = m_i.pop("loss")
            loss = g_loss if accum == 1 else (
                g_loss / accum if loss is None else loss + g_loss / accum)
            metrics_all.append(m_i)
        del store, anchor
        _sum_replicated(grads, p_specs, plans, mesh)
        metrics = metrics_all[0] if accum == 1 else {
            k: torch.stack([m[k] for m in metrics_all]).mean()
            for k in metrics_all[0]}
        params, opt_state, gnorm = adamw_update(
            opt_cfg, grads, opt_state, params, mesh=mesh,
            specs=(p_specs, o_specs))
        return params, opt_state, dict(metrics, loss=loss, grad_norm=gnorm)

    return train_step


def _sharded_prefill_step(cfg: ModelConfig, mesh: Mesh):
    p_specs, _o = param_and_opt_specs(cfg, mesh)
    plans = tp_plan(cfg, mesh)
    dp, tp = mesh.dp, mesh.tp

    @torch.inference_mode()
    def prefill_step(params, batch):
        _check_shards(cfg, params, p_specs, mesh)
        store = _store(params, p_specs, plans, mesh)
        rows = _rows(batch, mesh)
        if cfg.encdec:
            memory = whisper.encode(cfg, store, rows["frames"], tp=tp)
            x = whisper.decode_hidden(cfg, store, rows["tokens"], memory,
                                      tp=tp)
        else:
            x, _aux = lm.forward_hidden(cfg, store, rows, comm=dp, tp=tp)
        every = dp.gather(lm.last_logits(cfg, store, x, tp=tp))
        return every.reshape(every.shape[0] * every.shape[1],
                             *every.shape[2:])

    return prefill_step


def build_serve_step(cfg: ModelConfig, *, mesh: Optional[Mesh] = None):
    """One-token decode step closure over the model family.  With a
    ``mesh`` of ranks the step takes the rank's parameter shards, its
    :func:`shard_decode_state` state and its token rows, updates the
    state's shards in place and returns the logits of its rows over the
    whole vocabulary (module docstring)."""
    if _ranked(mesh):
        return _sharded_serve_step(cfg, mesh)
    mod = model_module(cfg)

    def serve_step(params, state, tokens):
        return mod.decode_step(cfg, params, state, tokens)

    return serve_step


def decode_shape(batch: int, seq_len: int) -> Shape:
    """A decode cell's shape: ``batch`` sequences and a cache of
    ``seq_len`` positions (the encoder memory's length for an
    encoder-decoder)."""
    return Shape("decode", "decode", int(seq_len), int(batch))


def batch_split(shape, mesh: Mesh) -> bool:
    """Whether a decode cell's batch is cut over the dp axes (else every dp
    rank holds all of it, and the cache's slots are cut instead)."""
    return _ax_if_div(shape.global_batch, dp_axes(mesh), mesh) is not None


def shard_decode_state(cfg: ModelConfig, state: Tree, shape, mesh: Mesh):
    """The rank's shard of a whole decode state (the family's
    ``init_decode_state`` at the cell's batch and length) laid out by
    :func:`decode_state_specs` for ``shape``: each carry cut, then a
    contiguous copy on the mesh's device.  ``pos`` is kept, and ``cell``
    records (batch, seq_len) for the step."""
    specs, _shapes = _decode_layout(cfg, (shape.global_batch,
                                          shape.seq_len), mesh)
    tensors = {k: v for k, v in state.items() if k not in ("pos", "cell")}
    out = shard_tree(tensors, {k: specs[k] for k in tensors}, mesh)
    out["pos"] = int(state["pos"])
    out["cell"] = (shape.global_batch, shape.seq_len)
    return out


def decode_rows(cfg: ModelConfig, tokens, shape, mesh: Mesh):
    """The rank's rows of a decode cell's global tokens [B, 1] (all of
    them where the batch is not cut)."""
    return mesh.cut(tokens, decode_state_specs(cfg, shape, mesh)[3])


@functools.lru_cache(maxsize=None)
def _layout(cfg: ModelConfig, cell: Tuple[int, int], names, sizes):
    meta, specs, _t, _ts = decode_state_specs(cfg, decode_shape(*cell),
                                              Mesh(names, sizes))
    flat = dict(tree_leaves(specs))
    return specs, {path: Mesh(names, sizes).shard_shape(tuple(t.shape),
                                                        flat[path])
                   for path, t in tree_leaves(meta) if path != ("pos",)}


def _decode_layout(cfg: ModelConfig, cell: Tuple[int, int], mesh: Mesh):
    """(spec tree, path -> shard shape) of a decode state at ``cell``
    (batch, length) on ``mesh``'s layout, made once per process (the
    shapes do not depend on the rank)."""
    return _layout(cfg, tuple(cell), mesh.axis_names, mesh.axis_sizes)


def _check_state(cfg: ModelConfig, state: Tree, mesh: Mesh) -> None:
    """Every carry of ``state`` is the rank's shard of its spec's layout
    at the cell's batch and length."""
    cell = state.get("cell")
    if cell is None:
        raise ValueError("a mesh decode step takes a shard_decode_state "
                         "state (its 'cell' entry is missing)")
    for path, shape in _decode_layout(cfg, cell, mesh)[1].items():
        got = tuple(_find(state, path).shape)
        if got != shape:
            raise ValueError(f"state/{'/'.join(path)}: a shard of {got}, "
                             f"its layout gives {shape}")


def _sharded_serve_step(cfg: ModelConfig, mesh: Mesh):
    mod = model_module(cfg)
    p_specs, _o = param_and_opt_specs(cfg, mesh)
    plans = tp_plan(cfg, mesh)
    dp, tp = mesh.dp, mesh.tp_decode

    @torch.inference_mode()
    def serve_step(params, state, tokens):
        _check_shards(cfg, params, p_specs, mesh)
        _check_state(cfg, state, mesh)
        split = batch_split(decode_shape(*state["cell"]), mesh)
        store = _store(params, p_specs, plans, mesh)
        tokens = torch.as_tensor(tokens, device=mesh.device)
        return mod.decode_step(cfg, store, state, tokens,
                               comm=dp if split else None,
                               seq=None if split else dp, tp=tp)

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
