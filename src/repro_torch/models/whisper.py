"""Whisper-large-v3 backbone: encoder-decoder transformer (port of
``repro/models/whisper.py``).

The conv audio frontend is a stub, as in the reference: the caller gives
precomputed frame embeddings [B, T_enc, d_model] (post-conv).  Sinusoidal
positions on the encoder and the decoder (no RoPE).  The encoder's self
attention (full) and the decoder's (causal) are unwindowed, so
``attention.attention`` runs both through ``ops.flash_attention``: kernel
B9 on a CUDA tensor.  Cross-attention is the plain product the reference
uses.  The layers are walked in a plain loop; with ``cfg.remat`` and grad
enabled each layer is recomputed in the backward pass (the reference's
``jax.checkpoint`` per scanned layer).  :func:`loss_fn` trains it; the
cached decode runs under ``torch.inference_mode()``.

Under a mesh's "model" group (``tp``, ``launch.mesh.TensorParallel``)
the encoder's and the decoder's residual streams are the rank's part of
their sequences (the frames arrive so), the blocks compute the rank's
heads and MLP columns (``attention``, ``common.apply_mlp``), the memory is
gathered along its sequence once for every decoder layer's
cross-attention, and the loss is vocabulary-parallel
(``lm.sequence_ce``).
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from . import attention as attn
from .common import (ParamDef, Tree, apply_mlp, apply_norm, embed_tokens,
                     gathered, init_tree, mlp_defs, norm_defs,
                     sincos_positions, spec_tree, tree_from_numpy,
                     tree_leaves, tree_map)
from .config import ModelConfig
from .lm import (_global_loss, _unembed, decode_logits, remat_active,
                 sequence_ce)


def _enc_layer_defs(cfg) -> Tree:
    return {"norm1": norm_defs(cfg), "attn": attn.attn_defs(cfg),
            "norm2": norm_defs(cfg), "mlp": mlp_defs(cfg)}


def _dec_layer_defs(cfg) -> Tree:
    return {"norm1": norm_defs(cfg), "self_attn": attn.attn_defs(cfg),
            "norm2": norm_defs(cfg), "cross_attn": attn.attn_defs(cfg),
            "norm3": norm_defs(cfg), "mlp": mlp_defs(cfg)}


def _n_enc(cfg: ModelConfig) -> int:
    return cfg.n_enc_layers or cfg.n_layers


def model_defs(cfg: ModelConfig) -> Tree:
    """Encoder-decoder ParamDef tree (embed, enc/dec stacks, norms)."""
    def lead(defs, n):
        return tree_map(lambda pd: pd.with_leading(n), defs)
    return {
        "embed": ParamDef((cfg.vocab_size, cfg.d_model), ("T", "F"), "embed"),
        "enc_layers": lead(_enc_layer_defs(cfg), _n_enc(cfg)),
        "enc_norm": norm_defs(cfg),
        "dec_layers": lead(_dec_layer_defs(cfg), cfg.n_layers),
        "final_norm": norm_defs(cfg),
    }


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


def params_from_numpy(cfg: ModelConfig, tree: Tree, device=None) -> Tree:
    """The port's parameters from the reference's ``whisper.init_params``
    tree as numpy arrays, cast to ``cfg.dtype`` on ``device``; the tree
    must match :func:`model_defs` key for key and shape for shape."""
    return tree_from_numpy(model_defs(cfg), tree, cfg.dtype, device)


def _positions(B: int, T: int, device):
    return torch.arange(T, device=device).expand(B, T)


def _sincos(T: int, cfg: ModelConfig, device):
    return torch.as_tensor(sincos_positions(T, cfg.d_model),
                           device=device).to(cfg.dtype)


def _layers(cfg: ModelConfig, blk, layers: Tree, n: int, x, *args):
    """x through ``blk(cfg, p_i, x, *args)`` for the n stacked layers,
    each recomputed in the backward pass where ``remat_active``."""
    remat = remat_active(cfg)
    for i in range(n):
        p = tree_map(lambda a: a[i], layers)
        if remat:
            x = checkpoint(blk, cfg, p, x, *args, use_reentrant=False)
        else:
            x = blk(cfg, p, x, *args)
    return x


def _enc_block(cfg: ModelConfig, p: Tree, x, positions, tp=None):
    p = gathered(p)     # a stored shard is gathered inside any recompute
    h = apply_norm(cfg, p["norm1"], x)
    x = x + attn.attention(cfg, p["attn"], h, positions, causal=False,
                           tp=tp)
    return x + apply_mlp(cfg, p["mlp"], apply_norm(cfg, p["norm2"], x),
                         tp=tp)


def _dec_block(cfg: ModelConfig, p: Tree, x, positions, memory, tp=None):
    p = gathered(p)
    h = apply_norm(cfg, p["norm1"], x)
    x = x + attn.attention(cfg, p["self_attn"], h, positions, causal=True,
                           tp=tp)
    h = apply_norm(cfg, p["norm2"], x)
    mem_kv = attn.cross_kv(cfg, p["cross_attn"], memory, tp)
    x = x + attn.cross_attention(cfg, p["cross_attn"], h, mem_kv, tp)
    return x + apply_mlp(cfg, p["mlp"], apply_norm(cfg, p["norm3"], x),
                         tp=tp)


def _own(t, tp):
    return t if tp is None else tp.own(t, dim=0)


def encode(cfg: ModelConfig, params: Tree, frames, tp=None) -> torch.Tensor:
    """frames: [B, T_enc, d] (conv-stub output) -> encoder states (with
    ``tp``: the rank's part of the sequence in and out)."""
    dev = params["embed"].device
    frames = torch.as_tensor(frames, device=dev)
    T = frames.shape[1] * (1 if tp is None else tp.size)
    x = frames.to(cfg.dtype) + _own(_sincos(T, cfg, dev), tp)
    x = _layers(cfg, _enc_block, params["enc_layers"], _n_enc(cfg), x,
                _positions(frames.shape[0], T, dev), tp)
    return apply_norm(cfg, gathered(params["enc_norm"]), x)


def decode_hidden(cfg: ModelConfig, params: Tree, tokens, memory,
                  tp=None) -> torch.Tensor:
    """Teacher-forced decoder up to its final norm: tokens [B, T_dec],
    memory [B, T_enc, d] -> [B, T_dec, d] (with ``tp``: memory and the
    result the rank's part of their sequences)."""
    x = embed_tokens(cfg, params, tokens, tp)
    T = x.shape[1] * (1 if tp is None else tp.size)
    x = x + _own(_sincos(T, cfg, x.device), tp)
    if tp is not None:
        memory = tp.gather_seq(memory)
    x = _layers(cfg, _dec_block, params["dec_layers"], cfg.n_layers, x,
                _positions(x.shape[0], T, x.device), memory, tp)
    return apply_norm(cfg, gathered(params["final_norm"]), x)


def decode_train(cfg: ModelConfig, params: Tree, tokens,
                 memory) -> torch.Tensor:
    """Teacher-forced decoder: tokens [B, T_dec], memory [B, T_enc, d] ->
    logits [B, T_dec, V] float32 (tied embedding)."""
    x = decode_hidden(cfg, params, tokens, memory)
    return (x @ gathered(params["embed"]).T).float()


def forward(cfg: ModelConfig, params: Tree, batch: Dict[str, torch.Tensor]):
    """Encode frames, teacher-forced decode; returns (logits, aux)."""
    memory = encode(cfg, params, batch["frames"])
    logits = decode_train(cfg, params, batch["tokens"], memory)
    return logits, torch.zeros((), dtype=torch.float32, device=logits.device)


def loss_fn(cfg: ModelConfig, params: Tree, batch: Dict[str, torch.Tensor],
            *, comm=None, tp=None, **_):
    """Masked cross-entropy over valid (label >= 0) positions -> (ce,
    {"ce", "aux", "zloss"}), on the full teacher-forced logits (T_dec is
    short), as the reference.  With ``comm`` (a mesh's data-parallel
    group) the mean is over the global batch, as ``lm.loss_fn`` takes
    it, through one chunk of ``lm.sequence_ce`` (no z-loss); with ``tp``
    as well (its "model" group) the model and the cross-entropy compute
    on "model"."""
    if comm is not None:
        memory = encode(cfg, params, batch["frames"], tp)
        x = decode_hidden(cfg, params, batch["tokens"], memory, tp)
        labels = torch.as_tensor(batch["labels"], device=x.device).long()
        nll_s, _z, cnt = sequence_ce(cfg, x, _unembed(cfg, params), labels,
                                     tp, chunk=labels.shape[1], z_weight=0.0)
        zero = torch.zeros((), dtype=torch.float32, device=x.device)
        return _global_loss(nll_s, zero, cnt, zero, 0.0, comm, tp)
    logits, aux = forward(cfg, params, batch)
    labels = torch.as_tensor(batch["labels"], device=logits.device).long()
    mask = (labels >= 0).float()
    safe = torch.clamp(labels, min=0)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, safe[..., None])[..., 0]
    ce = ((logz - gold) * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    return ce, {"ce": ce, "aux": aux, "zloss": torch.zeros_like(ce)}


# ---------------------------------------------------------------------------
# Cached decode (serve_step): self-attn KV cache + precomputed cross KV
# ---------------------------------------------------------------------------

@torch.inference_mode()
def init_decode_state(cfg: ModelConfig, params: Tree, batch: int,
                      max_dec: int, memory) -> Tree:
    """Allocate self-attn KV caches and precompute per-layer cross K/V
    ([L, B, T_enc, KV, hd]) so decode steps never re-project the memory."""
    n_dec, KV, hd = cfg.n_layers, cfg.n_kv_heads, cfg.head_dim
    dev = memory.device
    cross = params["dec_layers"]["cross_attn"]
    kvs = [attn.cross_kv(cfg, tree_map(lambda a: a[i], cross), memory)
           for i in range(n_dec)]
    shape = (n_dec, batch, max_dec, KV, hd)
    return {
        "pos": 0,
        "k": torch.zeros(shape, dtype=cfg.dtype, device=dev),
        "v": torch.zeros(shape, dtype=cfg.dtype, device=dev),
        "xk": torch.stack([k for k, _ in kvs]),
        "xv": torch.stack([v for _, v in kvs]),
    }


def _position_embedding(cfg: ModelConfig, pos: int, device):
    """The sin / cos embedding of decode position ``pos`` [1, 1, d], formed
    in float32 as the reference forms it."""
    d = cfg.d_model
    i = torch.arange(d // 2, device=device)
    ang = torch.tensor(pos, dtype=torch.float32, device=device) \
        / (10_000 ** (2 * i / d))
    return torch.cat([torch.sin(ang), torch.cos(ang)])[None, None, :]


@torch.inference_mode()
def decode_step(cfg: ModelConfig, params: Tree, state: Tree, tokens, *,
                comm=None, seq=None, tp=None) -> Tuple[torch.Tensor, Tree]:
    """One decoder token against the cached self K/V and the encoder
    memory's cross K/V: tokens [B, 1] -> (logits [B, 1, V] float32, new
    state).  The state is donated: its caches are updated in place and it
    is returned with ``pos`` advanced.  Under a mesh the parameters are
    stored shards and the state the rank's shards, the self and cross K/V
    both laid out as the KV cache (``lm.decode_step``; ``seq`` the dp
    group that splits the cache's slots, and the memory's positions,
    where it does not split the batch; ``comm`` is not read: the
    decoder has no MoE layer)."""
    pos = state["pos"]
    x = embed_tokens(cfg, params, tokens, tp)
    x = x + _position_embedding(cfg, pos, x.device).to(cfg.dtype)
    layers = params["dec_layers"]
    for i in range(cfg.n_layers):
        p = gathered(tree_map(lambda a: a[i], layers))
        h = apply_norm(cfg, p["norm1"], x)
        y, _k, _v = attn.decode_attention(cfg, p["self_attn"], h,
                                          state["k"][i], state["v"][i], pos,
                                          tp=tp, seq=seq)
        x = x + y
        h = apply_norm(cfg, p["norm2"], x)
        x = x + attn.cross_attention(cfg, p["cross_attn"], h,
                                     (state["xk"][i], state["xv"][i]), tp,
                                     seq=seq)
        x = x + apply_mlp(cfg, p["mlp"], apply_norm(cfg, p["norm3"], x),
                          tp=tp)
    x = apply_norm(cfg, gathered(params["final_norm"]), x)
    state["pos"] = pos + 1
    return decode_logits(cfg, x, gathered(params["embed"]).T, tp), state
