"""Mixture-of-experts layer: top-k routing with capacity, scatter/gather
dispatch (port of ``repro/models/moe.py``).  No [n_tokens, E, capacity]
one-hot cube is formed.

Routing: the router runs in float32; each token takes its top-k experts,
the lower expert index first among equal probabilities (``jax.lax.top_k``'s
order, which ``torch.topk`` does not promise: a stable descending sort
gives it).  Each (token, choice) gets a slot, its rank among the choices
of the same expert in token-major, then choice order; a slot at or past
the capacity C is dropped (gate weight 0).

Dispatch: every kept slot is unique, so the expert buffer [E * C, d] is a
gather of token rows through a slot -> token table (empty slots read a
zero row) and needs no float atomics.  The experts run as batched
products [E, C, d] x [E, d, f] (``torch.bmm``: the reference computes
them as plain einsums, outside any Pallas kernel), and each (token,
choice) gathers its expert's output back, weighted by its normalized
gate.  The reference's sharding annotations (``moe_ec_constraint``) are
not ported.

Under a mesh (``comm``, the data-parallel group of ``launch/mesh.py``;
each rank holds other rows of the batch) the routing is the reference's
one program over the global batch: the capacity counts the global
tokens, a choice's slot is its rank within its expert in global token
order (the counts of the ranks before this one come first), and the aux
loss takes the global token fractions; each rank runs the experts on its
own kept choices only, which is exact, since rows are independent.

With ``tp`` as well (the mesh's "model" group,
``launch.mesh.TensorParallel``; the input the rank's part of the
sequence) the layer is expert-parallel: the tokens are gathered along T,
so every rank along "model" routes its dp rank's tokens as above (the
same choices, drops and aux loss), runs the slots of its own
``E / model`` experts only, weights and sums the kept choices of those,
and the ranks' partial outputs (with the shared expert's column- /
row-parallel products) are reduce-scattered back along T.  Whole expert
or shared weights (a count the extent does not divide) run on every
rank; their output is whole and the rank keeps its own rows.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .common import ParamDef, Tree, is_split


def moe_defs(cfg) -> Tree:
    """MoE block ParamDefs (router + expert-stacked MLPs)."""
    d, f, E = cfg.d_model, cfg.d_ff, cfg.moe_experts
    defs = {
        "router": ParamDef((d, E), (None, None), scale=0.1),
        "wi": ParamDef((E, d, f), ("T", "F", None)),
        "wg": ParamDef((E, d, f), ("T", "F", None)),
        "wo": ParamDef((E, f, d), ("T", None, "F"), scale=cfg.out_scale),
    }
    if cfg.moe_shared:
        defs["shared"] = {
            "wi": ParamDef((d, f), ("F", "T")),
            "wg": ParamDef((d, f), ("F", "T")),
            "wo": ParamDef((f, d), ("T", "F"), scale=cfg.out_scale),
        }
    return defs


def capacity(cfg, n_tokens: int) -> int:
    """Slots per expert for ``n_tokens`` tokens: the reference's
    ``int(max(1, round(cf * n * k / E)))`` on Python numbers (``round``
    takes a half to the even neighbour)."""
    return int(max(1, round(cfg.capacity_factor * n_tokens * cfg.moe_top_k
                            / cfg.moe_experts)))


def route(cfg, router, xt):
    """Router of ``xt`` [n, d] -> (probs [n, E] float32, gate values
    [n, k] normalized, gate experts [n, k] int64), the lower expert index
    first among ties."""
    logits = xt.float() @ router.float()
    probs = torch.softmax(logits, dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    k = cfg.moe_top_k
    vals, idx = vals[:, :k], idx[:, :k]
    return probs, vals / vals.sum(-1, keepdim=True).clamp_min(1e-9), idx


def dispatch(cfg, gate_idx, comm=None):
    """Slots of the flattened (token, choice) pairs -> (flat_idx [n * k]
    row of the [E * C + 1] buffer, E * C for a dropped choice; keep
    [n * k] bool; counts [E] choices per expert; C).

    With ``comm`` the capacity is the global batch's and a choice is kept
    where its global slot (its local one plus the earlier ranks' counts of
    its expert) is below it; the buffer then holds this rank's kept
    choices only, ``C`` slots an expert with ``C = min(capacity, n * k)``
    (at most that many of the rank's choices can be kept), and ``counts``
    are the global ones."""
    n, k = gate_idx.shape
    E = cfg.moe_experts
    C = capacity(cfg, n if comm is None else n * comm.size)
    eidx = gate_idx.reshape(-1)
    # an integer scatter-add (torch.bincount would wait for the device to
    # size its output)
    counts = torch.zeros(E, dtype=torch.long, device=eidx.device)
    counts.scatter_add_(0, eidx, torch.ones_like(eidx))
    # a stable sort by expert keeps the token-major, then choice, order
    # within each expert, so a choice's place in its group is its slot
    order = torch.argsort(eidx, stable=True)
    starts = torch.cumsum(counts, 0) - counts
    slot = torch.empty_like(eidx)
    slot[order] = torch.arange(n * k, device=eidx.device) - starts[eidx[order]]
    if comm is None:
        keep = slot < C
    else:
        every = comm.gather(counts)                   # [ranks, E]
        before = every[:comm.index].sum(0)
        keep = slot + before[eidx] < C
        counts = every.sum(0)
        C = min(C, n * k)
    flat_idx = torch.where(keep, eidx * C + slot.clamp_max(C - 1), E * C)
    return flat_idx, keep, counts, C


def apply_moe(cfg, p: Tree, x, comm=None, tp=None):
    """x: [B, T, d] -> ([B, T, d], aux load-balance loss, float32 scalar).
    With ``comm`` the aux loss is this rank's share of the global one:
    its tokens' probabilities over the global token count, times the
    global fractions (which carry no gradient), so the shares sum to it.
    With ``tp``: see the module docstring (the aux loss is then the same
    on every rank along "model")."""
    own_rows = x
    if tp is not None:
        x = tp.gather_seq(x)
    B, T, d = x.shape
    E, k = cfg.moe_experts, cfg.moe_top_k
    n = B * T
    xt = x.reshape(n, d)
    probs, gate_vals, gate_idx = route(cfg, p["router"], xt)
    flat_idx, keep, counts, C = dispatch(cfg, gate_idx, comm)

    # Switch-style aux loss: E * sum_e (token fraction_e * mean prob_e)
    if comm is None:
        aux = E * torch.sum(probs.mean(dim=0) * (counts.float() / (n * k)))
    else:
        n_all = n * comm.size
        aux = E * torch.sum(probs.sum(dim=0) / n_all
                            * (counts.float() / (n_all * k)))

    # the rank's experts [e0, e0 + El) (all of them without tp or where
    # the expert weights came whole)
    El = p["wi"].shape[0]
    partial = is_split(p["wi"], E, 0, tp)
    e0 = tp.index * El if partial else 0
    # slot -> token (n: the zero row) for every buffer row; the overflow
    # row E * C takes every dropped choice and is cut off
    tok = torch.arange(n * k, device=x.device) // k
    src = torch.full((E * C + 1,), n, dtype=torch.long, device=x.device)
    src.index_copy_(0, flat_idx, tok)
    xz = torch.cat([xt, xt.new_zeros(1, d)])
    expert_in = xz[src[e0 * C:(e0 + El) * C]].view(El, C, d)

    h = F.silu(torch.bmm(expert_in, p["wg"])) * torch.bmm(expert_in, p["wi"])
    expert_out = torch.bmm(h, p["wo"]).view(El * C, d)
    del h, expert_in
    expert_out = torch.cat([expert_out, expert_out.new_zeros(1, d)])

    # a choice of another rank's expert (or dropped) reads the zero row
    local = flat_idx - e0 * C
    local = torch.where((local >= 0) & (local < El * C), local, El * C)
    w = (gate_vals.reshape(-1) * keep).to(x.dtype)[:, None]
    out = (expert_out[local] * w).view(n, k, d).sum(dim=1)

    shared = p["shared"] if cfg.moe_shared else None
    if tp is None:
        if shared is not None:
            out = out + _shared(shared, xt)
        return out.view(B, T, d), aux
    out = out.view(B, T, d)
    if not partial:
        out = tp.own(out)
    shared_split = shared is not None and is_split(shared["wi"], cfg.d_ff,
                                                   1, tp)
    if shared_split:
        y = _shared(shared, x)
        out = out + y if partial else out + tp.scatter_seq(y)
    if partial:
        out = tp.scatter_seq(out)
    if shared is not None and not shared_split:
        out = out + _shared(shared, own_rows)
    return out, aux


def _shared(s: Tree, x):
    """The shared expert (a SwiGLU MLP) on ``x``."""
    return (F.silu(x @ s["wg"]) * (x @ s["wi"])) @ s["wo"]
