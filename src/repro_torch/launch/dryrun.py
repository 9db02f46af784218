"""Dry run of every (arch x shape) cell on the production meshes (port of
``repro/launch/dryrun.py``): per cell, the per-device bytes of every
argument of its step, the step's peak memory on a device and the
gradient-accumulation count that fits it, its counted cost and
collectives, and the model flops, with nothing allocated on any device
and CUDA never touched.

A cell's step takes ``(params, opt, batch)`` (train), ``(params, batch)``
(prefill) or ``(params, state, tokens)`` (decode), with the shapes and
specs of ``launch/steps.py``.  A dimension whose spec entry spans axes of
extent e holds ``ceil(dim / e)`` rows on a device, times the dtype's item
size; a leaf whose spec does not divide a dimension is listed under
``uneven``, since there the layout is the partitioner's own choice.  The
sum is the caller's arrays on one device: XLA's
``argument_size_in_bytes`` for the same cell equals it, except where XLA
prunes an argument the step never reads (the encoder's weights in an
encoder-decoder's decode step), which the caller holds all the same.

The step itself runs on ``meta`` tensors (``launch/meta_trace.py``) as
rank :data:`TRACED_RANK` of the production mesh runs it, through
``launch.mesh.make_mesh`` bound to a ``meta_trace.CountingComm`` of 256
or 512 ranks in this one process; the hand-written kernels' wrappers
allocate their outputs and scratch there and launch nothing.  Where XLA
reads its compiled program, the port reads that trace:

* ``memory``: the reference's four figures per device, in requested
  bytes (``memory_record``: the traced peak is ``argument + temp +
  output - alias``), ``footprint_bytes`` that peak, and ``accum`` the
  reference's search: from 1, doubled while the footprint exceeds
  :data:`HBM_BUDGET` and ``accum * 2 <= global_batch // dp``, each count
  traced anew; ``fits_hbm`` whether the last one fits.  Prefill and
  decode cells trace their step once, at ``accum`` 1;
* ``cost`` / ``cost_raw``, a device's (the traced rank's): ``flops`` the
  matmul family's operations
  (``torch.utils.flop_counter``'s formulas) plus each hand-written
  kernel's own count (``kernels.flash_attention.operations``,
  ``kernels.ssd_chunk.operations``, the bounds of PERF.md's table), and
  ``bytes`` every operation's operand and result bytes, views and bare
  allocations excepted (XLA's "bytes accessed");
* ``collectives_raw`` and ``cost["collectives"]``: the reference's
  ``collective_bytes`` record, per kind the rank's wire bytes from each
  collective's result bytes and group size, ``count`` and ``wire_total``.

The two cost records coincide here: the reference's ``cost_raw`` is
XLA's figure for the scanned program, which counts a loop body once, and
its ``cost`` corrects that by compiling unrolled superblocks; an eager
trace runs every layer and every microbatch, so there is nothing to
correct, and ``cost`` keeps only ``flops``, ``bytes`` and
``collectives`` (no per-superblock figures).  ``compile_s`` is the
seconds the traces took.  ``--no-cost`` skips the cost count (``cost``
and ``cost_raw``), not the memory trace or the collectives.

``model_flops`` is 6 N D for a train step and 2 N D for prefill and
decode, N the active parameters (``lm.count_active_params``; all of
them, ``whisper.count_params``, for the encoder-decoder) and D the
tokens (one a sequence in a decode step).

Left out: the reference's placeholder-device XLA flags (nothing here
needs a device) and its ``prepare_config`` (the port's meshes carry the
data-parallel axes themselves, ``launch.mesh.dp_axes``).

Usage:
  python -m repro_torch.launch.dryrun --arch qwen3_14b --shape train_4k [--multi-pod] [--no-cost]
  python -m repro_torch.launch.dryrun --all [--out results/dryrun.json] [--no-cost]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import time
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import torch

from ..configs import SHAPES, get_config, shape_cells
from ..configs.registry import ARCHS
from ..models import lm, whisper
from ..models.common import tree_leaves
from ..models.config import ModelConfig
from ..optim import AdamWConfig
from . import meta_trace, steps
from .mesh import Mesh, Spec, axis_size, dp_axes, make_mesh, \
    make_production_mesh, shard_tree
from .meta_trace import CountingComm

#: the most a step's footprint (requested bytes a device) may reach on
#: one H100 80GB HBM3 at its 700.00 W power limit: its 85,017,493,504
#: bytes less 833,421,312 of CUDA context and 10,972,292,772 that the
#: caching allocator reserved above the requested bytes in starcoder2-3b's
#: train step begun on an emptied cache (chip_smoke.py phase 35, the most
#: of phases 24, 32 and 34) leave 68.184 GiB, taken down to 67 GiB for
#: the spread between runs (0.13 GiB over two); phase 35 checks it
#: against the card each run
HBM_BUDGET = 67 * 2 ** 30


@dataclasses.dataclass(frozen=True)
class Leaf:
    """One array argument of a cell's step: its path (the argument's name,
    then the keys into its tree), global shape, dtype and spec."""
    path: str
    shape: Tuple[int, ...]
    dtype: torch.dtype
    spec: Spec

    def shard_shape(self, mesh: Mesh) -> Tuple[int, ...]:
        """The shape one device holds: ``ceil(dim / extent)`` a dimension."""
        return tuple(-(-d // axis_size(mesh, ax))
                     for d, ax in zip(self.shape, self._entries()))

    def even(self, mesh: Mesh) -> bool:
        """True where every dimension divides by its axes' extent."""
        return all(d % axis_size(mesh, ax) == 0
                   for d, ax in zip(self.shape, self._entries()))

    def nbytes(self, mesh: Mesh) -> int:
        """Bytes one device holds."""
        return math.prod(self.shard_shape(mesh)) * self.dtype.itemsize

    def _entries(self):
        return tuple(self.spec) + (None,) * (len(self.shape) - len(self.spec))


def _leaves(name: str, tree, spec_tree) -> List[Leaf]:
    """The leaves of one argument (a tensor, or a tree of them) with the
    specs at the same paths of ``spec_tree``."""
    if isinstance(tree, torch.Tensor):
        return [Leaf(name, tuple(tree.shape), tree.dtype, spec_tree)]
    out = []
    for path, t in tree_leaves(tree):
        spec = spec_tree
        for key in path:
            spec = spec[key]
        out.append(Leaf("/".join((name,) + path), tuple(t.shape), t.dtype,
                        spec))
    return out


def cell_leaves(cfg: ModelConfig, shape, mesh: Mesh) -> List[Leaf]:
    """Every array argument of the cell's step, in argument order, each
    tree's leaves in sorted-key order (jax's flatten order)."""
    p_specs, o_specs = steps.param_and_opt_specs(cfg, mesh)
    params = steps.param_shapes(cfg)
    out = _leaves("params", params, p_specs)
    if shape.kind == "decode":
        state, s_specs, tokens, t_spec = steps.decode_state_specs(
            cfg, shape, mesh)
        return out + _leaves("state", state, s_specs) + \
            _leaves("tokens", tokens, t_spec)
    batch, b_specs = steps.batch_specs(cfg, shape, mesh,
                                       with_labels=shape.kind == "train")
    if shape.kind == "train":
        out += _leaves("opt", steps.opt_shapes(params), o_specs)
    return out + _leaves("batch", batch, b_specs)


def argument_bytes(cfg: ModelConfig, shape, mesh: Mesh) -> Dict[str, Any]:
    """Per-device bytes of the cell's step arguments, by argument
    (``params``, ``opt``, ``batch``; or ``params``, ``state``,
    ``tokens``), their ``total``, and the paths of the ``uneven`` leaves
    (a spec that does not divide its dimension)."""
    out: Dict[str, Any] = {}
    uneven = []
    for leaf in cell_leaves(cfg, shape, mesh):
        group = leaf.path.split("/", 1)[0]
        out[group] = out.get(group, 0) + leaf.nbytes(mesh)
        if not leaf.even(mesh):
            uneven.append(leaf.path)
    out["total"] = sum(out.values())
    out["uneven"] = uneven
    return out


def model_flops(cfg: ModelConfig, shape) -> Tuple[float, int]:
    """(model flops, tokens) of one step of the cell: 6 N_active D for a
    train step, else 2 N_active D; a decode step counts one token a
    sequence."""
    n_active = (whisper.count_params(cfg) if cfg.encdec
                else lm.count_active_params(cfg))
    tokens = shape.global_batch * (1 if shape.kind == "decode"
                                   else shape.seq_len)
    mult = 6 if shape.kind == "train" else 2
    return float(mult * n_active * tokens), tokens


def check_overrides(overrides: Dict[str, Any]) -> None:
    """Raise ``ValueError`` naming each overridden field that the port's
    ``ModelConfig`` lacks."""
    fields = {f.name for f in dataclasses.fields(ModelConfig)}
    unknown = sorted(set(overrides) - fields)
    if unknown:
        raise ValueError(f"--override: ModelConfig has no field "
                         f"{', '.join(map(repr, unknown))}")


#: the rank a cell's step is traced on.  No leaf of any cell is uneven
#: (``argument_bytes``' ``uneven`` lists are empty on both production
#: meshes), so every rank holds shards of one shape; rank 0 sits at
#: coordinate 0 of every axis, where ``optim.adamw.global_norm`` counts the
#: squares of every leaf a spec replicates, so no rank does more
TRACED_RANK = 0


def _fresh(batch: Dict[str, Any]) -> Dict[str, Any]:
    """A ``shard_batch`` batch with every shard its own contiguous copy
    (the cut is a view of the whole batch, whose storage a rank never
    holds)."""
    out = {}
    for k, v in batch.items():
        if isinstance(v, steps.StoredLeaf):
            v = steps.StoredLeaf(v.shard.clone(), v.spec, v.mesh, v.plan)
        out[k] = v.clone() if isinstance(v, torch.Tensor) else v
    return out


def _batch(cfg: ModelConfig, shape, mesh: Mesh, labels: bool):
    """The step's batch: the rank's shard (``steps.shard_batch``) on a
    mesh of ranks, the whole batch on one device."""
    batch, _s = steps.batch_specs(cfg, shape, mesh, with_labels=labels)
    if mesh.comm is None:
        return _fresh(batch)
    return _fresh(steps.shard_batch(cfg, batch, mesh))


def step_and_args(cfg: ModelConfig, shape, mesh: Mesh, *, accum: int = 1):
    """(the cell's step, its arguments) on ``mesh``, the arguments the
    rank's shards as ``meta`` tensors: the parameters (and for a train
    step AdamW's moments, its step count a host tensor as ``adamw_init``
    makes it) by ``steps.shard_state`` / ``shard_tree``, the batch by
    ``steps.shard_batch``, a decode state by ``steps.shard_decode_state``
    (at ``pos`` 0: no shape depends on it) and its token rows."""
    p_specs, _o = steps.param_and_opt_specs(cfg, mesh)
    whole = steps.param_shapes(cfg)
    if shape.kind == "train":
        params, opt = steps.shard_state(cfg, whole, mesh)
        return (steps.build_train_step(cfg, AdamWConfig(), accum=accum,
                                       mesh=mesh),
                (params, opt, _batch(cfg, shape, mesh, True)))
    params = shard_tree(whole, p_specs, mesh)
    if shape.kind == "prefill":
        return (steps.build_prefill_step(cfg, mesh=mesh),
                (params, _batch(cfg, shape, mesh, False)))
    state, _s, tokens, _t = steps.decode_state_specs(cfg, shape, mesh)
    state["pos"] = 0
    return (steps.build_serve_step(cfg, mesh=mesh),
            (params, steps.shard_decode_state(cfg, state, shape, mesh),
             steps.decode_rows(cfg, tokens, shape, mesh).clone()))


def rank_mesh(template: Mesh, rank: int = TRACED_RANK):
    """(``template``'s mesh bound to a ``meta_trace.CountingComm`` for
    ``rank``, the comm); a one-device mesh on ``meta`` and no comm."""
    if template.size == 1:
        return make_mesh(template.axis_sizes, template.axis_names,
                         device="meta"), None
    comm = CountingComm(rank, template.size)
    return make_mesh(template.axis_sizes, template.axis_names,
                     comm=comm), comm


def trace_cell(cfg: ModelConfig, shape, template: Mesh, *, accum: int = 1,
               cost: bool = True) -> Dict[str, Any]:
    """One step of the cell traced on ``meta`` tensors on rank
    :data:`TRACED_RANK` of ``template`` (``meta_trace.trace``'s record),
    with the rank's ``comm`` counters (``calls``, ``bytes``) and
    ``collectives`` (the reference's wire bytes by kind) where the mesh
    has ranks."""
    mesh, comm = rank_mesh(template)
    step, args = step_and_args(cfg, shape, mesh, accum=accum)
    record = meta_trace.trace(step, args, cost=cost)
    if comm is not None:
        record["comm"] = comm.counters()
        record["collectives"] = comm.collective_bytes()
    return record


def memory_record(argument: int, tr: Dict[str, Any]) -> Dict[str, int]:
    """The reference's four memory numbers from a trace, so that
    ``footprint = argument + temp + output - alias`` (its ``run_cell``):
    ``argument_bytes`` the step's arguments a device (:func:`argument_bytes`),
    ``alias_bytes`` the argument storages the step updates in place (the
    parameters and moments of a train step, a decode step's carries:
    what the reference donates), ``output_bytes`` those plus the new
    tensors the step returns (metrics, logits), and ``temp_bytes`` the
    rest of the traced peak, which holds the arguments throughout."""
    output = tr["written"] + tr["returned"]
    return {"argument_bytes": int(argument), "output_bytes": int(output),
            "temp_bytes": int(tr["peak"] - argument - tr["returned"]),
            "alias_bytes": int(tr["written"])}


def run_cell(arch: str, shape_name: str, *, multi_pod: bool = False,
             cost_variants: bool = True, verbose: bool = True,
             overrides: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """One (arch, shape) cell's record on the production mesh (two pods
    with ``multi_pod``), with the reference's keys: a train step's
    ``accum`` doubled from 1 while the footprint exceeds
    :data:`HBM_BUDGET` and ``accum * 2 <= global_batch // dp``, then
    ``memory`` (:func:`memory_record`), ``fits_hbm``, ``footprint_bytes``
    (the traced peak on rank :data:`TRACED_RANK`), ``compile_s`` (the
    traces' seconds), ``cost_raw`` / ``cost`` and ``collectives_raw``
    (module docstring; ``cost_variants=False``, ``--no-cost``, leaves out
    ``cost`` and ``cost_raw``), ``model_flops`` and ``tokens``; and the
    bytes by argument (``argument_bytes``)."""
    shape = SHAPES[shape_name]
    mesh = make_production_mesh(multi_pod=multi_pod)
    cfg = get_config(arch)
    if overrides:
        check_overrides(overrides)
        cfg = dataclasses.replace(cfg, **overrides)
    args = argument_bytes(cfg, shape, mesh)
    dp = axis_size(mesh, dp_axes(mesh))
    max_accum = max(1, shape.global_batch // dp) \
        if shape.kind == "train" else 1
    accum = 1
    t0 = time.perf_counter()
    while True:
        tr = trace_cell(cfg, shape, mesh, accum=accum, cost=cost_variants)
        mem = memory_record(args["total"], tr)
        footprint = (mem["argument_bytes"] + mem["temp_bytes"]
                     + mem["output_bytes"] - mem["alias_bytes"])
        if footprint <= HBM_BUDGET or accum * 2 > max_accum:
            break
        accum *= 2
    flops, tokens = model_flops(cfg, shape)
    result = {"arch": arch, "shape": shape_name, "multi_pod": multi_pod,
              "mesh": mesh.shape, "kind": shape.kind,
              "compile_s": round(time.perf_counter() - t0, 1),
              "accum": accum, "memory": mem,
              "fits_hbm": bool(footprint <= HBM_BUDGET),
              "footprint_bytes": int(footprint)}
    result["collectives_raw"] = tr["collectives"]
    if cost_variants:
        result["cost_raw"] = {"flops": tr["flops"], "bytes": tr["bytes"]}
        result["cost"] = {"flops": tr["flops"], "bytes": tr["bytes"],
                          "collectives": dict(tr["collectives"])}
    result.update(model_flops=flops, tokens=tokens, argument_bytes=args)
    if verbose:
        print(f"[{arch} x {shape_name} mp={multi_pod}] traced in "
              f"{result['compile_s']}s; accum={accum} args="
              f"{args['total'] / 2**30:.2f}GiB temp="
              f"{mem['temp_bytes'] / 2**30:.2f}GiB fits="
              f"{result['fits_hbm']}, model flops {flops:.4g}", flush=True)
    return result


def parse_overrides(items: List[str]) -> Dict[str, Any]:
    """``key=value`` strings to a dict: ``true`` / ``false`` (any case)
    as booleans, integers as ints, anything else as the string."""
    out: Dict[str, Any] = {}
    for item in items:
        key, val = item.split("=", 1)
        low = val.lower()
        out[key] = json.loads(low) if low in ("true", "false") else (
            int(val) if val.lstrip("-").isdigit() else val)
    return out


def main(argv=None) -> List[Dict[str, Any]]:
    """CLI driver (see the module docstring); returns the records."""
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.dryrun")
    ap.add_argument("--arch", choices=[*ARCHS], default=None)
    ap.add_argument("--shape", choices=list(SHAPES), default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--no-cost", action="store_true",
                    help="skip the cost count (not the memory trace)")
    ap.add_argument("--out", default=None, help="JSON output path")
    ap.add_argument("--override", action="append", default=[],
                    help="config override key=value, e.g. "
                         "--override ssm_chunk=64 --override fsdp=False")
    args = ap.parse_args(argv)
    overrides = parse_overrides(args.override)
    check_overrides(overrides)

    results: List[Dict[str, Any]] = []
    done = set()
    if args.all and args.out and Path(args.out).exists():
        results = [c for c in json.loads(Path(args.out).read_text())
                   if "error" not in c]
        done = {(c["arch"], c["shape"], c["multi_pod"]) for c in results}
        print(f"resuming: {len(done)} cells already recorded")
    if args.all:
        for arch in ARCHS:
            for shape in shape_cells(arch):
                for mp in (False, True):
                    if (arch, shape.name, mp) in done:
                        continue
                    try:
                        results.append(run_cell(
                            arch, shape.name, multi_pod=mp,
                            cost_variants=not args.no_cost,
                            overrides=overrides))
                    except Exception as e:  # record, keep sweeping
                        msg = f"{type(e).__name__}: {str(e)[:500]}"
                        print(f"FAILED [{arch} x {shape.name} mp={mp}]: "
                              f"{msg[:300]}", flush=True)
                        results.append({"arch": arch, "shape": shape.name,
                                        "multi_pod": mp, "error": msg})
                    if args.out:  # checkpoint partial results
                        _write(args.out, results)
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape (or --all)")
        results.append(run_cell(args.arch, args.shape,
                                multi_pod=args.multi_pod,
                                cost_variants=not args.no_cost,
                                overrides=overrides))

    if args.out:
        _write(args.out, results)
        print(f"wrote {args.out}")
    else:
        print(json.dumps(results, indent=1))
    return results


def _write(out: str, results) -> None:
    path = Path(out)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(results, indent=1))


if __name__ == "__main__":
    main()
