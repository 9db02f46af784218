"""Dry run of every (arch x shape) cell on the production meshes (port of
``repro/launch/dryrun.py``): per cell, the per-device bytes of every
argument of its step and the model flops, with nothing allocated on any
device and CUDA never touched.

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

``model_flops`` is 6 N D for a train step and 2 N D for prefill and
decode, N the active parameters (``lm.count_active_params``; all of
them, ``whisper.count_params``, for the encoder-decoder) and D the
tokens (one a sequence in a decode step).

Left out, since each needs XLA's compile or its HLO: the reference's
placeholder-device XLA flags, ``collective_bytes`` (the port has no HLO,
and its collectives are not XLA's to emulate), the cost and memory
analyses (``cost``, ``cost_raw``, ``collectives_raw``, and ``memory``'s
output, temp and alias bytes), the unrolled cost-extrapolation configs,
the search for a gradient-accumulation count that fits a memory budget
(``accum``, ``fits_hbm``, ``footprint_bytes``), ``compile_s`` and
``--no-cost``.

Usage:
  python -m repro_torch.launch.dryrun --arch qwen3_14b --shape train_4k [--multi-pod]
  python -m repro_torch.launch.dryrun --all [--out results/dryrun.json]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import torch

from ..configs import SHAPES, get_config, shape_cells
from ..configs.registry import ARCHS
from ..models import lm, whisper
from ..models.common import tree_leaves
from ..models.config import ModelConfig
from . import steps
from .mesh import Mesh, Spec, axis_size, make_production_mesh


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


def run_cell(arch: str, shape_name: str, *, multi_pod: bool = False,
             verbose: bool = True,
             overrides: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """One (arch, shape) cell's record on the production mesh (two pods
    with ``multi_pod``): its mesh and kind, ``tokens`` and
    ``model_flops``, and ``memory["argument_bytes"]`` (per device) beside
    the bytes by argument (``argument_bytes``)."""
    shape = SHAPES[shape_name]
    mesh = make_production_mesh(multi_pod=multi_pod)
    cfg = get_config(arch)
    if overrides:
        check_overrides(overrides)
        cfg = dataclasses.replace(cfg, **overrides)
    args = argument_bytes(cfg, shape, mesh)
    flops, tokens = model_flops(cfg, shape)
    result = {"arch": arch, "shape": shape_name, "multi_pod": multi_pod,
              "mesh": mesh.shape, "kind": shape.kind,
              "memory": {"argument_bytes": args["total"]},
              "argument_bytes": args, "model_flops": flops,
              "tokens": tokens}
    if verbose:
        print(f"[{arch} x {shape_name} mp={multi_pod}] args="
              f"{args['total'] / 2**30:.2f}GiB a device, model flops "
              f"{flops:.4g}", flush=True)
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
                        results.append(run_cell(arch, shape.name,
                                                multi_pod=mp,
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
