"""Count the collectives one mesh train step of an LM takes on each rank,
with the bytes each kind sends and the host time spent in them, on gloo
ranks: the cells of ``chip_smoke.py`` phase 38 (their arch's depth, mesh,
fsdp, global batch, microbatches and sequence length), or those of one
decode token in phase 39's cells (``--cell qwen_decode|mamba_decode``:
their depth, mesh, batch and cache length, the config's fsdp).  On the CPU the
arch runs at its smoke widths: the count follows the leaves, the layers,
the microbatches and the loss's chunks, not the widths (mamba2-130m's
full-width step counts one optimizer relayout gather more than here,
on two trees alike).  With ``--device cuda`` every rank runs the
full-width step on cuda:0, host-staged, as phase 38 does, and the time in
a collective runs from the end of the rank's queued device work to its
result.

It reads the collectives through ``DistributedComm``'s methods, so it runs
against any tree of the port that has them; put that tree's ``src`` first
on the path:

    PYTHONPATH=src python3 scripts/count_collectives.py \
        [--cell mamba|qwen|qwen_decode|mamba_decode]
        [--device cpu|cuda] [--steps 3] [--sites]

``--sites`` also gives calls, bytes and time of each kind by the two
innermost calling functions outside ``core/comm.py`` (the model code or
the autograd collective that called it).
"""

import argparse
import dataclasses
import json
import sys
import tempfile
import time
from pathlib import Path

import torch
import torch.multiprocessing as mp

KINDS = ("all_gather_group", "reduce_scatter", "all_reduce")
#: phase 38's cells: (arch, layers (None: all), fsdp, mesh, global batch,
#: microbatches); every one at 4,096 tokens a row
CELLS = {
    "qwen": ("qwen3_14b", 2, True, ((2, 2), ("data", "model")), 4, 1),
    "mamba": ("mamba2_130m", None, False, ((4, 2), ("data", "model")), 16,
              2),
}
SEQ = 4096
#: phase 39's cells: (arch, layers (None: all), mesh, global batch, cache
#: length); one decode token a step, from pos = length / 2 - 4
DECODE_CELLS = {
    "qwen_decode": ("qwen3_14b", 2, ((2, 2), ("data", "model")), 1, 32768),
    "mamba_decode": ("mamba2_130m", None, ((4, 2), ("data", "model")), 128,
                     32768),
}


def _site() -> str:
    """The two innermost calling functions outside core/comm.py and this
    script, as ``file:function < file:function``."""
    names, f = [], sys._getframe(2)
    while f is not None and len(names) < 2:
        name = Path(f.f_code.co_filename).name
        if name not in ("comm.py", "count_collectives.py"):
            names.append(f"{name}:{f.f_code.co_name}")
        f = f.f_back
    return " < ".join(names)


def _counted(fig: dict, cuda: bool, sites=None):
    """Wrap ``DistributedComm``'s group collectives to add, a call, one to
    ``fig["calls"][kind]``, the input's bytes to ``fig["bytes"][kind]`` and
    the host seconds to ``fig["s"][kind]`` (and the same three to
    ``sites[kind and caller]``, where given)."""
    from repro_torch.core.comm import DistributedComm
    for kind in KINDS:
        real = getattr(DistributedComm, kind)

        def wrapped(self, x, *a, _real=real, _kind=kind, **kw):
            if cuda:
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = _real(self, x, *a, **kw)
            fig["s"][_kind] += time.perf_counter() - t0
            fig["calls"][_kind] += 1
            fig["bytes"][_kind] += x.numel() * x.element_size()
            if sites is not None:
                c = sites.setdefault(f"{_kind} {_site()}", [0, 0, 0.0])
                c[0] += 1
                c[1] += x.numel() * x.element_size()
                c[2] += time.perf_counter() - t0
            return out
        setattr(DistributedComm, kind, wrapped)


def _rank(rank: int, cell: str, n: int, store: str, out: str, device: str,
          n_steps: int, by_site: bool) -> None:
    torch.set_num_threads(1)
    from repro_torch.configs import get_config
    from repro_torch.configs.registry import get_smoke_config
    from repro_torch.core.comm import DistributedComm
    from repro_torch.data import DataConfig, make_batch
    from repro_torch.launch import mesh as t_mesh, steps
    from repro_torch.models import lm
    from repro_torch.optim.adamw import AdamWConfig

    decode = cell in DECODE_CELLS
    if decode:
        arch, layers, (sizes, axes), batch, seq = DECODE_CELLS[cell]
        fsdp = get_config(arch).fsdp
    else:
        arch, layers, fsdp, (sizes, axes), batch, accum = CELLS[cell]
    cuda = device == "cuda"
    fig = {k: dict.fromkeys(KINDS, 0) for k in ("calls", "bytes", "s")}
    sites = {} if by_site else None
    _counted(fig, cuda, sites)
    comm = DistributedComm("gloo", rank=rank, world_size=n,
                           init_method=f"file://{store}", device=device)
    if cuda:
        cfg = get_config(arch)
    else:
        cfg = dataclasses.replace(get_smoke_config(arch),
                                  n_layers=get_config(arch).n_layers)
    cfg = dataclasses.replace(cfg, fsdp=fsdp,
                              n_layers=layers or cfg.n_layers)
    mesh = t_mesh.make_mesh(sizes, axes, comm=comm)
    if decode:
        shape = steps.decode_shape(batch, seq)
        params = t_mesh.shard_tree(
            lm.init_params(cfg, seed=0, device=comm.device),
            steps.param_and_opt_specs(cfg, mesh)[0], mesh)
        state = lm.init_decode_state(cfg, batch, seq, device=comm.device)
        state["pos"] = seq // 2 - 4
        state = steps.shard_decode_state(cfg, state, shape, mesh)
        serve_step = steps.build_serve_step(cfg, mesh=mesh)
        tokens = torch.zeros((batch, 1), dtype=torch.int32)

        def step(params, state, b):
            return serve_step(params, state, b)[1]
    else:
        params, opt = steps.shard_state(
            cfg, lm.init_params(cfg, seed=0, device=comm.device), mesh)
        train_step = steps.build_train_step(cfg, AdamWConfig(), accum=accum,
                                            mesh=mesh)
        dcfg = DataConfig(seed=0, vocab_size=cfg.vocab_size, batch=batch,
                          seq_len=SEQ)

        def step(params, opt, b):
            return train_step(params, opt, b)[:2]
    per_step = []
    for s in range(n_steps):
        if decode:
            b = torch.as_tensor(steps.decode_rows(cfg, tokens, shape, mesh),
                                device=comm.device)
        else:
            b = {k: torch.as_tensor(v, device=comm.device) for k, v in
                 steps.shard_batch(cfg, make_batch(dcfg, s), mesh).items()}
        for part in fig.values():
            part.update(dict.fromkeys(KINDS, 0))
        if sites is not None:
            sites.clear()
        if cuda:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        if decode:
            state = step(params, state, b)
        else:
            params, opt = step(params, opt, b)
        if cuda:
            torch.cuda.synchronize()
        per_step.append({"ms": (time.perf_counter() - t0) * 1e3,
                         **{k: dict(v) for k, v in fig.items()},
                         "sites": dict(sites or {})})
    Path(out, f"rank{rank}.json").write_text(json.dumps(per_step))
    torch.distributed.destroy_process_group()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cell", choices=sorted(CELLS) + sorted(DECODE_CELLS),
                    default="mamba")
    ap.add_argument("--device", choices=("cpu", "cuda"), default="cpu")
    ap.add_argument("--steps", type=int, default=2)
    ap.add_argument("--sites", action="store_true")
    args = ap.parse_args(argv)
    if args.device == "cuda":
        from repro_torch.kernels import _build
        _build.build()
    sizes = (DECODE_CELLS[args.cell][2] if args.cell in DECODE_CELLS
             else CELLS[args.cell][3])[0]
    n = 1
    for s in sizes:
        n *= s
    with tempfile.TemporaryDirectory() as tmp:
        mp.start_processes(_rank, args=(args.cell, n, str(Path(tmp, "store")),
                                        tmp, args.device, args.steps,
                                        args.sites),
                           nprocs=n, start_method="spawn")
        ranks = [json.loads(Path(tmp, f"rank{r}.json").read_text())
                 for r in range(n)]
    for r, per_step in enumerate(ranks):
        for i, st in enumerate(per_step):
            print(f"{args.cell} ({args.device}) rank {r} step {i}: "
                  f"{st['ms']:.1f} ms, {sum(st['calls'].values())} "
                  f"collectives, {sum(st['bytes'].values()) / 2**30:.4f} GiB"
                  f" in, {sum(st['s'].values()) * 1e3:.1f} ms in them ("
                  + ", ".join(f"{k} {st['calls'][k]} / "
                              f"{st['bytes'][k] / 2**30:.4f} GiB / "
                              f"{st['s'][k] * 1e3:.1f} ms" for k in KINDS)
                  + ")")
    for key, (c, nb, sec) in sorted(ranks[0][-1]["sites"].items()):
        print(f"rank 0, last step: {c:5d} calls {nb / 2**30:8.4f} GiB "
              f"{sec * 1e3:9.1f} ms  {key}")
    print(json.dumps({"cell": args.cell, "device": args.device,
                      "ranks": ranks}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
