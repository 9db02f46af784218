"""Serving entry point: batched greedy decoding with the carried decode state
(port of ``repro/launch/serve.py``).

    python -m repro_torch.launch.serve --arch mamba2_130m [--smoke] [--device cpu]
    python -m repro_torch.launch.serve --arch qwen3_14b [--smoke] [--device cpu]
    python -m repro_torch.launch.serve --arch jamba_v0_1_52b --smoke --device cpu
    torchrun --standalone --nproc-per-node 4 -m repro_torch.launch.serve \\
        --arch qwen3_14b --smoke --mesh data=2,model=2 --dist gloo \\
        --device cpu

The prompt is teacher-forced token by token, then ``gen_len`` tokens are
decoded greedily.  Runs on the CUDA device unless ``device`` says
otherwise.  Under torchrun (``--dist gloo`` or ``nccl``; ROADMAP.md
A.15d(2)) each rank is one device of a mesh, by default ``(data=world,
model=1)`` as the reference's serve loop makes one data axis of every
device, else ``--mesh``: each rank holds its shard of the parameters and
of the decode state (``launch/steps.py``'s serve step), decodes its rows
of the batch (all of them where the dp extent does not divide it),
takes the greedy argmax of its rows' whole-vocabulary logits, and the
sequences are gathered over the dp axes, so every rank returns the same
array; rank 0 prints.  Encoder-decoder archs are refused, as the
reference refuses them.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..configs import get_config, get_smoke_config
from ..configs.registry import ARCHS
from ..core.comm import DistributedComm, resolve_device
from ..models import lm
from . import steps as steps_mod
from .mesh import make_mesh, parse_mesh, shard_tree


def serve(arch: str, *, smoke: bool = True, batch: int = 4,
          prompt_len: int = 16, gen_len: int = 32, seed: int = 0,
          device=None, params=None, mesh_spec: str | None = None,
          dist: str | None = None, comm=None):
    """Teacher-force a random prompt and decode ``gen_len`` tokens with the
    arch's LM.  ``params``: the parameter tree (e.g. from
    ``lm.params_from_numpy``), else initialized from ``seed``.  Returns
    the token sequences [batch, prompt_len + gen_len] as numpy.  A mesh
    of ranks needs ``dist`` (this process is a torchrun rank) or a
    ``comm`` of as many ranks (``core.comm.DistributedComm``);
    ``mesh_spec`` (e.g. ``"data=2,model=2"``) defaults to ``(data=ranks,
    model=1)`` there."""
    cfg = get_smoke_config(arch) if smoke else get_config(arch)
    if cfg.encdec:
        # as the reference: whisper decodes through models/whisper.py
        # (tests/test_torch_whisper.py), not through this loop
        raise SystemExit("enc-dec serving is exercised in tests (whisper)")
    dev = resolve_device(device)
    own = comm is None and dist is not None
    if own:
        comm = DistributedComm.from_env(dist, dev)
    try:
        return _serve(cfg, batch, prompt_len, gen_len, seed, dev, params,
                      mesh_spec, comm)
    finally:
        if own:
            comm.close()


def _serve(cfg, batch, prompt_len, gen_len, seed, dev, params, mesh_spec,
           comm):
    mesh = None
    if mesh_spec or comm is not None:
        mesh = make_mesh(*parse_mesh(mesh_spec or f"data={comm.P},model=1"),
                         device=dev, comm=comm)
        if mesh.comm is None:
            mesh = None                     # one device: one process's path
        else:
            dev = mesh.device
    if params is None:
        params = lm.init_params(cfg, seed, device=dev)
    max_len = prompt_len + gen_len
    state = lm.init_decode_state(cfg, batch, max_len, device=dev)
    step = steps_mod.build_serve_step(cfg, mesh=mesh)

    rng = np.random.default_rng(seed)
    prompt = rng.integers(0, cfg.vocab_size, size=(batch, prompt_len))
    prompt_t = torch.as_tensor(prompt, dtype=torch.int32, device=dev)
    if mesh is None:
        def rows(t):
            return t
    else:
        shape = steps_mod.decode_shape(batch, max_len)
        params = shard_tree(params, steps_mod.param_and_opt_specs(
            cfg, mesh)[0], mesh)
        state = steps_mod.shard_decode_state(cfg, state, shape, mesh)

        def rows(t):
            return steps_mod.decode_rows(cfg, t, shape, mesh)
    toks = rows(prompt_t[:, :1])
    out = [toks]
    t0 = time.perf_counter()
    for t in range(max_len - 1):
        logits, state = step(params, state, toks)
        if t + 1 < prompt_len:           # teacher-forced prompt phase
            toks = rows(prompt_t[:, t + 1:t + 2])
        else:                            # greedy generation
            toks = torch.argmax(logits[:, -1], dim=-1)[:, None].to(torch.int32)
        out.append(toks)
    seqs = torch.cat(out, dim=1)
    if mesh is not None and steps_mod.batch_split(shape, mesh):
        seqs = mesh.dp.gather(seqs).reshape(batch, max_len)
    seqs = seqs.cpu().numpy()
    dt = time.perf_counter() - t0
    tps = batch * (max_len - 1) / dt
    if mesh is None or mesh.comm.rank == 0:
        where = dev if mesh is None else \
            f"{mesh.size} ranks {mesh.shape} ({mesh.comm.transport})"
        print(f"decoded {batch}x{max_len} tokens in {dt:.2f}s "
              f"({tps:.1f} tok/s, {1e3 * dt / max(1, max_len - 1):.3f} "
              f"ms/step) on {where}")
    return seqs


def main(argv=None):
    """Command-line entry point for :func:`serve`."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=list(ARCHS), required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="the arch's reduced smoke config")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen-len", type=int, default=32)
    ap.add_argument("--mesh", dest="mesh_spec", default=None,
                    help='e.g. "data=2,model=2" (more than one device '
                         'needs --dist; under torchrun the default is '
                         'data=<ranks>,model=1)')
    ap.add_argument("--dist", choices=("gloo", "nccl"), default=None,
                    help="run as a torchrun rank over this transport")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    args = ap.parse_args(argv)
    serve(args.arch, smoke=args.smoke, batch=args.batch,
          prompt_len=args.prompt_len, gen_len=args.gen_len,
          device=args.device, mesh_spec=args.mesh_spec, dist=args.dist)


if __name__ == "__main__":
    main()
