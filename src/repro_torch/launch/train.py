"""Training driver: config -> parameters -> step loop with async
checkpointing and resume (port of ``repro/launch/train.py``).

    python -m repro_torch.launch.train --arch starcoder2_3b --smoke \\
        --steps 20 --device cpu [--ckpt-dir DIR]
    torchrun --standalone --nproc-per-node 4 -m repro_torch.launch.train \\
        --arch qwen3_14b --smoke --mesh data=2,model=2 --dist gloo \\
        --device cpu

Runs on the CUDA device unless ``--device`` says otherwise.  A ``--mesh``
of more than one device runs one process per device (``--dist gloo`` or
``nccl``, under torchrun; ROADMAP.md A.15c-d): each rank holds its shard
of the parameters, the AdamW moments and the batch and computes its part
on "model" (``launch/steps.py``), draws the global batch from (seed,
step) and keeps its rows, and rank 0 prints the losses.  A resume from the checkpoint of step k regenerates
the batches k, k+1, ... (the data pipeline seeds each batch by (seed,
step)); under a mesh a checkpoint holds the global tree, gathered leaf by
leaf and written by rank 0, so it resumes on another mesh or in one
process.  Encoder-decoder archs are refused, as the reference refuses
them.
"""

from __future__ import annotations

import argparse
import time

from ..ckpt import CheckpointManager
from ..configs import get_config, get_smoke_config
from ..configs.registry import ARCHS
from ..core.comm import DistributedComm, resolve_device
from ..data import DataConfig, make_pipeline
from ..models import lm
from ..models.common import tree_leaves
from ..optim import AdamWConfig, adamw_init
from . import steps as steps_mod
from .mesh import make_mesh, parse_mesh


def train(arch: str, *, smoke: bool = True, steps: int = 50, batch: int = 8,
          seq: int = 128, ckpt_dir: str | None = None, ckpt_every: int = 25,
          mesh_spec: str | None = None, lr: float = 3e-4,
          log_every: int = 10, resume: bool = True, seed: int = 0,
          device=None, dist: str | None = None, comm=None):
    """Train ``arch`` for ``steps`` on synthetic data; returns the losses
    of the steps run (from the resumed step on).  A ``mesh_spec`` of more
    than one device needs ``dist`` (this process is a torchrun rank) or a
    ``comm`` of as many ranks (``core.comm.DistributedComm``)."""
    cfg = get_smoke_config(arch) if smoke else get_config(arch)
    if cfg.encdec:
        raise SystemExit("use examples/train_lm.py families; enc-dec training "
                         "is exercised by tests/smoke")
    dev = resolve_device(device)
    own = comm is None and dist is not None
    if own:
        comm = DistributedComm.from_env(dist, dev)
    try:
        return _train(cfg, steps, batch, seq, ckpt_dir, ckpt_every,
                      mesh_spec, lr, log_every, resume, seed, dev, comm)
    finally:
        if own:
            comm.close()


def _train(cfg, steps, batch, seq, ckpt_dir, ckpt_every, mesh_spec, lr,
           log_every, resume, seed, dev, comm):
    mesh = None
    if mesh_spec:
        mesh = make_mesh(*parse_mesh(mesh_spec), device=dev, comm=comm)
        if mesh.comm is None:
            mesh = None                     # one device: today's path
        else:
            dev = mesh.device
    rank0 = mesh is None or mesh.comm.rank == 0

    opt_cfg = AdamWConfig(lr=lr, warmup_steps=max(2, steps // 20),
                          total_steps=steps)
    train_step = steps_mod.build_train_step(cfg, opt_cfg, mesh=mesh)

    params = lm.init_params(cfg, seed, device=dev)
    if mesh is None:
        opt_state = adamw_init(params)
        ckpt = {}
    else:
        params, opt_state = steps_mod.shard_state(cfg, params, mesh)
        p_specs, o_specs = steps_mod.param_and_opt_specs(cfg, mesh)
        spec_of = {"1/count": ()}
        for prefix, tree in (("0", p_specs), ("1/m", o_specs["m"]),
                             ("1/v", o_specs["v"])):
            spec_of.update({f"{prefix}/" + "/".join(path): spec
                            for path, spec in tree_leaves(tree)})
        ckpt = dict(
            gather=lambda name, t: mesh.gather(t, spec_of[name]),
            write=rank0)
    start = 0

    mgr = CheckpointManager(ckpt_dir) if ckpt_dir else None
    if mgr and resume:
        try:
            cut = None if mesh is None else \
                (lambda name, a: mesh.cut(a, spec_of[name]))
            (params, opt_state), start = mgr.restore_latest(
                (params, opt_state), cut=cut)
            if rank0:
                print(f"resumed from step {start}")
        except FileNotFoundError:
            pass

    dcfg = DataConfig(seed=seed, vocab_size=cfg.vocab_size, batch=batch,
                      seq_len=seq, frontend=cfg.frontend,
                      d_model=cfg.d_model, vis_tokens=min(cfg.vis_tokens, 8),
                      dec_ratio=cfg.dec_ratio)
    pipe = make_pipeline(
        dcfg, device=dev, start_step=start,
        shard=None if mesh is None
        else (lambda b: steps_mod.shard_batch(cfg, b, mesh)))

    losses = []
    t0 = time.time()
    try:
        for step in range(start, steps):
            params, opt_state, metrics = train_step(params, opt_state,
                                                    next(pipe))
            losses.append(float(metrics["loss"]))
            if rank0 and (step % log_every == 0 or step == steps - 1):
                dt = time.time() - t0
                print(f"step {step:5d} loss {losses[-1]:.4f} "
                      f"ce {float(metrics['ce']):.4f} "
                      f"gnorm {float(metrics['grad_norm']):.3f} "
                      f"({dt:.1f}s)", flush=True)
            if mgr and ckpt_every and (step + 1) % ckpt_every == 0:
                mgr.save_async(step + 1, (params, opt_state), **ckpt)
    finally:
        pipe.close()
    if mgr:
        mgr.wait()
        mgr.save_async(steps, (params, opt_state), **ckpt)
        mgr.wait()
    if mesh is not None:
        mesh.comm.barrier()       # rank 0's files are written
    return losses


def main(argv=None):
    """CLI driver for :func:`train`."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=list(ARCHS), required=True)
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--full", dest="smoke", action="store_false")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--mesh", dest="mesh_spec", default=None,
                    help='e.g. "data=2,model=2" (more than one device '
                         'needs --dist)')
    ap.add_argument("--dist", choices=("gloo", "nccl"), default=None,
                    help="run as a torchrun rank over this transport")
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    args = ap.parse_args(argv)
    train(args.arch, smoke=args.smoke, steps=args.steps, batch=args.batch,
          seq=args.seq, ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
          mesh_spec=args.mesh_spec, lr=args.lr, device=args.device,
          dist=args.dist)


if __name__ == "__main__":
    main()
