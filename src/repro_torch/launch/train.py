"""Training driver: config -> parameters -> step loop with async
checkpointing and resume (port of ``repro/launch/train.py``).

    python -m repro_torch.launch.train --arch starcoder2_3b --smoke \\
        --steps 20 --device cpu [--ckpt-dir DIR]

Runs on the CUDA device unless ``--device`` says otherwise, on one device
(a larger ``--mesh`` raises until ROADMAP.md A.15c).  A resume from the
checkpoint of step k regenerates the batches k, k+1, ... (the data
pipeline seeds each batch by (seed, step)).  Encoder-decoder archs are
refused, as the reference refuses them.
"""

from __future__ import annotations

import argparse
import time

from ..ckpt import CheckpointManager
from ..configs import get_config, get_smoke_config
from ..configs.registry import ARCHS
from ..core.comm import resolve_device
from ..data import DataConfig, make_pipeline
from ..models import lm
from ..optim import AdamWConfig, adamw_init
from . import steps as steps_mod
from .mesh import make_mesh


def train(arch: str, *, smoke: bool = True, steps: int = 50, batch: int = 8,
          seq: int = 128, ckpt_dir: str | None = None, ckpt_every: int = 25,
          mesh_spec: str | None = None, lr: float = 3e-4,
          log_every: int = 10, resume: bool = True, seed: int = 0,
          device=None):
    """Train ``arch`` for ``steps`` on synthetic data; returns the losses
    of the steps run (from the resumed step on)."""
    cfg = get_smoke_config(arch) if smoke else get_config(arch)
    if cfg.encdec:
        raise SystemExit("use examples/train_lm.py families; enc-dec training "
                         "is exercised by tests/smoke")
    dev = resolve_device(device)
    if mesh_spec:
        names, sizes = zip(*(kv.split("=") for kv in mesh_spec.split(",")))
        make_mesh(tuple(int(s) for s in sizes), tuple(names), device=dev)

    opt_cfg = AdamWConfig(lr=lr, warmup_steps=max(2, steps // 20),
                          total_steps=steps)
    train_step = steps_mod.build_train_step(cfg, opt_cfg)

    params = lm.init_params(cfg, seed, device=dev)
    opt_state = adamw_init(params)
    start = 0

    mgr = CheckpointManager(ckpt_dir) if ckpt_dir else None
    if mgr and resume:
        try:
            (params, opt_state), start = mgr.restore_latest(
                (params, opt_state))
            print(f"resumed from step {start}")
        except FileNotFoundError:
            pass

    dcfg = DataConfig(seed=seed, vocab_size=cfg.vocab_size, batch=batch,
                      seq_len=seq, frontend=cfg.frontend,
                      d_model=cfg.d_model, vis_tokens=min(cfg.vis_tokens, 8),
                      dec_ratio=cfg.dec_ratio)
    pipe = make_pipeline(dcfg, device=dev, start_step=start)

    losses = []
    t0 = time.time()
    try:
        for step in range(start, steps):
            params, opt_state, metrics = train_step(params, opt_state,
                                                    next(pipe))
            losses.append(float(metrics["loss"]))
            if step % log_every == 0 or step == steps - 1:
                dt = time.time() - t0
                print(f"step {step:5d} loss {losses[-1]:.4f} "
                      f"ce {float(metrics['ce']):.4f} "
                      f"gnorm {float(metrics['grad_norm']):.3f} "
                      f"({dt:.1f}s)", flush=True)
            if mgr and ckpt_every and (step + 1) % ckpt_every == 0:
                mgr.save_async(step + 1, (params, opt_state))
    finally:
        pipe.close()
    if mgr:
        mgr.wait()
        mgr.save_async(steps, (params, opt_state))
        mgr.wait()
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
                    help='e.g. "data=1" (one device until ROADMAP A.15c)')
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    args = ap.parse_args(argv)
    train(args.arch, smoke=args.smoke, steps=args.steps, batch=args.batch,
          seq=args.seq, ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
          mesh_spec=args.mesh_spec, lr=args.lr, device=args.device)


if __name__ == "__main__":
    main()
