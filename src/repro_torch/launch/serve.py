"""Serving entry point: batched greedy decoding with the carried decode state
(port of ``repro/launch/serve.py``).

    python -m repro_torch.launch.serve --arch mamba2_130m [--smoke] [--device cpu]
    python -m repro_torch.launch.serve --arch qwen3_14b [--smoke] [--device cpu]
    python -m repro_torch.launch.serve --arch jamba_v0_1_52b --smoke --device cpu

The prompt is teacher-forced token by token, then ``gen_len`` tokens are
decoded greedily.  Runs on the CUDA device unless ``device`` says
otherwise.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..configs import get_config, get_smoke_config
from ..configs.registry import ARCHS
from ..core.comm import resolve_device
from ..models import lm
from . import steps as steps_mod


def serve(arch: str, *, smoke: bool = True, batch: int = 4,
          prompt_len: int = 16, gen_len: int = 32, seed: int = 0,
          device=None, params=None):
    """Teacher-force a random prompt and decode ``gen_len`` tokens with the
    arch's LM.  ``params``: the parameter tree (e.g. from
    ``lm.params_from_numpy``), else initialized from ``seed``.  Returns
    the token sequences [batch, prompt_len + gen_len] as numpy."""
    cfg = get_smoke_config(arch) if smoke else get_config(arch)
    if cfg.encdec:
        # as the reference: whisper decodes through models/whisper.py
        # (tests/test_torch_whisper.py), not through this loop
        raise SystemExit("enc-dec serving is exercised in tests (whisper)")
    dev = resolve_device(device)
    if params is None:
        params = lm.init_params(cfg, seed, device=dev)
    max_len = prompt_len + gen_len
    state = lm.init_decode_state(cfg, batch, max_len, device=dev)
    step = steps_mod.build_serve_step(cfg)

    rng = np.random.default_rng(seed)
    prompt = rng.integers(0, cfg.vocab_size, size=(batch, prompt_len))
    prompt_t = torch.as_tensor(prompt, dtype=torch.int32, device=dev)
    toks = prompt_t[:, :1]
    out = [toks]
    t0 = time.perf_counter()
    for t in range(max_len - 1):
        logits, state = step(params, state, toks)
        if t + 1 < prompt_len:           # teacher-forced prompt phase
            toks = prompt_t[:, t + 1:t + 2]
        else:                            # greedy generation
            toks = torch.argmax(logits[:, -1], dim=-1)[:, None].to(torch.int32)
        out.append(toks)
    seqs = torch.cat(out, dim=1).cpu().numpy()
    dt = time.perf_counter() - t0
    tps = batch * (max_len - 1) / dt
    print(f"decoded {batch}x{max_len} tokens in {dt:.2f}s ({tps:.1f} tok/s, "
          f"{1e3 * dt / max(1, max_len - 1):.3f} ms/step) on {dev}")
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
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    args = ap.parse_args(argv)
    serve(args.arch, smoke=args.smoke, batch=args.batch,
          prompt_len=args.prompt_len, gen_len=args.gen_len,
          device=args.device)


if __name__ == "__main__":
    main()
