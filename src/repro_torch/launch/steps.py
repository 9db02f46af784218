"""The prefill and decode steps (port of the prefill and serve steps of
``repro/launch/steps.py``; there is no mesh or sharding spec yet):

  prefill -> prefill_step(params, batch)            (last-position logits)
  decode  -> serve_step(params, state, tokens)      (one token, carried)
"""

from __future__ import annotations

import torch

from ..models import lm
from ..models.config import ModelConfig


def build_prefill_step(cfg: ModelConfig):
    """Returns last-position logits (the sampled-token distribution)."""
    if cfg.encdec:
        raise NotImplementedError("encoder-decoder prefill is not ported yet "
                                  "(ROADMAP.md A.17)")

    @torch.inference_mode()
    def prefill_step(params, batch):
        x, _aux = lm.forward_hidden(cfg, params, batch)
        unembed = params["embed"].T if cfg.tie_embeddings else params["unembed"]
        return (x[:, -1] @ unembed).float()

    return prefill_step


def build_serve_step(cfg: ModelConfig):
    """One-token decode step closure over the model family."""
    if cfg.encdec:
        raise NotImplementedError("encoder-decoder decoding is not ported "
                                  "yet (ROADMAP.md A.17)")

    def serve_step(params, state, tokens):
        return lm.decode_step(cfg, params, state, tokens)

    return serve_step
