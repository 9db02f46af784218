"""The prefill and decode steps (port of the prefill and serve steps of
``repro/launch/steps.py``; there is no mesh or sharding spec yet):

  prefill -> prefill_step(params, batch)            (last-position logits)
  decode  -> serve_step(params, state, tokens)      (one token, carried)
"""

from __future__ import annotations

import torch

from ..models import lm, whisper
from ..models.config import ModelConfig


def model_module(cfg: ModelConfig):
    """The model family module (lm or whisper) for this config."""
    return whisper if cfg.encdec else lm


def build_prefill_step(cfg: ModelConfig):
    """Returns last-position logits (the sampled-token distribution)."""
    if cfg.encdec:
        @torch.inference_mode()
        def prefill_step(params, batch):
            memory = whisper.encode(cfg, params, batch["frames"])
            logits = whisper.decode_train(cfg, params, batch["tokens"],
                                          memory)
            return logits[:, -1]
        return prefill_step

    @torch.inference_mode()
    def prefill_step(params, batch):
        x, _aux = lm.forward_hidden(cfg, params, batch)
        unembed = params["embed"].T if cfg.tie_embeddings else params["unembed"]
        return (x[:, -1] @ unembed).float()

    return prefill_step


def build_serve_step(cfg: ModelConfig):
    """One-token decode step closure over the model family."""
    mod = model_module(cfg)

    def serve_step(params, state, tokens):
        return mod.decode_step(cfg, params, state, tokens)

    return serve_step
