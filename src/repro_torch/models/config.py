"""Model configuration dataclass shared by all architectures (port of
``repro/models/config.py``; pure data, ``dtype`` a torch dtype)."""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """One frozen hyperparameter record describing a model family member.

    The port holds the fields that its Mamba2 family reads, and the ones
    that tell an unported family apart (layer kind "A", MoE, encoder-
    decoder, frontends), which raise ``NotImplementedError``.  The
    reference's attention, MoE-routing and execution fields (heads, RoPE,
    windows, remat, sharding axes, ...) come with the families that read
    them (ROADMAP.md A.17)."""
    name: str = "model"
    family: str = "dense"          # dense | ssm | hybrid | moe | audio | vlm
    n_layers: int = 2
    d_model: int = 64
    d_ff: int = 128
    vocab_size: int = 256

    norm: str = "rmsnorm"          # rmsnorm | layernorm

    # MoE
    moe_experts: int = 0
    moe_every: int = 1             # every n-th layer is MoE (others dense)

    # Mamba2 / SSD
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_chunk: int = 256

    # hybrid stacks: repeating pattern, "A"=attention, "M"=mamba
    layer_pattern: Optional[Tuple[str, ...]] = None

    # encoder-decoder (whisper backbone)
    encdec: bool = False

    # modality frontend stubs
    frontend: Optional[str] = None  # audio_frames | vision_patches

    tie_embeddings: bool = False

    dtype: object = torch.bfloat16

    # ---- derived -----------------------------------------------------------
    @property
    def out_scale(self) -> float:
        """GPT-2-style depth-scaled init for residual-branch output
        projections."""
        return 1.0 / math.sqrt(max(1, 2 * self.n_layers))

    @property
    def d_inner(self) -> int:
        """Mamba2 inner width (expand * d_model)."""
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        """SSM head count implied by inner width / head dim."""
        return max(1, self.d_inner // self.ssm_head_dim)

    def pattern(self) -> Tuple[str, ...]:
        """Per-layer kinds for one repeating superblock."""
        if self.layer_pattern is not None:
            return self.layer_pattern
        if self.family == "ssm":
            return ("M",)
        reps = self.moe_every if self.moe_experts else 1
        return ("A",) * max(1, reps)

    @property
    def n_superblocks(self) -> int:
        """How many times the layer pattern repeats."""
        pat = self.pattern()
        if self.n_layers % len(pat):
            raise ValueError(f"n_layers={self.n_layers} is not a multiple "
                             f"of the pattern {pat}")
        return self.n_layers // len(pat)

    def is_moe_layer(self, layer_in_pattern: int) -> bool:
        """True iff this pattern position carries the MoE MLP."""
        if self.moe_experts == 0:
            return False
        return layer_in_pattern % self.moe_every == (self.moe_every - 1)
