"""Model configuration dataclass shared by all architectures (port of
``repro/models/config.py``; pure data, ``dtype`` a torch dtype)."""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """One frozen hyperparameter record describing a model family member
    (dense / ssm / hybrid / moe / audio / vlm), with the reference's
    fields that a model's function depends on.

    The port runs every family of the reference: layer kinds "A"
    (attention) and "M" (Mamba2) with their MLP or MoE blocks
    (``models/lm.py``, ``models/moe.py``), the encoder-decoder
    (``models/whisper.py``) and the vision-patch frontend, and trains
    them (``launch/train.py``).  ``remat`` recomputes each superblock's
    (and, in a multi-layer pattern, each layer's) activations in the
    backward pass, as the reference's ``jax.checkpoint`` does.  ``fsdp``
    shards the parameters' "F" dimensions over the data axes in the spec
    arithmetic of ``launch/mesh.py`` (the dry run reads it).  The
    reference's other sharding and compilation fields (``scan_layers``,
    ``attn_sp``, ``seq_shard``, ``dp_axes``, ``tp_axis``,
    ``unroll_inner``, ``moe_ec_constraint``) are left out: the port runs
    on one device, eagerly, and nothing here would read them."""
    name: str = "model"
    family: str = "dense"          # dense | ssm | hybrid | moe | audio | vlm
    n_layers: int = 2
    d_model: int = 64
    n_heads: int = 2
    n_kv_heads: int = 2
    head_dim: int = 0              # 0 -> d_model // n_heads
    d_ff: int = 128
    vocab_size: int = 256

    norm: str = "rmsnorm"          # rmsnorm | layernorm
    mlp: str = "swiglu"            # swiglu | gelu
    qk_norm: bool = False
    pos: str = "rope"              # rope | mrope | sincos | none
    rope_theta: float = 10_000.0
    mrope_sections: Tuple[int, int, int] = (16, 24, 24)  # t/h/w dims (qwen2-vl)
    window: Optional[int] = None   # sliding-window attention size

    # MoE
    moe_experts: int = 0
    moe_top_k: int = 0
    moe_every: int = 1             # every n-th layer is MoE (others dense)
    moe_shared: bool = False       # additional always-on shared expert
    capacity_factor: float = 1.25

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
    n_enc_layers: int = 0
    dec_ratio: int = 8             # T_dec = seq_len // dec_ratio in shape cells

    # modality frontend stubs
    frontend: Optional[str] = None  # audio_frames | vision_patches
    vis_tokens: int = 1024          # stub patch-embedding count (vlm)

    tie_embeddings: bool = False

    # numerics / execution
    dtype: object = torch.bfloat16
    remat: bool = True              # recompute activations in backward
    fsdp: bool = False              # shard params along the data axes too
    attn_block_k: int = 1024        # kv-block size for blocked attention
    attn_block_threshold: int = 4096  # windowed attention: blocked path when
                                      # T >= this (models/attention.py)

    def __post_init__(self):
        if self.head_dim == 0 and self.n_heads:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)

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
