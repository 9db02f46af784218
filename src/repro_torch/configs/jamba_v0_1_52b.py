"""jamba-v0.1-52b [hybrid] — Mamba + attention 1:7 interleave, MoE 16e top-2
[arXiv:2403.19887].

32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=65536.  Superblock of 8
layers with attention at position 4 (Jamba's layout); MoE replaces the MLP on
every other layer (moe_every=2).  long_500k: RUNS (hybrid; only 4 attention
layers carry KV).
"""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="jamba_v0_1_52b",
    family="hybrid",
    n_layers=32,
    d_model=4096,
    n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=14_336,
    vocab_size=65_536,
    layer_pattern=("M", "M", "M", "M", "A", "M", "M", "M"),
    moe_experts=16, moe_top_k=2, moe_every=2,
    ssm_state=16, ssm_conv=4, ssm_expand=2, ssm_head_dim=64, ssm_chunk=256,
    fsdp=True,
)

SMOKE = ModelConfig(
    name="jamba_v0_1_52b_smoke",
    family="hybrid",
    n_layers=8,
    d_model=64,
    n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128,
    vocab_size=256,
    layer_pattern=("M", "M", "M", "M", "A", "M", "M", "M"),
    moe_experts=4, moe_top_k=2, moe_every=2,
    ssm_state=16, ssm_conv=4, ssm_expand=2, ssm_head_dim=16, ssm_chunk=16,
)
