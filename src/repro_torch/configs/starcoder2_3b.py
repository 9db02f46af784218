"""starcoder2-3b [dense] — GQA, RoPE [arXiv:2402.19173].

30L d_model=3072 24H (kv=2) d_ff=12288 vocab=49152; layernorm + GELU MLP
(starcoder2 uses standard MLP, not gated).  long_500k: skipped (full attn).
"""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2_3b",
    family="dense",
    n_layers=30,
    d_model=3072,
    n_heads=24, n_kv_heads=2, head_dim=128,
    d_ff=12_288,
    vocab_size=49_152,
    norm="layernorm", mlp="gelu",
    rope_theta=1e5,
    fsdp=False,
)

SMOKE = ModelConfig(
    name="starcoder2_3b_smoke",
    family="dense",
    n_layers=2,
    d_model=64,
    n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128,
    vocab_size=256,
    norm="layernorm", mlp="gelu",
)
