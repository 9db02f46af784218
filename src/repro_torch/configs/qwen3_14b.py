"""qwen3-14b [dense] — qk_norm, GQA [hf:Qwen/Qwen3 family].

40L d_model=5120 40H (GQA kv=8) head_dim=128 d_ff=17408 vocab=151936.
long_500k: skipped (full attention).
"""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3_14b",
    family="dense",
    n_layers=40,
    d_model=5120,
    n_heads=40, n_kv_heads=8, head_dim=128,
    d_ff=17_408,
    vocab_size=151_936,
    qk_norm=True,
    rope_theta=1e6,
    fsdp=True,
)

SMOKE = ModelConfig(
    name="qwen3_14b_smoke",
    family="dense",
    n_layers=2,
    d_model=64,
    n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128,
    vocab_size=256,
    qk_norm=True,
)
