"""deepseek-coder-33b [dense] — llama-arch [arXiv:2401.14196].

62L d_model=7168 56H (GQA kv=8) d_ff=19200 vocab=32256; RMSNorm + SwiGLU.
long_500k: skipped (full attention).
"""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="deepseek_coder_33b",
    family="dense",
    n_layers=62,
    d_model=7168,
    n_heads=56, n_kv_heads=8, head_dim=128,
    d_ff=19_200,
    vocab_size=32_256,
    rope_theta=1e5,
    fsdp=True,
)

SMOKE = ModelConfig(
    name="deepseek_coder_33b_smoke",
    family="dense",
    n_layers=2,
    d_model=64,
    n_heads=8, n_kv_heads=2, head_dim=8,
    d_ff=160,
    vocab_size=256,
)
