"""h2o-danube-1.8b [dense] — llama+mistral mix, sliding-window attention
[arXiv:2401.16818].

24L d_model=2560 32H (GQA kv=8) d_ff=6912 vocab=32000, SWA window 4096.
long_500k: RUNS — SWA is sub-quadratic and the decode cache is O(window).
"""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="h2o_danube_1_8b",
    family="dense",
    n_layers=24,
    d_model=2560,
    n_heads=32, n_kv_heads=8, head_dim=80,
    d_ff=6912,
    vocab_size=32_000,
    window=4096,
    fsdp=False,
)

SMOKE = ModelConfig(
    name="h2o_danube_1_8b_smoke",
    family="dense",
    n_layers=2,
    d_model=64,
    n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128,
    vocab_size=256,
    window=16,
)
