"""llama4-maverick-400b-a17b [moe] — MoE 128e top-1, shared expert
[hf:meta-llama/Llama-4-Maverick family].

48L d_model=5120 40H (GQA kv=8) expert d_ff=8192 vocab=202048; MoE on
alternating layers (maverick interleaves dense/MoE), 128 routed experts,
top-1 + shared expert.  ~400B total, ~17B active.
long_500k: skipped (full attention).
"""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama4_maverick_400b_a17b",
    family="moe",
    n_layers=48,
    d_model=5120,
    n_heads=40, n_kv_heads=8, head_dim=128,
    d_ff=8192,
    vocab_size=202_048,
    moe_experts=128, moe_top_k=1, moe_every=2, moe_shared=True,
    rope_theta=5e5,
    fsdp=True,
)

SMOKE = ModelConfig(
    name="llama4_maverick_smoke",
    family="moe",
    n_layers=2,
    d_model=64,
    n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128,
    vocab_size=256,
    moe_experts=8, moe_top_k=1, moe_every=2, moe_shared=True,
)
