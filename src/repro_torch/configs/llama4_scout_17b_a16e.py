"""llama4-scout-17b-a16e [moe] — MoE 16e top-1, shared expert, early fusion
[hf:meta-llama/Llama-4-Scout-17B-16E].

48L d_model=5120 40H (GQA kv=8) expert d_ff=8192 vocab=202048; every layer is
MoE (16 routed experts, top-1) + an always-on shared expert.
long_500k: skipped (full attention).
"""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama4_scout_17b_a16e",
    family="moe",
    n_layers=48,
    d_model=5120,
    n_heads=40, n_kv_heads=8, head_dim=128,
    d_ff=8192,
    vocab_size=202_048,
    moe_experts=16, moe_top_k=1, moe_every=1, moe_shared=True,
    rope_theta=5e5,
    fsdp=True,
)

SMOKE = ModelConfig(
    name="llama4_scout_smoke",
    family="moe",
    n_layers=2,
    d_model=64,
    n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128,
    vocab_size=256,
    moe_experts=4, moe_top_k=1, moe_every=1, moe_shared=True,
)
