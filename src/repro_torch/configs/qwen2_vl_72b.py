"""qwen2-vl-72b [vlm] — M-RoPE, dynamic resolution [arXiv:2409.12191].

80L d_model=8192 64H (GQA kv=8) d_ff=29568 vocab=152064.  The vision
frontend is a STUB: input_specs provides precomputed patch embeddings
[B, vis_tokens, d] fused in front of the text tokens (early fusion);
M-RoPE sections (16, 24, 24) over head_dim/2 = 64.
long_500k: skipped (full attention).
"""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2_vl_72b",
    family="vlm",
    n_layers=80,
    d_model=8192,
    n_heads=64, n_kv_heads=8, head_dim=128,
    d_ff=29_568,
    vocab_size=152_064,
    pos="mrope", mrope_sections=(16, 24, 24),
    frontend="vision_patches", vis_tokens=1024,
    rope_theta=1e6,
    fsdp=True,
)

SMOKE = ModelConfig(
    name="qwen2_vl_72b_smoke",
    family="vlm",
    n_layers=2,
    d_model=64,
    n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128,
    vocab_size=256,
    pos="mrope", mrope_sections=(4, 2, 2),
    frontend="vision_patches", vis_tokens=8,
)
