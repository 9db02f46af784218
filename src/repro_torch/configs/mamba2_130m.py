"""mamba2-130m [ssm] — SSD, attention-free [arXiv:2405.21060].

24L d_model=768, no attention (d_ff=0: the Mamba2 block carries the MLP role),
vocab 50280, ssm_state=128.  The paper's quorum technique does not apply to
token mixing here; the arch runs without it.  long_500k: runs (linear-time
scan, O(1) decode state).
"""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="mamba2_130m",
    family="ssm",
    n_layers=24,
    d_model=768,
    n_heads=0, n_kv_heads=0, head_dim=64,
    d_ff=0,
    vocab_size=50_280,
    layer_pattern=("M",),
    ssm_state=128, ssm_conv=4, ssm_expand=2, ssm_head_dim=64, ssm_chunk=256,
    tie_embeddings=True,
    fsdp=False,
)

SMOKE = ModelConfig(
    name="mamba2_130m_smoke",
    family="ssm",
    n_layers=2,
    d_model=64,
    n_heads=0, n_kv_heads=0, head_dim=16,
    d_ff=0,
    vocab_size=256,
    layer_pattern=("M",),
    ssm_state=16, ssm_conv=4, ssm_expand=2, ssm_head_dim=16, ssm_chunk=16,
    tie_embeddings=True,
)
