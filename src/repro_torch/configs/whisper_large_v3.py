"""whisper-large-v3 [audio] — encoder-decoder backbone [arXiv:2212.04356].

32 enc + 32 dec layers, d_model=1280 20H (kv=20, MHA) d_ff=5120 vocab=51866.
The conv audio frontend is a STUB: input_specs provides precomputed frame
embeddings [B, T_enc, d].  Decoder length = seq_len // dec_ratio for train
cells; decode cells run one decoder token against a seq_len-frame cross-KV.
long_500k: skipped (quadratic encoder self-attention).
"""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper_large_v3",
    family="audio",
    encdec=True,
    n_layers=32, n_enc_layers=32,
    d_model=1280,
    n_heads=20, n_kv_heads=20, head_dim=64,
    d_ff=5120,
    vocab_size=51_866,
    norm="layernorm", mlp="gelu", pos="sincos",
    frontend="audio_frames",
    tie_embeddings=True,
    dec_ratio=8,
    fsdp=False,
)

SMOKE = ModelConfig(
    name="whisper_large_v3_smoke",
    family="audio",
    encdec=True,
    n_layers=2, n_enc_layers=2,
    d_model=64,
    n_heads=4, n_kv_heads=4, head_dim=16,
    d_ff=128,
    vocab_size=256,
    norm="layernorm", mlp="gelu", pos="sincos",
    frontend="audio_frames",
    tie_embeddings=True,
    dec_ratio=8,
)
