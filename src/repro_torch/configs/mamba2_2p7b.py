"""mamba2-2.7b [ssm] — 64L d_model=2560 attention-free, vocab=50280,
ssm_state=128 — SSD (state-space duality). Runs long_500k (O(1)/token
state). [arXiv:2405.21060; unverified]"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-2.7b",
    family="ssm",
    num_layers=64,
    d_model=2560,
    num_heads=0,
    num_kv_heads=0,
    head_dim=80,  # placeholder (no attention)
    d_ff=0,       # mamba blocks have no separate FFN
    vocab_size=50280,
    ssm_state=128,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_groups=1,
    ssm_chunk=128,
    tie_embeddings=True,
)
