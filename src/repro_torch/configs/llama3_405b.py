"""llama3-405b [dense] — 126L d_model=16384 128H (GQA kv=8) d_ff=53248
vocab=128256 — GQA, 128k vocab. [arXiv:2407.21783; unverified]

Training state uses bf16 params + f32 master moments sharded FSDP×TP; see
dist/sharding_rules.py. long_500k is skipped (pure full attention)."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama3-405b",
    family="dense",
    num_layers=126,
    d_model=16384,
    num_heads=128,
    num_kv_heads=8,
    head_dim=128,
    d_ff=53248,
    vocab_size=128256,
    rope_theta=500_000.0,
    mlp_act="swiglu",
    param_dtype="bfloat16",  # 405B f32 params would not fit 256 chips
    fsdp_over_pod=True,
    opt_state_dtype="bfloat16",
)
