"""jamba-v0.1-52b [hybrid] — 32L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=65536, MoE 16e top-2, mamba:attn 7:1 interleave (attention at layer
offset 7 of each period-8 block), MoE every 2 layers. Runs long_500k: the 4
attention layers use a 262k sliding window at 500k context.
[arXiv:2403.19887; hf]"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=65536,
    num_experts=16,
    experts_per_token=2,
    moe_every=2,
    attn_period=8,
    attn_offset=7,
    ssm_state=16,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_groups=1,
    ssm_chunk=128,
    mlp_act="swiglu",
)
