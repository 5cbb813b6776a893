"""kimi-k2-1t-a32b [moe] — 61L d_model=7168 64H (GQA kv=8) per-expert
d_ff=2048 vocab=163840, MoE 384 experts top-8, first layer dense —
trillion-param MoE. [arXiv:2501.kimi2; unverified]"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b",
    family="moe",
    num_layers=61,
    d_model=7168,
    num_heads=64,
    num_kv_heads=8,
    head_dim=112,  # 7168/64
    d_ff=2048,     # per-expert FFN width
    vocab_size=163840,
    num_experts=384,
    experts_per_token=8,
    first_dense_layers=1,
    rope_theta=50_000.0,
    mlp_act="swiglu",
    param_dtype="bfloat16",  # 1T params: bf16 + sharded state
    fsdp_over_pod=True,
    opt_state_dtype="bfloat16",
)
