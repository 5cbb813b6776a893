"""qwen2-vl-2b [vlm] — 28L d_model=1536 12H (GQA kv=2) d_ff=8960
vocab=151936 — M-RoPE, dynamic resolution. Vision frontend is a STUB:
input_specs provides precomputed patch embeddings mixed into the token
stream plus (t,h,w) position ids for M-RoPE. [arXiv:2409.12191; hf]"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-2b",
    family="vlm",
    num_layers=28,
    d_model=1536,
    num_heads=12,
    num_kv_heads=2,
    head_dim=128,
    d_ff=8960,
    vocab_size=151936,
    mrope=True,
    rope_theta=1_000_000.0,
    mlp_act="swiglu",
    tie_embeddings=True,
    frontend="vision_stub",
)
