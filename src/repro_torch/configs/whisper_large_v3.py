"""whisper-large-v3 [audio] — enc-dec, 32L decoder, d_model=1280 20H (kv=20)
d_ff=5120 vocab=51866 — conv/mel frontend is a STUB (input_specs provides
precomputed 1500-frame embeddings). [arXiv:2212.04356; unverified]"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-large-v3",
    family="encdec",
    num_layers=32,          # decoder layers
    encoder_layers=32,
    encoder_seq=1500,       # 30 s of mel frames after conv stride 2
    d_model=1280,
    num_heads=20,
    num_kv_heads=20,
    head_dim=64,
    d_ff=5120,
    vocab_size=51866,
    mlp_act="gelu",
    tie_embeddings=True,
    frontend="audio_stub",
)
