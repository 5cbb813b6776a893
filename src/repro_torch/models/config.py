"""Unified model configuration covering all assigned architecture families.

A field-for-field copy of the JAX package's ``repro.models.config`` (the port
imports nothing of ``repro``), so a config built here equals its JAX twin,
plus three fields of the port's own (``norm_type``, ``norm_eps``,
``use_bias``) whose defaults are the JAX block.
One ``ModelConfig`` describes dense GQA transformers, MoE, SSM (mamba2/SSD),
hybrid (jamba), encoder-decoder (whisper) and VLM-backbone (qwen2-vl) models.
``repro_torch/configs/<id>.py`` instantiate the exact assigned configs; smoke
tests use ``scaled_down()`` reductions of the same family.

``attn_impl`` on the port: on a CUDA tensor every value runs the hand-written
Hopper kernels; on a CPU tensor ``"xla"`` runs the ``_attn_chunked`` twin and
``"pallas*"`` runs the kernels' plain versions.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | encdec | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 => d_model // num_heads

    # attention details
    qk_norm: bool = False
    rope_theta: float = 10_000.0
    mrope: bool = False  # qwen2-vl multimodal RoPE (sectioned rotary)
    attn_window: int = 0  # 0 = full; >0 = sliding-window attention
    tie_embeddings: bool = False
    attn_logit_softcap: float = 0.0

    # MLP
    mlp_act: str = "swiglu"  # swiglu | gelu

    # The port's own fields (the JAX config has none of them; their defaults
    # are its block): the decoder's block norms and final norm, "rms"
    # (RMSNorm, a scale) or "layer" (LayerNorm, a scale and a shift), their
    # eps (also the mamba2 mixer's gated RMSNorm's), and biases on q, k, v,
    # o and both dense MLP projections (starcoder2's published block).
    norm_type: str = "rms"  # rms | layer
    norm_eps: float = 1e-6
    use_bias: bool = False

    # MoE
    num_experts: int = 0
    experts_per_token: int = 0
    moe_every: int = 1  # MoE FFN every k-th layer (others dense)
    first_dense_layers: int = 0  # leading dense layers (kimi-k2 style)
    capacity_factor: float = 1.25
    # GShard-style 2D dispatch: tokens split into `moe_groups` groups
    # (aligned with the data-parallel shards), capacity per group.  0/1 =
    # single global group.  Groups keep the dispatch scatter local to each
    # dp shard — see EXPERIMENTS.md §Perf kimi iterations.
    moe_groups: int = 0

    # SSM (mamba2 / SSD)
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_groups: int = 1
    ssm_chunk: int = 128
    # hybrid interleave: one attention layer every `attn_period` layers,
    # at offset `attn_offset` (jamba: period 8, offset 7 => 1:7 ratio)
    attn_period: int = 0
    attn_offset: int = 0

    # encoder-decoder (whisper): `num_layers` is the decoder depth
    encoder_layers: int = 0
    encoder_seq: int = 0  # fixed encoder length (1500 mel frames for whisper)

    # modality frontend stubs ([audio]/[vlm]: precomputed embeddings)
    frontend: str = "none"  # none | audio_stub | vision_stub

    # launch-time sharding plan hints, consumed by launch/dryrun via
    # repro.dist: FSDP extended over the DCN pod axis and bf16 optimizer
    # moments are what let the 405B/1T configs fit a 256-chip pod.
    fsdp_over_pod: bool = False
    opt_state_dtype: str = "float32"

    # numerics / runtime
    dtype: str = "bfloat16"
    param_dtype: str = "float32"
    attn_impl: str = "xla"  # xla | pallas | pallas_interpret
    attn_chunk: int = 512  # KV-chunk for the xla flash-equivalent
    remat: str = "block"  # none | block  (remat each layer block)
    logits_fp32: bool = True

    def __post_init__(self) -> None:
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // max(1, self.num_heads))

    # -- derived -----------------------------------------------------------
    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim

    @property
    def ssm_d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.ssm_d_inner // self.ssm_head_dim

    def is_attn_layer(self, i: int) -> bool:
        """Mixer type for layer i (hybrid interleave; paper arch: jamba)."""
        if self.family == "ssm":
            return False
        if self.family == "hybrid" and self.attn_period > 0:
            return i % self.attn_period == self.attn_offset
        return True

    def is_moe_layer(self, i: int) -> bool:
        if self.num_experts == 0 or i < self.first_dense_layers:
            return False
        return (i % max(1, self.moe_every)) == (max(1, self.moe_every) - 1)

    # -- parameter count (for 6ND model-flops accounting) -------------------
    def param_counts(self) -> Dict[str, float]:
        d, ff, v = self.d_model, self.d_ff, self.vocab_size
        emb = v * d * (1 if self.tie_embeddings else 2)
        per_attn = d * self.q_dim + 2 * d * self.kv_dim + self.q_dim * d
        if self.qk_norm:
            per_attn += 2 * self.head_dim
        n_mlp_mats = 3 if self.mlp_act == "swiglu" else 2
        per_dense_ffn = n_mlp_mats * d * ff
        if self.use_bias:  # q, k, v, o; the MLP's up and down projections
            per_attn += self.q_dim + 2 * self.kv_dim + d
            per_dense_ffn += ff + d
        # a norm's parameters: its scale, and a LayerNorm's shift
        norm = d * (2 if self.norm_type == "layer" else 1)
        per_moe_ffn = self.num_experts * n_mlp_mats * d * ff + d * self.num_experts
        per_active_moe_ffn = self.experts_per_token * n_mlp_mats * d * ff
        di, N, H = self.ssm_d_inner, self.ssm_state, self.ssm_heads
        per_ssm = (
            d * (2 * di + 2 * self.ssm_groups * N + H)  # in_proj
            + di * d  # out_proj
            + 3 * H  # A, D, dt_bias
            + 4 * (di + 2 * self.ssm_groups * N)  # conv1d
        )
        total = emb
        active = emb
        layers = self.num_layers + self.encoder_layers
        for i in range(self.num_layers):
            mixer = per_attn if self.is_attn_layer(i) else per_ssm
            ffn = per_moe_ffn if self.is_moe_layer(i) else per_dense_ffn
            ffn_active = per_active_moe_ffn if self.is_moe_layer(i) else per_dense_ffn
            norms = 2 * norm
            total += mixer + ffn + norms
            active += mixer + ffn_active + norms
        for _ in range(self.encoder_layers):  # enc-dec: encoder always dense attn
            total += per_attn + per_dense_ffn + 2 * d
            active += per_attn + per_dense_ffn + 2 * d
        if self.encoder_layers:  # decoder cross-attention
            total += self.num_layers * per_attn
            active += self.num_layers * per_attn
        return {"total": float(total), "active": float(active)}

    # -- reductions for smoke tests -----------------------------------------
    def scaled_down(self) -> "ModelConfig":
        """A tiny config of the same family for CPU smoke tests."""
        changes: Dict[str, Any] = dict(
            num_layers=min(self.num_layers, 4 if self.family != "hybrid" else 8),
            d_model=128,
            num_heads=4,
            num_kv_heads=min(self.num_kv_heads, 2) or 2,
            head_dim=32,
            d_ff=256,
            vocab_size=512,
            encoder_layers=min(self.encoder_layers, 2),
            encoder_seq=min(self.encoder_seq, 32) if self.encoder_seq else 0,
            param_dtype="float32",
            dtype="float32",
            remat="none",
            attn_chunk=64,
            ssm_chunk=16,
        )
        if self.num_experts:
            changes["num_experts"] = min(self.num_experts, 8)
            changes["experts_per_token"] = min(self.experts_per_token, 2)
        if self.ssm_state:
            changes["ssm_state"] = 16
            changes["ssm_head_dim"] = 32
        if self.family == "hybrid":
            changes["attn_period"] = min(self.attn_period, 4) or 4
            changes["attn_offset"] = (changes["attn_period"] - 1)
        if self.first_dense_layers:
            changes["first_dense_layers"] = 1
        return dataclasses.replace(self, **changes)

    def replace(self, **kw: Any) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class ShapeConfig:
    """One assigned input-shape cell."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode

    @property
    def is_train(self) -> bool:
        return self.kind == "train"


SHAPES: Dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}
