"""Assigned-architecture config registry: ``get_config(arch_id)``.

A copy of the JAX package's registry, value for value.  Each module defines
``CONFIG`` with the exact published architecture hyperparameters ([source;
verified-tier] noted per file).  Shapes come from
``repro_torch.models.config.SHAPES``; (arch x shape) applicability (e.g.
long_500k only for sub-quadratic archs) is encoded in ``cell_supported``.
"""
from importlib import import_module
from typing import List, Tuple

from ..models.config import SHAPES, ModelConfig, ShapeConfig

ARCH_IDS: List[str] = [
    "qwen3_14b",
    "llama3_405b",
    "starcoder2_3b",
    "deepseek_7b",
    "whisper_large_v3",
    "kimi_k2_1t_a32b",
    "moonshot_v1_16b_a3b",
    "mamba2_2p7b",
    "jamba_v0p1_52b",
    "qwen2_vl_2b",
]

_ALIASES = {i.replace("_", "-"): i for i in ARCH_IDS}
_ALIASES.update(
    {
        "qwen3-14b": "qwen3_14b",
        "llama3-405b": "llama3_405b",
        "starcoder2-3b": "starcoder2_3b",
        "deepseek-7b": "deepseek_7b",
        "whisper-large-v3": "whisper_large_v3",
        "kimi-k2-1t-a32b": "kimi_k2_1t_a32b",
        "moonshot-v1-16b-a3b": "moonshot_v1_16b_a3b",
        "mamba2-2.7b": "mamba2_2p7b",
        "jamba-v0.1-52b": "jamba_v0p1_52b",
        "qwen2-vl-2b": "qwen2_vl_2b",
    }
)


def get_config(arch: str) -> ModelConfig:
    mod_name = _ALIASES.get(arch, arch).replace("-", "_").replace(".", "p")
    if mod_name not in ARCH_IDS:
        raise KeyError(f"unknown arch '{arch}'; known: {sorted(_ALIASES)}")
    return import_module(f"{__name__}.{mod_name}").CONFIG


def cell_supported(cfg: ModelConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    """Is (arch x shape) runnable? Returns (supported, reason-if-not)."""
    if shape.name == "long_500k" and cfg.family not in ("ssm", "hybrid"):
        return False, "long_500k needs sub-quadratic context (SSM/hybrid only)"
    return True, ""


def all_cells() -> List[Tuple[str, str]]:
    return [(a, s) for a in ARCH_IDS for s in SHAPES]
