"""repro_torch.models - the model zoo in PyTorch: decoder-only LMs (dense,
MoE, SSM, hybrid, VLM backbone) and the encoder-decoder (whisper)."""
from typing import Union

from .config import SHAPES, ModelConfig, ShapeConfig
from .encdec import EncDecModel
from .lm import LanguageModel

Model = Union[LanguageModel, EncDecModel]


def build_model(cfg: ModelConfig) -> Model:
    if cfg.family == "encdec":
        return EncDecModel(cfg)
    return LanguageModel(cfg)


__all__ = ["EncDecModel", "LanguageModel", "Model", "ModelConfig", "SHAPES", "ShapeConfig",
           "build_model"]
