"""repro_torch.models - decoder-only LMs in PyTorch (dense, MoE, SSM and
hybrid families; enc-dec and VLM raise until their slice lands)."""
from .config import SHAPES, ModelConfig, ShapeConfig
from .lm import LanguageModel, require_ported

Model = LanguageModel


def build_model(cfg: ModelConfig) -> Model:
    require_ported(cfg)
    return LanguageModel(cfg)


__all__ = ["LanguageModel", "Model", "ModelConfig", "SHAPES", "ShapeConfig", "build_model"]
