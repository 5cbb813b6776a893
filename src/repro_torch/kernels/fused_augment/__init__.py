from .ops import fused_augment
from .ref import fused_augment_ref

__all__ = ["fused_augment", "fused_augment_ref"]
