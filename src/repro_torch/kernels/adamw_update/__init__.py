from .ops import adamw_update
from .ref import adamw_update_ref

__all__ = ["adamw_update", "adamw_update_ref"]
