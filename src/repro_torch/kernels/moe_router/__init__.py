from .ops import moe_router
from .ref import moe_router_blocked_model, moe_router_ref

__all__ = ["moe_router", "moe_router_blocked_model", "moe_router_ref"]
