from .ops import MoERouter, moe_router, moe_router_bwd
from .ref import moe_router_blocked_model, moe_router_bwd_ref, moe_router_ref

__all__ = ["MoERouter", "moe_router", "moe_router_blocked_model", "moe_router_bwd",
           "moe_router_bwd_ref", "moe_router_ref"]
