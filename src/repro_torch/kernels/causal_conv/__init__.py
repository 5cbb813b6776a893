from .ops import CausalConv, causal_conv, causal_conv_bwd
from .ref import causal_conv_bwd_ref, causal_conv_ref

__all__ = ["CausalConv", "causal_conv", "causal_conv_bwd", "causal_conv_bwd_ref",
           "causal_conv_ref"]
