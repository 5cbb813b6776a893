from .ops import RMSNorm, rms_norm, rms_norm_bwd
from .ref import gate_product, rms_norm_bwd_ref, rms_norm_ref, rstd_ref

__all__ = ["RMSNorm", "gate_product", "rms_norm", "rms_norm_bwd", "rms_norm_bwd_ref",
           "rms_norm_ref", "rstd_ref"]
