"""ctypes binding of the Hopper MoE-router kernel (``csrc/moe_router.cu``).
The library is built on the first launch."""
from __future__ import annotations

import ctypes

import torch

from .. import _build

MAX_EXPERTS = 384  # kimi-k2's routing; a (64, 384) f32 tile is 96 KB of shared memory
MAX_K = 8

_P, _I = ctypes.c_void_p, ctypes.c_int


def _lib() -> ctypes.CDLL:
    lib = _build.load("moe_router")
    fn = lib.moe_router_fwd
    if fn.argtypes is None:
        fn.argtypes = [_P] * 4 + [_I] * 3 + [_P]
        fn.restype = _I
    return lib


def moe_router_fwd(
    logits: torch.Tensor, ids: torch.Tensor, gates: torch.Tensor, slots: torch.Tensor, k: int,
) -> None:
    """Launches the kernel on the current stream; writes ``ids``, ``gates``
    and ``slots``.  Inputs are checked by the caller (``ops.moe_router``)."""
    T, E = logits.shape
    lib = _lib()
    err = lib.moe_router_fwd(
        logits.data_ptr(), ids.data_ptr(), gates.data_ptr(), slots.data_ptr(), T, E, k,
        torch.cuda.current_stream(logits.device).cuda_stream,
    )
    _build.check(lib, "moe_router", err)
