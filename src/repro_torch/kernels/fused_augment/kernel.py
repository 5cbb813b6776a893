"""ctypes binding of the Hopper fused-augment kernel (``csrc/fused_augment.cu``).
The library is built on the first launch."""
from __future__ import annotations

import ctypes

import torch

from .. import _build
from .._scratch import Scratch

MAX_CHANNELS = 16

_P, _I = ctypes.c_void_p, ctypes.c_int


def _lib() -> ctypes.CDLL:
    lib = _build.load("fused_augment")
    fn = lib.fused_augment_fwd
    if fn.argtypes is None:
        fn.argtypes = [_P] * 6 + [_I] * 6 + [_P]
        fn.restype = _I
    return lib


def fwd_scratch(B: int, H: int, W: int, C: int, out_h: int, out_w: int) -> Scratch:
    """The kernel's scratch: none (it writes the output alone)."""
    return {}


def fused_augment_fwd(
    images: torch.Tensor, crops: torch.Tensor, flips: torch.Tensor, mean: torch.Tensor,
    std: torch.Tensor, out: torch.Tensor,
) -> None:
    """Launches the kernel on the current stream; writes ``out``.  Inputs are
    checked by the caller (``ops.fused_augment``)."""
    B, H, W, C = images.shape
    _, out_h, out_w, _ = out.shape
    lib = _lib()
    err = lib.fused_augment_fwd(
        images.data_ptr(), crops.data_ptr(), flips.data_ptr(), mean.data_ptr(), std.data_ptr(),
        out.data_ptr(), B, H, W, C, out_h, out_w,
        torch.cuda.current_stream(images.device).cuda_stream,
    )
    _build.check(lib, "fused_augment", err)
