"""ctypes binding of the AdamW update kernel (``csrc/adamw.cu``).  The
library is built on the first launch."""
from __future__ import annotations

import ctypes

import torch

from .. import _build
from .._scratch import Scratch

DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float


def _lib(entry: str, argtypes) -> ctypes.CDLL:
    lib = _build.load("adamw")
    fn = getattr(lib, entry)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = _I
    return lib


def update_scratch(n: int) -> Scratch:
    """The update's scratch: none (it reads and writes the leaf in place)."""
    return {}


def adamw_update_launch(p: torch.Tensor, g: torch.Tensor, m: torch.Tensor, v: torch.Tensor,
                        scale: torch.Tensor, *, lr: float, b1: float, b2: float, eps: float,
                        c1: float, c2: float, weight_decay: float) -> None:
    """Launches the update on the current stream over the contiguous p, g, m
    and v, in place; ``weight_decay`` as the kernel applies it (0 for a leaf
    that is not decayed), ``1 - b1`` and ``1 - b2`` taken in Python's
    doubles, as JAX takes them, and rounded to f32 with the rest.  Inputs are
    checked by the caller (``ops.adamw_update``)."""
    lib = _lib("adamw_update", [_P] * 5 + [_L] + [_F] * 9 + [_I] * 3 + [_P])
    err = lib.adamw_update(
        p.data_ptr(), g.data_ptr(), m.data_ptr(), v.data_ptr(), scale.data_ptr(), p.numel(),
        b1, 1 - b1, b2, 1 - b2, eps, c1, c2, lr, weight_decay, DTYPES[p.dtype],
        DTYPES[g.dtype], DTYPES[m.dtype], torch.cuda.current_stream(p.device).cuda_stream,
    )
    _build.check(lib, "adamw", err)
