"""ctypes binding of the Hopper flash-attention kernel
(``csrc/flash_attention.cu``).  The library is built on the first launch."""
from __future__ import annotations

import ctypes
import math

import torch

from .. import _build

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (32, 64, 128)
BLOCKS_Q = (64, 128)
BLOCKS_K = (32, 64)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def _lib() -> ctypes.CDLL:
    lib = _build.load("flash_attention")
    fn = lib.flash_attention_fwd
    if fn.argtypes is None:
        fn.argtypes = [_P, _P, _P, _P] + [_I] * 9 + [_F, _I, _I, _I, _F, _P]
        fn.restype = _I
    return lib


def flash_attention_fwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor, *,
    causal: bool, window: int, softcap: float, q_offset: int, block_q: int, block_k: int,
) -> None:
    """Launches the kernel on the current stream; writes ``o``.  Inputs are
    checked by the caller (``ops.flash_attention``)."""
    B, Sq, Hq, D = q.shape
    _, Sk, Hkv, _ = k.shape
    lib = _lib()
    err = lib.flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        B, Sq, Sk, Hq, Hkv, D, DTYPES[q.dtype], int(causal), int(window),
        float(softcap), int(q_offset), block_q, block_k, 1.0 / math.sqrt(D),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(lib, "flash_attention", err)
