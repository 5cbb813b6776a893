"""ctypes bindings of the Hopper flash-attention kernels: the forward
(``csrc/flash_attention.cu``) and the backward (``csrc/flash_attention_bwd.cu``).
Each library is built on its first launch."""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from .. import _build

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (32, 64, 128)
BLOCKS_Q = (64, 128)
BLOCKS_K = (32, 64)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def _lib(name: str, entry: str, argtypes) -> ctypes.CDLL:
    lib = _build.load(name)
    fn = getattr(lib, entry)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = _I
    return lib


def flash_attention_fwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor,
    lse: Optional[torch.Tensor], *, causal: bool, window: int, softcap: float, q_offset: int,
    block_q: int, block_k: int,
) -> None:
    """Launches the forward on the current stream; writes ``o`` and, when
    given, the rows' log-sum-exp ``lse`` (B, Hq, Sq) f32.  Inputs are checked
    by the caller (``ops``)."""
    B, Sq, Hq, D = q.shape
    _, Sk, Hkv, _ = k.shape
    lib = _lib("flash_attention", "flash_attention_fwd", [_P] * 5 + [_I] * 9 + [_F] + [_I] * 3
               + [_F, _P])
    err = lib.flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        None if lse is None else lse.data_ptr(),
        B, Sq, Sk, Hq, Hkv, D, DTYPES[q.dtype], int(causal), int(window),
        float(softcap), int(q_offset), block_q, block_k, 1.0 / math.sqrt(D),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(lib, "flash_attention", err)


def flash_attention_bwd_launch(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor, lse: torch.Tensor,
    do: torch.Tensor, dq: torch.Tensor, dk: torch.Tensor, dv: torch.Tensor, *, causal: bool,
    window: int, softcap: float, q_offset: int,
) -> None:
    """Launches the backward (delta, then dK/dV, then dQ) on the current
    stream; writes ``dq``, ``dk`` and ``dv``.  Inputs are checked by the
    caller (``ops``)."""
    B, Sq, Hq, D = q.shape
    _, Sk, Hkv, _ = k.shape
    delta = torch.empty((B, Hq, Sq), dtype=torch.float32, device=q.device)
    lib = _lib("flash_attention_bwd", "flash_attention_bwd", [_P] * 10 + [_I] * 9 + [_F, _I, _F]
               + [_P])
    err = lib.flash_attention_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        B, Sq, Sk, Hq, Hkv, D, DTYPES[q.dtype], int(causal), int(window), float(softcap),
        int(q_offset), 1.0 / math.sqrt(D), torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(lib, "flash_attention_bwd", err)
