"""ctypes binding of the Hopper split-K decode-attention kernel
(``csrc/decode_attention.cu``).  The library is built on the first launch."""
from __future__ import annotations

import ctypes
import math

import torch

from .. import _build

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (32, 64, 128)
MAX_GROUP = 64  # q heads per kv head that one block holds

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def _lib() -> ctypes.CDLL:
    lib = _build.load("decode_attention")
    fn = lib.decode_attention_fwd
    if fn.argtypes is None:
        fn.argtypes = [_P] * 8 + [_I] * 9 + [_F, _P]
        fn.restype = _I
    return lib


def decode_attention_fwd(
    q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor, lengths: torch.Tensor,
    out: torch.Tensor, *, num_splits: int, seg: int, window: int,
) -> None:
    """Launches phase 1 (partials per split) and phase 2 (merge) on the
    current stream; writes ``out``.  Inputs are checked by the caller."""
    B, Hq, D = q.shape
    _, S, Hkv, _ = k_cache.shape
    G = Hq // Hkv
    acc = torch.empty((B, Hkv, num_splits, G, D), dtype=torch.float32, device=q.device)
    m = torch.empty((B, Hkv, num_splits, G), dtype=torch.float32, device=q.device)
    l = torch.empty_like(m)
    lib = _lib()
    err = lib.decode_attention_fwd(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), lengths.data_ptr(),
        acc.data_ptr(), m.data_ptr(), l.data_ptr(), out.data_ptr(),
        B, S, Hq, Hkv, D, DTYPES[q.dtype], num_splits, seg, int(window),
        1.0 / math.sqrt(D), torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(lib, "decode_attention", err)
