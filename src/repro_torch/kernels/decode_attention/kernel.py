"""ctypes binding of the Hopper split-K decode-attention kernel
(``csrc/decode_attention.cu``).  The library is built on the first launch."""
from __future__ import annotations

import ctypes
import math
from typing import Dict, Tuple

import torch

from .. import _build
from .._scratch import Scratch

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (32, 64, 112, 128)  # 112: kimi-k2 (7168 / 64)
MAX_GROUP = 64  # q heads per kv head

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float

# (device index, stream) -> the f32 workspace of the split partials, grown
# as needed and kept for the process's life: one buffer instead of three
# allocations a call.
_workspaces: Dict[Tuple[int, int], torch.Tensor] = {}


def _lib() -> ctypes.CDLL:
    lib = _build.load("decode_attention")
    fn = lib.decode_attention_fwd
    if fn.argtypes is None:
        fn.argtypes = [_P] * 6 + [_I] * 9 + [_F, _P]
        fn.restype = _I
    return lib


def workspace_scratch(B: int, Hq: int, Hkv: int, D: int, rows: int,
                      num_splits: int) -> Scratch:
    """The split partials one call needs: ``units x num_splits x rows x (D +
    2)`` f32 (each split's output rows, max and sum), at least one float.
    It is persistent, not per call: the workspace of a (device, stream) is
    allocated at the first call, reallocated when a call needs more (the old
    buffer freed after the new one is made) and kept."""
    units = B * Hkv * -(-(Hq // Hkv) // rows)
    floats = units * num_splits * rows * (D + 2) if num_splits > 1 else 0
    return {"partials": ((max(floats, 1),), torch.float32)}


def _workspace(device: torch.device, stream: int, spec: Scratch) -> torch.Tensor:
    (shape, dtype), = spec.values()
    key = (device.index, stream)
    ws = _workspaces.get(key)
    if ws is None or ws.numel() < shape[0]:
        ws = _workspaces[key] = torch.empty(shape, dtype=dtype, device=device)
    return ws


def release_workspaces() -> None:
    """Drops every workspace; the next call allocates its own again."""
    _workspaces.clear()


def decode_attention_fwd(
    q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor, lengths: torch.Tensor,
    out: torch.Tensor, *, rows: int, num_splits: int, window: int,
) -> None:
    """Launches on the current stream and writes ``out``: one kernel, plus
    the split merge when ``num_splits`` > 1.  ``rows`` query heads per block
    (``ops.rows_per_block``).  Inputs are checked by the caller."""
    B, Hq, D = q.shape
    _, S, Hkv, _ = k_cache.shape
    stream = torch.cuda.current_stream(q.device).cuda_stream
    ws = _workspace(q.device, stream, workspace_scratch(B, Hq, Hkv, D, rows, num_splits))
    lib = _lib()
    err = lib.decode_attention_fwd(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), lengths.data_ptr(),
        ws.data_ptr(), out.data_ptr(),
        B, S, Hq, Hkv, D, DTYPES[q.dtype], rows, num_splits, int(window),
        1.0 / math.sqrt(D), stream,
    )
    _build.check(lib, "decode_attention", err)
