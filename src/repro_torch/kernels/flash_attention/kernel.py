"""ctypes bindings of the Hopper flash-attention kernels: the forward
(``csrc/flash_attention.cu``) and the backward (``csrc/flash_attention_bwd.cu``).
Each library is built on its first launch."""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from .. import _build
from .._scratch import Scratch, allocate

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (32, 64, 112, 128)  # 112: kimi-k2 (7168 / 64)
# The forward's (block_q, block_k) tiles by dtype, the default first: f32
# runs the first version's scalar kernel, bf16 the Hopper wgmma kernel (128
# query rows a block, 64 a consumer warpgroup, keys streamed 128 or 64 at a
# time).  The backward's tiles are fixed inside its kernels.
TILES = {
    torch.float32: ((64, 64), (64, 32), (128, 32), (128, 64)),
    torch.bfloat16: ((128, 128), (128, 64)),
}
# The bf16 backward's padding of the query rows (its dQ pass takes 128 rows
# a block): Δ and the log-sum-exp are copied into (B, Hq, Sq_pad) buffers.
BWD_Q_PAD = 128

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def _lib(name: str, entry: str, argtypes) -> ctypes.CDLL:
    lib = _build.load(name)
    fn = getattr(lib, entry)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = _I
    return lib


def fwd_scratch(B: int, Sq: int, Sk: int, Hq: int, D: int, dtype: torch.dtype) -> Scratch:
    """The forward's scratch: none (the output and the log-sum-exp are the
    caller's)."""
    return {}


def bwd_scratch(B: int, Sq: int, Sk: int, Hq: int, D: int, dtype: torch.dtype) -> Scratch:
    """Shape and dtype of each scratch tensor of one backward call, as
    ``flash_attention_bwd_launch`` allocates them.  f32: Δ (B, Hq, Sq).
    bf16: Δ and a copy of the log-sum-exp padded to ``BWD_Q_PAD`` query rows
    (B, Hq, Sq_pad), and the per-query-head partials of dK and dV (B, Sk,
    Hq, D), all f32."""
    f32 = torch.float32
    if dtype != torch.bfloat16:
        return {"delta": ((B, Hq, Sq), f32)}
    sq_pad = -(-Sq // BWD_Q_PAD) * BWD_Q_PAD
    return {"delta": ((B, Hq, sq_pad), f32), "lse_pad": ((B, Hq, sq_pad), f32),
            "dk_part": ((B, Sk, Hq, D), f32), "dv_part": ((B, Sk, Hq, D), f32)}


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
        _ptr(lse),
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
    """Launches the backward on the current stream; writes ``dq``, ``dk``
    and ``dv``.  f32: Δ, then dK/dV, then dQ.  bf16: Δ and a padded copy of
    the log-sum-exp, dK/dV as f32 partials per query head, their GQA group
    sums, then dQ; the scratch (``bwd_scratch``) is allocated here.  Inputs
    are checked by the caller (``ops``)."""
    B, Sq, Hq, D = q.shape
    _, Sk, Hkv, _ = k.shape
    w = allocate(bwd_scratch(B, Sq, Sk, Hq, D, q.dtype), q.device)
    lib = _lib("flash_attention_bwd", "flash_attention_bwd", [_P] * 13 + [_I] * 9 + [_F, _I, _F]
               + [_P])
    err = lib.flash_attention_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(), lse.data_ptr(),
        w["delta"].data_ptr(), _ptr(w.get("lse_pad")), _ptr(w.get("dk_part")),
        _ptr(w.get("dv_part")), dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(),
        B, Sq, Sk, Hq, Hkv, D, DTYPES[q.dtype], int(causal), int(window), float(softcap),
        int(q_offset), 1.0 / math.sqrt(D), torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(lib, "flash_attention_bwd", err)
