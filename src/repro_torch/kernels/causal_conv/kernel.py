"""ctypes binding of the Hopper causal-conv kernels (``csrc/causal_conv.cu``):
the forward and the backward (with its reduction of the weights'
partials).  The library is built on the first launch."""
from __future__ import annotations

import ctypes

import torch

from .. import _build
from .._scratch import Scratch, allocate

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
TAPS = 4  # the conv's width (kTaps in csrc/causal_conv.cu)
BLOCK_ROWS = 128  # time steps a block of the backward sums its partials over (kBlockRows)
PARTS = TAPS + 1  # dw's taps and db

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


def _lib(entry: str, argtypes) -> ctypes.CDLL:
    lib = _build.load("causal_conv")
    fn = getattr(lib, entry)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = _I
    return lib


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def fwd_scratch(Bsz: int, L: int, Ch: int) -> Scratch:
    """The forward's scratch: none (it writes its three outputs alone)."""
    return {}


def bwd_scratch(Bsz: int, L: int, Ch: int) -> Scratch:
    """The backward's scratch: each block's partial sums of dw's 4 taps and
    db, ``partials`` (B * ceil(L / BLOCK_ROWS), 5, Ch) f32, which its second
    launch sums over the blocks in order."""
    return {"partials": ((Bsz * -(-L // BLOCK_ROWS), PARTS, Ch), torch.float32)}


def causal_conv_fwd(xbc: torch.Tensor, w: torch.Tensor, b: torch.Tensor, xs: torch.Tensor,
                    bo: torch.Tensor, co: torch.Tensor) -> None:
    """Launches the forward on the current stream; writes ``xs``, ``bo`` and
    ``co``.  Inputs are checked by the caller (``ops.causal_conv``)."""
    Bsz, L, _ = xbc.shape
    lib = _lib("causal_conv_fwd", [_P, _L, _L, _P, _P, _P, _P, _P] + [_I] * 6 + [_P])
    err = lib.causal_conv_fwd(
        xbc.data_ptr(), xbc.stride(0), xbc.stride(1), w.data_ptr(), b.data_ptr(), xs.data_ptr(),
        bo.data_ptr(), co.data_ptr(), Bsz, L, xs.shape[2], bo.shape[2], DTYPES[xbc.dtype],
        DTYPES[w.dtype], _stream(xbc),
    )
    _build.check(lib, "causal_conv", err)


def causal_conv_bwd_launch(xbc: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                           dxs: torch.Tensor, dbo: torch.Tensor, dco: torch.Tensor,
                           dx: torch.Tensor, dw: torch.Tensor, db: torch.Tensor) -> None:
    """Launches the backward on the current stream and writes dx, dw and db.
    Scratch as ``bwd_scratch`` lists it, allocated here.  Inputs are checked
    by the caller (``ops.causal_conv_bwd``)."""
    Bsz, L, Ch = xbc.shape
    s = allocate(bwd_scratch(Bsz, L, Ch), xbc.device)
    lib = _lib("causal_conv_bwd", [_P, _L, _L] + [_P] * 9 + [_I] * 6 + [_P])
    err = lib.causal_conv_bwd(
        xbc.data_ptr(), xbc.stride(0), xbc.stride(1), w.data_ptr(), b.data_ptr(),
        dxs.data_ptr(), dbo.data_ptr(), dco.data_ptr(), dx.data_ptr(), dw.data_ptr(),
        db.data_ptr(), s["partials"].data_ptr(), Bsz, L, dxs.shape[2], dbo.shape[2],
        DTYPES[xbc.dtype], DTYPES[w.dtype], _stream(xbc),
    )
    _build.check(lib, "causal_conv", err)
