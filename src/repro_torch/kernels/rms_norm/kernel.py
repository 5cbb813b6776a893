"""ctypes binding of the RMSNorm kernels (``csrc/rms_norm.cu``): the forward
and the backward (with its reduction of the scale's partials), plain or gated
by SiLU.  The library is built on the first launch."""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from .. import _build
from .._scratch import Scratch, allocate

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_WIDTH = 16384  # kMaxWidth in csrc/rms_norm.cu: 8 chunks of 8 for 256 threads
MAX_GATED_WIDTH = 8192  # kMaxGatedWidth: every mixer's d_inner
BWD_PARTS = 264  # blocks of the backward at most, two an SM of an H100: its dw partials

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float


def _lib(entry: str, argtypes) -> ctypes.CDLL:
    lib = _build.load("rms_norm")
    fn = getattr(lib, entry)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = _I
    return lib


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def fwd_scratch(rows: int, D: int) -> Scratch:
    """The forward's scratch: none (it writes the output and each row's rstd)."""
    return {}


def bwd_scratch(rows: int, D: int) -> Scratch:
    """The backward's scratch: each block's partial sum of dw over the rows it
    walks, ``partials`` (min(rows, BWD_PARTS), D) f32, which its second launch
    sums over the blocks in order."""
    return {"partials": ((min(rows, BWD_PARTS), D), torch.float32)}


def _gate(z: Optional[torch.Tensor], x: torch.Tensor):
    """(pointer, row stride, dtype code) of the gate; null, 0 and x's code
    without one."""
    if z is None:
        return None, 0, DTYPES[x.dtype]
    return z.data_ptr(), z.stride(0), DTYPES[z.dtype]


def rms_norm_fwd(x: torch.Tensor, w: torch.Tensor, z: Optional[torch.Tensor], eps: float,
                 out: torch.Tensor, rstd: torch.Tensor) -> None:
    """Launches the forward on the current stream over the (rows, D) views x
    and z (unit column stride, any row stride); writes ``out`` and ``rstd``.
    Inputs are checked by the caller (``ops.rms_norm``)."""
    rows, D = x.shape
    zp, sz, zdt = _gate(z, x)
    lib = _lib("rms_norm_fwd", [_P, _L, _P, _L, _P, _P, _P, _I, _I, _F] + [_I] * 3 + [_P])
    err = lib.rms_norm_fwd(
        x.data_ptr(), x.stride(0), zp, sz, w.data_ptr(), out.data_ptr(), rstd.data_ptr(), rows,
        D, eps, DTYPES[x.dtype], zdt, DTYPES[w.dtype], _stream(x),
    )
    _build.check(lib, "rms_norm", err)


def rms_norm_bwd_launch(x: torch.Tensor, w: torch.Tensor, z: Optional[torch.Tensor],
                        rstd: torch.Tensor, dout: torch.Tensor, dx: torch.Tensor,
                        dw: torch.Tensor, dz: Optional[torch.Tensor]) -> None:
    """Launches the backward on the current stream and writes dx, dw and dz
    (gated).  Scratch as ``bwd_scratch`` lists it, allocated here.  Inputs are
    checked by the caller (``ops.rms_norm_bwd``)."""
    rows, D = x.shape
    spec = bwd_scratch(rows, D)
    s = allocate(spec, x.device)
    zp, sz, zdt = _gate(z, x)
    lib = _lib("rms_norm_bwd", [_P, _L, _P, _L] + [_P] * 7 + [_I] * 6 + [_P])
    err = lib.rms_norm_bwd(
        x.data_ptr(), x.stride(0), zp, sz, w.data_ptr(), dout.data_ptr(), rstd.data_ptr(),
        dx.data_ptr(), None if dz is None else dz.data_ptr(), dw.data_ptr(),
        s["partials"].data_ptr(), spec["partials"][0][0], rows, D, DTYPES[x.dtype], zdt,
        DTYPES[w.dtype], _stream(x),
    )
    _build.check(lib, "rms_norm", err)
