"""ctypes binding of the Hopper SSD-scan kernel (``csrc/ssd_scan.cu``).  The
library is built on the first launch."""
from __future__ import annotations

import ctypes

import torch

from .. import _build

DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_P, _I = ctypes.c_void_p, ctypes.c_int


def _lib() -> ctypes.CDLL:
    lib = _build.load("ssd_scan")
    fn = lib.ssd_scan_fwd
    if fn.argtypes is None:
        fn.argtypes = [_P] * 8 + [_I] * 8 + [_P]
        fn.restype = _I
    return lib


def ssd_scan_fwd(
    x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor, Bm: torch.Tensor, Cm: torch.Tensor,
    D: torch.Tensor, y: torch.Tensor, h: torch.Tensor, *, chunk: int,
) -> None:
    """Launches the kernel on the current stream; writes ``y`` and the final
    state ``h``.  Inputs are checked by the caller (``ops.ssd_scan``); a
    chunk whose layout passes one block's shared memory is refused by the
    launcher (``csrc/ssd_scan.cu``) and raises here."""
    Bsz, L, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    lib = _lib()
    err = lib.ssd_scan_fwd(
        x.data_ptr(), dt.data_ptr(), a.data_ptr(), Bm.data_ptr(), Cm.data_ptr(), D.data_ptr(),
        y.data_ptr(), h.data_ptr(), Bsz, L, H, G, P, N, chunk, DTYPES[x.dtype],
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(lib, "ssd_scan", err)
