"""ctypes binding of the Hopper SSD-scan kernels (``csrc/ssd_scan.cu``).  The
library is built on the first launch."""
from __future__ import annotations

import ctypes

import torch

from .. import _build

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (32, 64)
MAX_STATE = 128  # N: a multiple of 16 up to this
MAX_CHUNK = 128
STATE_PIECES = {torch.float32: 1, torch.bfloat16: 2}  # of each entering state (Route::KH)

_P, _I = ctypes.c_void_p, ctypes.c_int


def _lib() -> ctypes.CDLL:
    lib = _build.load("ssd_scan")
    fn = lib.ssd_scan_fwd
    if fn.argtypes is None:
        fn.argtypes = [_P] * 11 + [_I] * 8 + [_P]
        fn.restype = _I
    return lib


def ssd_scan_fwd(
    x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor, Bm: torch.Tensor, Cm: torch.Tensor,
    D: torch.Tensor, y: torch.Tensor, h: torch.Tensor, *, chunk: int,
) -> None:
    """Runs the kernels of the chunk-parallel scan on the current stream;
    writes ``y`` and the final state ``h``.  Inputs are checked by the
    caller (``ops.ssd_scan``).  Workspace: each chunk's state (B, H, chunks,
    P, N) in f32, the state entering it in x's type (as two bf16 pieces for
    bf16 inputs), and its log-decay."""
    Bsz, L, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    nc = -(-L // chunk)
    dev = x.device
    states = torch.empty((Bsz, H, nc, P, N), dtype=torch.float32, device=dev)
    hp = torch.empty((Bsz, H, nc, STATE_PIECES[x.dtype], P, N), dtype=x.dtype, device=dev)
    cq = torch.empty((Bsz, H, nc), dtype=torch.float32, device=dev)
    lib = _lib()
    err = lib.ssd_scan_fwd(
        x.data_ptr(), dt.data_ptr(), a.data_ptr(), Bm.data_ptr(), Cm.data_ptr(), D.data_ptr(),
        y.data_ptr(), h.data_ptr(), states.data_ptr(), hp.data_ptr(),
        cq.data_ptr(), Bsz, L, H, G, P, N, chunk, DTYPES[x.dtype],
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(lib, "ssd_scan", err)
