"""ctypes bindings of the Hopper SSD-scan kernels: the forward
(``csrc/ssd_scan.cu``) and the backward (``csrc/ssd_scan_bwd.cu``).  Each
library is built on its first launch."""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from .. import _build

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (32, 64)
MAX_STATE = 128  # N: a multiple of 16 up to this
MAX_CHUNK = 128
STATE_PIECES = {torch.float32: 1, torch.bfloat16: 2}  # of each entering state (Route::KH)
BWD_CHUNK = 64  # the backward's chunk (kQ in csrc/ssd_scan_bwd.cu)

_P, _I = ctypes.c_void_p, ctypes.c_int


def _lib(name: str, entry: str, argtypes) -> ctypes.CDLL:
    lib = _build.load(name)
    fn = getattr(lib, entry)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = _I
    return lib


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


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
    lib = _lib("ssd_scan", "ssd_scan_fwd", [_P] * 11 + [_I] * 8 + [_P])
    err = lib.ssd_scan_fwd(
        x.data_ptr(), dt.data_ptr(), a.data_ptr(), Bm.data_ptr(), Cm.data_ptr(), D.data_ptr(),
        y.data_ptr(), h.data_ptr(), states.data_ptr(), hp.data_ptr(),
        cq.data_ptr(), Bsz, L, H, G, P, N, chunk, DTYPES[x.dtype], _stream(x),
    )
    _build.check(lib, "ssd_scan", err)


def ssd_scan_bwd_launch(
    x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor, Bm: torch.Tensor, Cm: torch.Tensor,
    D: torch.Tensor, dy: torch.Tensor, dh: Optional[torch.Tensor], dx: torch.Tensor,
    ddt: torch.Tensor, da: torch.Tensor, dB: torch.Tensor, dC: torch.Tensor, dD: torch.Tensor,
) -> None:
    """Runs the backward on the current stream and writes dx, ddt, da, dB,
    dC and dD.  First the forward's chunk states and state passing
    (``ssd_scan_states``) recompute the states entering each chunk of
    ``BWD_CHUNK`` tokens, then the backward's kernels run.  Scratch,
    allocated here: the forward's chunk states (B, H, nc, P, N) f32, which
    then hold the gradients of the states leaving each chunk, the entering
    states' pieces in x's type, dB and dC per head (B, L, H, N) f32, and the
    partials of da and dD (B, H, nc) f64.  Inputs are checked by the caller
    (``ops.ssd_scan_bwd``)."""
    Bsz, L, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    Q = min(BWD_CHUNK, L)
    nc = -(-L // Q)
    f32 = dict(dtype=torch.float32, device=x.device)
    states = torch.empty((Bsz, H, nc, P, N), **f32)
    hp = torch.empty((Bsz, H, nc, STATE_PIECES[x.dtype], P, N), dtype=x.dtype, device=x.device)
    cq = torch.empty((Bsz, H, nc), **f32)
    h_final = torch.empty((Bsz, H, N, P), **f32)
    lib = _lib("ssd_scan", "ssd_scan_states", [_P] * 8 + [_I] * 8 + [_P])
    err = lib.ssd_scan_states(
        x.data_ptr(), dt.data_ptr(), a.data_ptr(), Bm.data_ptr(), h_final.data_ptr(),
        states.data_ptr(), hp.data_ptr(), cq.data_ptr(), Bsz, L, H, G, P, N, Q,
        DTYPES[x.dtype], _stream(x),
    )
    _build.check(lib, "ssd_scan", err)
    rstate = states  # the forward's chunk states are spent: the backward's take their place
    dB_h = torch.empty((Bsz, L, H, N), **f32)
    dC_h = torch.empty((Bsz, L, H, N), **f32)
    da_part = torch.empty((Bsz, H, nc), dtype=torch.float64, device=x.device)
    dD_part = torch.empty((Bsz, H, nc), dtype=torch.float64, device=x.device)
    lib = _lib("ssd_scan_bwd", "ssd_scan_bwd", [_P] * 21 + [_I] * 8 + [_P])
    err = lib.ssd_scan_bwd(
        x.data_ptr(), dt.data_ptr(), a.data_ptr(), Bm.data_ptr(), Cm.data_ptr(), D.data_ptr(),
        dy.data_ptr(), None if dh is None else dh.data_ptr(), hp.data_ptr(), cq.data_ptr(),
        dx.data_ptr(), ddt.data_ptr(), da.data_ptr(), dB.data_ptr(), dC.data_ptr(),
        dD.data_ptr(), rstate.data_ptr(), dB_h.data_ptr(), dC_h.data_ptr(), da_part.data_ptr(),
        dD_part.data_ptr(), Bsz, L, H, G, P, N, Q, DTYPES[x.dtype], _stream(x),
    )
    _build.check(lib, "ssd_scan_bwd", err)
