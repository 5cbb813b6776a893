"""ctypes bindings of the Hopper SSD-scan kernels: the forward
(``csrc/ssd_scan.cu``) and the backward (``csrc/ssd_scan_bwd.cu``).  Each
library is built on its first launch."""
from __future__ import annotations

import ctypes
from typing import Dict, Optional

import torch

from .. import _build, _scratch
from .._scratch import Scratch, allocate

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (32, 64)
MAX_STATE = 128  # N: a multiple of 16 up to this
MAX_CHUNK = 128
STATE_PIECES = {torch.float32: 1, torch.bfloat16: 2}  # of each entering state (Route::KH)
BWD_CHUNK = 64  # the backward's chunk (kQ in csrc/ssd_scan_bwd.cu)
HEAD_BLOCK = 8  # heads of one group a block of the backward takes (kHeadBlock there)

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


def fwd_scratch(Bsz: int, L: int, H: int, P: int, N: int, chunk: int,
                dtype: torch.dtype) -> Scratch:
    """Shape and dtype of each scratch tensor of one forward call, as
    ``ssd_scan_fwd`` allocates them: each chunk's state ``states`` (B, H,
    chunks, P, N) f32, the state entering it ``hp`` in x's type (as
    ``STATE_PIECES`` bf16 pieces for bf16 inputs), and its log-decay ``cq``
    (B, H, chunks) f32."""
    nc = -(-L // chunk)
    return {"states": ((Bsz, H, nc, P, N), torch.float32),
            "hp": ((Bsz, H, nc, STATE_PIECES[dtype], P, N), dtype),
            "cq": ((Bsz, H, nc), torch.float32)}


def ssd_scan_fwd(
    x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor, Bm: torch.Tensor, Cm: torch.Tensor,
    D: torch.Tensor, y: torch.Tensor, h: torch.Tensor, *, chunk: int,
) -> None:
    """Runs the kernels of the chunk-parallel scan on the current stream;
    writes ``y`` and the final state ``h``.  Inputs are checked by the
    caller (``ops.ssd_scan``).  Scratch as ``fwd_scratch`` lists it,
    allocated here."""
    Bsz, L, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    w = allocate(fwd_scratch(Bsz, L, H, P, N, chunk, x.dtype), x.device)
    lib = _lib("ssd_scan", "ssd_scan_fwd", [_P] * 11 + [_I] * 8 + [_P])
    err = lib.ssd_scan_fwd(
        x.data_ptr(), dt.data_ptr(), a.data_ptr(), Bm.data_ptr(), Cm.data_ptr(), D.data_ptr(),
        y.data_ptr(), h.data_ptr(), w["states"].data_ptr(), w["hp"].data_ptr(),
        w["cq"].data_ptr(), Bsz, L, H, G, P, N, chunk, DTYPES[x.dtype], _stream(x),
    )
    _build.check(lib, "ssd_scan", err)


def bwd_scratch(Bsz: int, L: int, H: int, G: int, P: int, N: int,
                dtype: torch.dtype) -> Scratch:
    """Shape and dtype of each scratch tensor of one backward call, as
    ``ssd_scan_bwd_launch`` allocates them: the forward's chunk states
    ``rstate`` (B, H, nc, P, N) f32, which then hold the gradients of the
    states leaving each chunk; the entering states' pieces ``hp`` in x's
    type; their log-decays ``cq`` and the final state ``h_final`` that
    ``ssd_scan_states`` also writes; the head blocks' partials of dB and dC
    (B, L, G, head blocks, N) f32 (a block sums its ``HEAD_BLOCK`` heads on
    chip); and the partials of da and dD (B, H, nc) f64."""
    Q = min(BWD_CHUNK, L)
    nc = -(-L // Q)
    nhb = -(-(H // G) // HEAD_BLOCK)
    f32, f64 = torch.float32, torch.float64
    return {
        "rstate": ((Bsz, H, nc, P, N), f32),
        "hp": ((Bsz, H, nc, STATE_PIECES[dtype], P, N), dtype),
        "cq": ((Bsz, H, nc), f32),
        "h_final": ((Bsz, H, N, P), f32),
        "dB_part": ((Bsz, L, G, nhb, N), f32),
        "dC_part": ((Bsz, L, G, nhb, N), f32),
        "da_part": ((Bsz, H, nc), f64),
        "dD_part": ((Bsz, H, nc), f64),
    }


def bwd_scratch_bytes(Bsz: int, L: int, H: int, G: int, P: int, N: int,
                      dtype: torch.dtype) -> Dict[str, int]:
    """Bytes of each scratch tensor of ``bwd_scratch``."""
    return _scratch.nbytes(bwd_scratch(Bsz, L, H, G, P, N, dtype))


def ssd_scan_bwd_launch(
    x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor, Bm: torch.Tensor, Cm: torch.Tensor,
    D: torch.Tensor, dy: torch.Tensor, dh: Optional[torch.Tensor], dx: torch.Tensor,
    ddt: torch.Tensor, da: torch.Tensor, dB: torch.Tensor, dC: torch.Tensor, dD: torch.Tensor,
) -> None:
    """Runs the backward on the current stream and writes dx, ddt, da, dB,
    dC and dD.  First the forward's chunk states and state passing
    (``ssd_scan_states``) recompute the states entering each chunk of
    ``BWD_CHUNK`` tokens, then the backward's kernels run.  Scratch as
    ``bwd_scratch`` lists it, allocated here.  Inputs are checked by the
    caller (``ops.ssd_scan_bwd``)."""
    Bsz, L, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    Q = min(BWD_CHUNK, L)
    w = allocate(bwd_scratch(Bsz, L, H, G, P, N, x.dtype), x.device)
    lib = _lib("ssd_scan", "ssd_scan_states", [_P] * 8 + [_I] * 8 + [_P])
    err = lib.ssd_scan_states(
        x.data_ptr(), dt.data_ptr(), a.data_ptr(), Bm.data_ptr(), w["h_final"].data_ptr(),
        w["rstate"].data_ptr(), w["hp"].data_ptr(), w["cq"].data_ptr(), Bsz, L, H, G, P, N, Q,
        DTYPES[x.dtype], _stream(x),
    )
    _build.check(lib, "ssd_scan", err)
    # the forward's chunk states are spent: the backward's take their place
    lib = _lib("ssd_scan_bwd", "ssd_scan_bwd", [_P] * 21 + [_I] * 8 + [_P])
    err = lib.ssd_scan_bwd(
        x.data_ptr(), dt.data_ptr(), a.data_ptr(), Bm.data_ptr(), Cm.data_ptr(), D.data_ptr(),
        dy.data_ptr(), None if dh is None else dh.data_ptr(), w["hp"].data_ptr(),
        w["cq"].data_ptr(), dx.data_ptr(), ddt.data_ptr(), da.data_ptr(), dB.data_ptr(),
        dC.data_ptr(), dD.data_ptr(), w["rstate"].data_ptr(), w["dB_part"].data_ptr(),
        w["dC_part"].data_ptr(), w["da_part"].data_ptr(), w["dD_part"].data_ptr(), Bsz, L, H, G,
        P, N, Q, DTYPES[x.dtype], _stream(x),
    )
    _build.check(lib, "ssd_scan_bwd", err)
