"""ctypes bindings of the Hopper MoE-router kernels (``csrc/moe_router.cu``:
the forward and its backward, ``route_bwd``).  The library is built on the
first launch."""
from __future__ import annotations

import ctypes

import torch

from .. import _build
from .._scratch import Scratch, allocate

MAX_EXPERTS = 384  # kimi-k2's routing: 12 experts a lane in registers
MAX_K = 8
TOKEN_BLOCK = 32  # tokens a block of the first launch (kBlockT in the source)

_P, _I = ctypes.c_void_p, ctypes.c_int


def _lib(entry: str, argtypes) -> ctypes.CDLL:
    lib = _build.load("moe_router")
    fn = getattr(lib, entry)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = _I
    return lib


def fwd_scratch(T: int, E: int) -> Scratch:
    """The forward's scratch: the token blocks' expert counts (blocks, E)
    int32, when there is more than one block of ``TOKEN_BLOCK`` tokens."""
    nb = -(-T // TOKEN_BLOCK)
    return {"counts": ((nb, E), torch.int32)} if nb > 1 else {}


def bwd_scratch(T: int, E: int, k: int) -> Scratch:
    """The backward's scratch: none (``route_bwd`` writes dlogits alone)."""
    return {}


def moe_router_fwd(
    logits: torch.Tensor, ids: torch.Tensor, gates: torch.Tensor, slots: torch.Tensor, k: int,
) -> None:
    """Launches on the current stream and writes ``ids``, ``gates`` and
    ``slots``: the token blocks' routing and in-block slots, then, when there
    is more than one token block, the prefix of the earlier blocks' counts
    (``fwd_scratch``, allocated here).  Inputs are checked by the caller
    (``ops.moe_router``)."""
    T, E = logits.shape
    counts = allocate(fwd_scratch(T, E), logits.device).get("counts")
    lib = _lib("moe_router_fwd", [_P] * 5 + [_I] * 3 + [_P])
    err = lib.moe_router_fwd(
        logits.data_ptr(), ids.data_ptr(), gates.data_ptr(), slots.data_ptr(),
        None if counts is None else counts.data_ptr(), T, E, k,
        torch.cuda.current_stream(logits.device).cuda_stream,
    )
    _build.check(lib, "moe_router", err)


def moe_router_bwd_launch(
    ids: torch.Tensor, gates: torch.Tensor, dgates: torch.Tensor, dlogits: torch.Tensor,
) -> None:
    """Launches ``route_bwd`` on the current stream and writes every entry
    of ``dlogits`` (T, E) f32.  Inputs are checked by the caller
    (``ops.moe_router_bwd``)."""
    T, k = ids.shape
    lib = _lib("moe_router_bwd", [_P] * 4 + [_I] * 3 + [_P])
    err = lib.moe_router_bwd(
        ids.data_ptr(), gates.data_ptr(), dgates.data_ptr(), dlogits.data_ptr(), T,
        dlogits.shape[1], k, torch.cuda.current_stream(ids.device).cuda_stream,
    )
    _build.check(lib, "moe_router", err)
