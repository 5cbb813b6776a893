"""Public wrappers of the mamba2 SSD-scan kernels; which one serves a call is
the route rule's (``kernels._route``).

``ssd_scan``: ``csrc/ssd_scan.cu`` (chunk states, state passing, chunk
output), plain version ``ssd_scan_ref``, under autograd ``SSDScan``, whose
backward is ``ssd_scan_bwd``.  On a mesh the batch splits over the data
axes, heads (and B/C groups) over the model axis.

``ssd_scan_bwd``: ``csrc/ssd_scan_bwd.cu``, after the forward's first two
kernels recompute the states entering each chunk; plain version
``ssd_scan_bwd_ref`` (the same math, in f32).

Each call that launches counts one in ``.launches``.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from .. import _boundary, _route, _shape
from .kernel import (BWD_CHUNK, DTYPES, HEAD_DIMS, MAX_CHUNK, MAX_STATE, ssd_scan_bwd_launch,
                     ssd_scan_fwd)
from .ref import ssd_scan_bwd_ref, ssd_scan_ref


def _check(x, dt, a, Bm, Cm, D, chunk) -> None:
    if x.dim() != 4 or dt.dim() != 3 or Bm.dim() != 4 or Bm.shape != Cm.shape:
        raise ValueError(f"ssd_scan: want x (B,L,H,P), dt (B,L,H), B = C (B,L,G,N); got "
                         f"{tuple(x.shape)}, {tuple(dt.shape)}, {tuple(Bm.shape)}, "
                         f"{tuple(Cm.shape)}")
    Bsz, L, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    if (tuple(dt.shape) != (Bsz, L, H) or tuple(Bm.shape[:2]) != (Bsz, L) or H % G
            or tuple(a.shape) != (H,) or tuple(D.shape) != (H,)):
        raise ValueError(f"ssd_scan: x {tuple(x.shape)}, dt {tuple(dt.shape)}, B "
                         f"{tuple(Bm.shape)}, a {tuple(a.shape)}, D {tuple(D.shape)} disagree, "
                         "or H % G != 0")
    if P not in HEAD_DIMS or N % 16 or not 16 <= N <= MAX_STATE:
        raise ValueError(f"ssd_scan: head dim {P} not in {HEAD_DIMS}, or state {N} not a "
                         f"multiple of 16 in [16, {MAX_STATE}]")
    if not 1 <= chunk <= MAX_CHUNK:
        raise ValueError(f"ssd_scan: chunk {chunk} not in [1, {MAX_CHUNK}]")
    if x.dtype not in DTYPES or not (x.dtype == Bm.dtype == Cm.dtype):
        raise TypeError(f"ssd_scan: want one of {list(DTYPES)} for x, B, C; "
                        f"got {x.dtype}, {Bm.dtype}, {Cm.dtype}")
    if not all(t.dtype == torch.float32 for t in (dt, a, D)):
        raise TypeError(f"ssd_scan: dt, a, D must be float32; got {dt.dtype}, {a.dtype}, "
                        f"{D.dtype}")
    if len({t.device for t in (x, dt, a, Bm, Cm, D)}) != 1:
        raise ValueError("ssd_scan: inputs on different devices")
    for name, t in (("x", x), ("dt", dt), ("a", a), ("B", Bm), ("C", Cm), ("D", D)):
        if not t.is_contiguous():
            raise ValueError(f"ssd_scan: {name} must be contiguous")
    for name, t in (("x", x), ("B", Bm), ("C", Cm)):
        if t.data_ptr() % 16:
            raise ValueError(f"ssd_scan: {name} must be 16-byte aligned")


def _forward(x, dt, a, Bm, Cm, D, chunk) -> Tuple[torch.Tensor, torch.Tensor]:
    chunk = min(chunk, x.shape[1])
    _check(x, dt, a, Bm, Cm, D, chunk)

    def launch():
        Bsz, L, H, P = x.shape
        y = torch.empty_like(x)
        h = torch.empty((Bsz, H, Bm.shape[3], P), dtype=torch.float32, device=x.device)
        ssd_scan_fwd(x, dt, a, Bm, Cm, D, y, h, chunk=chunk)
        return y, h

    return _route.device(ssd_scan, x, lambda: _shape.ssd_scan(x, dt, a, Bm, Cm, D, chunk),
                         launch)


class SSDScan(torch.autograd.Function):
    """The CUDA kernels under autograd: the forward saves its inputs (the
    backward recomputes the states entering each of its chunks with the
    forward's first two kernels, rather than hold them from the forward);
    the backward launches ``ssd_scan_bwd``."""

    @staticmethod
    def forward(ctx, x, dt, a, Bm, Cm, D, chunk):
        y, h = _forward(x, dt, a, Bm, Cm, D, chunk)
        ctx.save_for_backward(x, dt, a, Bm, Cm, D)
        ctx.set_materialize_grads(False)
        return y, h

    @staticmethod
    def backward(ctx, dy, dh):
        x, dt, a, Bm, Cm, D = ctx.saved_tensors
        dy = torch.zeros_like(x) if dy is None else dy.contiguous()
        grads = ssd_scan_bwd(x, dt, a, Bm, Cm, D, dy, None if dh is None else dh.contiguous())
        return (*grads, None)


def ssd_scan(
    x: torch.Tensor,  # (B, L, H, P)
    dt: torch.Tensor,  # (B, L, H) f32, post-softplus step sizes
    a: torch.Tensor,  # (H,) f32, negative decay rates
    Bm: torch.Tensor,  # (B, L, G, N), G dividing H (G = H: pre-expanded)
    Cm: torch.Tensor,  # (B, L, G, N)
    D: torch.Tensor,  # (H,) f32 skip gain
    chunk: int = 128,
):
    """The SSD scan: ``(y, h)``, y (B, L, H, P) in x's dtype including the
    ``D * x`` skip term, and the final state h (B, H, N, P) f32 (the kernel
    writes it on every launch).

    ``chunk`` is the scan's chunk length (capped at L), as in the TPU
    kernel; the result does not depend on it beyond rounding.  The plain
    version is the token recurrence and ignores it.  The kernels take
    chunks up to 128, head dims 32 and 64 and states of 16 to 128 (a
    multiple of 16); other shapes raise.  ``DTensor``s are taken local
    (``_boundary``).
    """
    return _route.call(
        ssd_scan, x, (dt, a, Bm, Cm, D), mixed="x on the CPU but another input elsewhere",
        boundary=lambda: _boundary.ssd_heads(ssd_scan, x, dt, a, Bm, Cm, D, chunk=chunk),
        plain=lambda: ssd_scan_ref(x, dt, a, Bm, Cm, D),
        function=lambda: SSDScan.apply(x, dt, a, Bm, Cm, D, chunk),
        device=lambda: _forward(x, dt, a, Bm, Cm, D, chunk))


def _backward(x, dt, a, Bm, Cm, D, dy, dh_final) -> Tuple[torch.Tensor, ...]:
    Bsz, L, H, P = x.shape
    _check(x, dt, a, Bm, Cm, D, min(BWD_CHUNK, L))
    if dy.shape != x.shape or dy.dtype != x.dtype or dy.device != x.device or not (
            dy.is_contiguous()) or dy.data_ptr() % 16:
        raise ValueError(f"ssd_scan_bwd: dy must be a contiguous, 16-byte aligned {x.dtype} "
                         f"{tuple(x.shape)} on {x.device}; got {dy.dtype} {tuple(dy.shape)} on "
                         f"{dy.device}")
    want_h = (Bsz, H, Bm.shape[3], P)
    if dh_final is not None and (tuple(dh_final.shape) != want_h or dh_final.dtype
                                 != torch.float32 or dh_final.device != x.device
                                 or not dh_final.is_contiguous()):
        raise ValueError(f"ssd_scan_bwd: dh_final must be a contiguous float32 {want_h}; got "
                         f"{dh_final.dtype} {tuple(dh_final.shape)}")

    def launch():
        f32 = dict(dtype=torch.float32, device=x.device)
        dx, dB, dC = torch.empty_like(x), torch.empty_like(Bm), torch.empty_like(Cm)
        ddt = torch.empty((Bsz, L, H), **f32)
        da, dD = torch.empty((H,), **f32), torch.empty((H,), **f32)
        ssd_scan_bwd_launch(x, dt, a, Bm, Cm, D, dy, dh_final, dx, ddt, da, dB, dC, dD)
        return dx, ddt, da, dB, dC, dD

    return _route.device(
        ssd_scan_bwd, x, lambda: _shape.ssd_scan_bwd(x, dt, a, Bm, Cm, D, dy, dh_final), launch)


def ssd_scan_bwd(
    x: torch.Tensor,  # (B, L, H, P)
    dt: torch.Tensor,  # (B, L, H) f32
    a: torch.Tensor,  # (H,) f32
    Bm: torch.Tensor,  # (B, L, G, N)
    Cm: torch.Tensor,  # (B, L, G, N)
    D: torch.Tensor,  # (H,) f32
    dy: torch.Tensor,  # (B, L, H, P), the gradient of y, in x's dtype
    dh_final: Optional[torch.Tensor] = None,  # (B, H, N, P) f32, of h; None: 0
) -> Tuple[torch.Tensor, ...]:
    """(dx, ddt, da, dB, dC, dD) of ``ssd_scan``: dx, dB and dC in x's
    dtype (computed in f32), dB and dC summed over each group's heads; ddt,
    da and dD in f32.  The kernels run at their own chunk (``BWD_CHUNK``)
    whatever the forward's was; the shapes the forward refuses raise."""
    return _route.call(
        ssd_scan_bwd, x, (dt, a, Bm, Cm, D, dy), mixed="x on the CPU but another input elsewhere",
        plain=lambda: ssd_scan_bwd_ref(x, dt, a, Bm, Cm, D, dy, dh_final),
        device=lambda: _backward(x, dt, a, Bm, Cm, D, dy, dh_final))
