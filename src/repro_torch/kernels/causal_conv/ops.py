"""Public wrappers of the mamba2 mixer's causal-conv kernels; which one serves a
call is the route rule's (``kernels._route``).

``causal_conv``: the depthwise causal conv of width 4, bias and SiLU over the
(x, B, C) columns of the in_proj output, read in place (a (B, L, Ch) view
with any batch and row stride, unit channel stride), written as the three
contiguous tensors ``ssd_scan`` takes: ``csrc/causal_conv.cu``, its plain
version ``causal_conv_ref``, under autograd ``CausalConv``.  On a mesh the
batch splits over the data axes, time and channels whole.

``causal_conv_bwd``: dx, then the weights' partials reduced by a second
launch; plain version ``causal_conv_bwd_ref`` (the same math, in f32).

Both check their inputs on every device: the conv's width must be 4.  Each
call that launches counts one in ``.launches``.
"""
from __future__ import annotations

from typing import Tuple

import torch

from .. import _boundary, _route, _shape
from .kernel import DTYPES, TAPS, causal_conv_bwd_launch, causal_conv_fwd
from .ref import causal_conv_bwd_ref, causal_conv_ref


def _check(xbc, w, b, d_inner) -> int:
    """Raises on what the kernels do not take; returns G N."""
    if xbc.dim() != 3 or w.dim() != 2 or b.dim() != 1:
        raise ValueError(f"causal_conv: want x (B,L,Ch), w (K,Ch), b (Ch,); got "
                         f"{tuple(xbc.shape)}, {tuple(w.shape)}, {tuple(b.shape)}")
    Bsz, L, Ch = xbc.shape
    if w.shape[0] != TAPS:
        raise ValueError(f"causal_conv: the kernel takes a conv of width {TAPS}; got "
                         f"{w.shape[0]}")
    if w.shape[1] != Ch or b.shape[0] != Ch:
        raise ValueError(f"causal_conv: x has {Ch} channels, w {tuple(w.shape)}, b "
                         f"{tuple(b.shape)}")
    gn = (Ch - d_inner) // 2
    if not (1 <= d_inner and gn >= 1 and d_inner + 2 * gn == Ch):
        raise ValueError(f"causal_conv: {Ch} channels do not split into d_inner {d_inner} "
                         "and two equal widths of B and C")
    if L < 1:
        raise ValueError("causal_conv: want at least one time step")
    if xbc.dtype not in DTYPES or w.dtype not in DTYPES or w.dtype != b.dtype:
        raise TypeError(f"causal_conv: want x and w each one of {list(DTYPES)}, b in w's "
                        f"dtype; got {xbc.dtype}, {w.dtype}, {b.dtype}")
    if len({t.device for t in (xbc, w, b)}) != 1:
        raise ValueError("causal_conv: inputs on different devices")
    if xbc.stride(2) != 1:
        raise ValueError("causal_conv: x's channels must be contiguous (unit stride)")
    if not (w.is_contiguous() and b.is_contiguous()):
        raise ValueError("causal_conv: w and b must be contiguous")
    return gn


def _forward(xbc, w, b, d_inner) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    def launch():
        Bsz, L, Ch = xbc.shape
        gn = (Ch - d_inner) // 2
        out = dict(dtype=torch.promote_types(xbc.dtype, w.dtype), device=xbc.device)
        xs = torch.empty((Bsz, L, d_inner), **out)
        bo, co = torch.empty((Bsz, L, gn), **out), torch.empty((Bsz, L, gn), **out)
        causal_conv_fwd(xbc, w, b, xs, bo, co)
        return xs, bo, co

    return _route.device(causal_conv, xbc, lambda: _shape.causal_conv(xbc, w, b, d_inner),
                         launch)


class CausalConv(torch.autograd.Function):
    """The CUDA kernels under autograd: the forward saves its inputs (the
    view of the in_proj output and the weights; the backward recomputes the
    pre-activation from them) and no intermediate; the backward launches
    ``causal_conv_bwd``."""

    @staticmethod
    def forward(ctx, xbc, w, b, d_inner):
        out = _forward(xbc, w, b, d_inner)
        ctx.save_for_backward(xbc, w, b)
        return out

    @staticmethod
    def backward(ctx, dxs, dB, dC):
        xbc, w, b = ctx.saved_tensors
        return (*causal_conv_bwd(xbc, w, b, dxs.contiguous(), dB.contiguous(),
                                 dC.contiguous()), None)


def causal_conv(
    xbc: torch.Tensor,  # (B, L, Ch), Ch = d_inner + 2 G N; unit channel stride
    w: torch.Tensor,  # (4, Ch)
    b: torch.Tensor,  # (Ch,), in w's dtype
    d_inner: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(xs, B, C) = silu(causal_conv(xbc, w) + b) split at ``d_inner`` and
    ``d_inner + G N``: xs (B, L, d_inner) and B and C (B, L, G N), each
    contiguous, in promote(xbc, w), the taps summed in f32 (in that dtype on
    the CPU).  ``DTensor``s are taken local (``_boundary``)."""
    return _route.call(
        causal_conv, xbc, (w, b), check=lambda: _check(xbc, w, b, d_inner),
        boundary=lambda: _boundary.causal_conv(causal_conv, xbc, w, b, d_inner=d_inner),
        plain=lambda: causal_conv_ref(xbc, w, b, d_inner),
        function=lambda: CausalConv.apply(xbc, w, b, d_inner),
        device=lambda: _forward(xbc, w, b, d_inner))


def causal_conv_bwd(
    xbc: torch.Tensor,  # (B, L, Ch)
    w: torch.Tensor,  # (4, Ch)
    b: torch.Tensor,  # (Ch,)
    dxs: torch.Tensor,  # (B, L, d_inner), in promote(xbc, w)
    dB: torch.Tensor,  # (B, L, G N)
    dC: torch.Tensor,  # (B, L, G N)
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dx, dw, db) of ``causal_conv``: dx (B, L, Ch) contiguous in xbc's
    dtype (summed in f32, rounded once), dw (4, Ch) and db (Ch,) in w's."""
    d_inner = dxs.shape[-1]
    gn = _check(xbc, w, b, d_inner)
    Bsz, L, _ = xbc.shape
    want = torch.promote_types(xbc.dtype, w.dtype)
    for name, t, width in (("dxs", dxs, d_inner), ("dB", dB, gn), ("dC", dC, gn)):
        if (tuple(t.shape) != (Bsz, L, width) or t.dtype != want or t.device != xbc.device
                or not t.is_contiguous()):
            raise ValueError(f"causal_conv_bwd: {name} must be a contiguous {want} "
                             f"{(Bsz, L, width)} on {xbc.device}; got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")

    def launch():
        dx = torch.empty(xbc.shape, dtype=xbc.dtype, device=xbc.device)
        dw, db = torch.empty_like(w), torch.empty_like(b)
        causal_conv_bwd_launch(xbc, w, b, dxs, dB, dC, dx, dw, db)
        return dx, dw, db

    return _route.call(
        causal_conv_bwd, xbc,
        plain=lambda: causal_conv_bwd_ref(xbc, w, b, dxs, dB, dC),
        device=lambda: _route.device(
            causal_conv_bwd, xbc, lambda: _shape.causal_conv_bwd(xbc, w, b, dxs, dB, dC), launch))
