"""Public wrappers of the port's RMSNorm kernels; which one serves a call is
the route rule's (``kernels._route``).

``rms_norm``: RMSNorm over the last dim with scale ``w``, of ``x`` itself
(the plain form: the block, final, encoder-decoder and qk norms) or, given a
``gate`` z, of ``x.to(z.dtype) * silu(z)`` (the gated form: the mamba2
mixer's norm, x the scan's y in f32 or in z's dtype).  x and the gate are
read in place: any layout whose leading dims collapse to one row stride, with
unit stride along the normalised dim (the mixer's z is a column slice of the
in_proj output).  ``csrc/rms_norm.cu``, plain version ``rms_norm_ref`` (the
models' own formulation), under autograd ``RMSNorm``.  On a mesh the
normalised dim stays whole; CPU ``DTensor``s take the plain version as
``DTensor`` ops, so a mesh's CPU step keeps the unsharded step's numbers bit
for bit (the local region would sum x's gradients in another order).

``rms_norm_bwd``: dx, dz and the scale's partials, then their reduction;
plain version ``rms_norm_bwd_ref`` (the same math, in f32).

Both check their inputs on every device.  Each call that launches counts one
in ``.launches``.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from .. import _boundary, _route, _shape
from .kernel import DTYPES, MAX_GATED_WIDTH, MAX_WIDTH, rms_norm_bwd_launch, rms_norm_fwd
from .ref import rms_norm_bwd_ref, rms_norm_ref


def _row_view(t: torch.Tensor, name: str) -> torch.Tensor:
    """``t`` as a (rows, D) view: raises where its leading dims do not
    collapse to one row stride or its last dim is not contiguous."""
    D = t.shape[-1]
    if t.stride(-1) != 1 and D > 1:
        raise ValueError(f"rms_norm: {name}'s last dim must have unit stride; got strides "
                         f"{t.stride()}")
    try:
        return t.view(-1, D)
    except RuntimeError as e:
        raise ValueError(f"rms_norm: {name}'s leading dims must collapse to one row stride; "
                         f"got shape {tuple(t.shape)}, strides {t.stride()}") from e


def _check(x, w, gate) -> None:
    """Raises on what the kernels do not take."""
    if x.dim() < 1 or w.dim() != 1 or w.shape[0] != x.shape[-1]:
        raise ValueError(f"rms_norm: want x (..., D) and w (D,); got {tuple(x.shape)}, "
                         f"{tuple(w.shape)}")
    D = x.shape[-1]
    widest = MAX_WIDTH if gate is None else MAX_GATED_WIDTH
    if not 1 <= D <= widest:
        raise ValueError(f"rms_norm: the kernel takes widths 1 to {widest}"
                         f"{'' if gate is None else ' gated'}; got {D}")
    if x.dtype not in DTYPES or w.dtype not in DTYPES:
        raise TypeError(f"rms_norm: x's and w's dtypes must each be one of {list(DTYPES)}; got "
                        f"{x.dtype}, {w.dtype}")
    if gate is not None:
        if gate.shape != x.shape:
            raise ValueError(f"rms_norm: the gate's shape {tuple(gate.shape)} is not x's "
                             f"{tuple(x.shape)}")
        if gate.dtype not in DTYPES or x.dtype not in (torch.float32, gate.dtype):
            raise TypeError(f"rms_norm: want a gate in one of {list(DTYPES)} and x in f32 or "
                            f"the gate's dtype; got x {x.dtype}, gate {gate.dtype}")
    if len({t.device for t in (x, w, gate) if t is not None}) != 1:
        raise ValueError("rms_norm: inputs on different devices")
    if not w.is_contiguous():
        raise ValueError("rms_norm: w must be contiguous")
    _row_view(x, "x")
    if gate is not None:
        _row_view(gate, "the gate")


def _forward(x, w, gate, eps) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out, rstd) of the kernel: out in x's shape and the gate's dtype (x's
    without one), contiguous; rstd (rows,) f32."""
    def launch():
        D = x.shape[-1]
        out = torch.empty(x.shape, dtype=(x if gate is None else gate).dtype, device=x.device)
        rstd = torch.empty((x.numel() // D,), dtype=torch.float32, device=x.device)
        rms_norm_fwd(_row_view(x, "x"), w, None if gate is None else _row_view(gate, "the gate"),
                     eps, out.view(-1, D), rstd)
        return out, rstd

    return _route.device(rms_norm, x, lambda: _shape.rms_norm(x, w, gate, eps), launch)


class RMSNorm(torch.autograd.Function):
    """The CUDA kernels under autograd: the forward saves its inputs (x, w,
    the gate: views, no copies) and each row's rstd; the backward launches
    ``rms_norm_bwd``, which recomputes the gated product from them."""

    @staticmethod
    def forward(ctx, x, w, gate, eps):
        out, rstd = _forward(x, w, gate, eps)
        ctx.save_for_backward(x, w, gate, rstd)
        return out

    @staticmethod
    def backward(ctx, dout):
        x, w, gate, rstd = ctx.saved_tensors
        return (*rms_norm_bwd(x, w, rstd, dout.contiguous(), gate), None)


def rms_norm(
    x: torch.Tensor,  # (..., D)
    w: torch.Tensor,  # (D,)
    eps: float,
    gate: Optional[torch.Tensor] = None,  # (..., D), x's shape
) -> torch.Tensor:
    """RMSNorm of x (or of ``x.to(gate.dtype) * silu(gate)``) over its last
    dim with scale w, in x's dtype (the gate's): squares summed in f32,
    ``p32 * rsqrt(mean + eps) * w32`` rounded once.  ``DTensor``s are taken
    local (``_boundary``)."""
    return _route.call(
        rms_norm, x, (w, gate), check=lambda: _check(x, w, gate), plain_cpu_dtensor=True,
        boundary=lambda: _boundary.rms_norm(rms_norm, x, w, gate, eps=eps),
        plain=lambda: rms_norm_ref(x, w, eps, gate),
        function=lambda: RMSNorm.apply(x, w, gate, eps),
        device=lambda: _forward(x, w, gate, eps)[0])


def rms_norm_bwd(
    x: torch.Tensor,  # (..., D)
    w: torch.Tensor,  # (D,)
    rstd: torch.Tensor,  # (rows,) f32, the forward's
    dout: torch.Tensor,  # (..., D) contiguous, in the output's dtype
    gate: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """(dx, dw, dgate) of ``rms_norm``: dx contiguous in x's dtype, dw in
    w's, dgate contiguous in the gate's (None without one); summed in f32,
    each rounded once."""
    _check(x, w, gate)
    rows = x.numel() // x.shape[-1]
    want = (x if gate is None else gate).dtype
    if tuple(rstd.shape) != (rows,) or rstd.dtype != torch.float32 or rstd.device != x.device:
        raise ValueError(f"rms_norm_bwd: rstd must be f32 ({rows},) on {x.device}; got "
                         f"{rstd.dtype} {tuple(rstd.shape)} on {rstd.device}")
    if (dout.shape != x.shape or dout.dtype != want or dout.device != x.device
            or not dout.is_contiguous()):
        raise ValueError(f"rms_norm_bwd: dout must be a contiguous {want} {tuple(x.shape)} on "
                         f"{x.device}; got {dout.dtype} {tuple(dout.shape)} on {dout.device}")

    def launch():
        D = x.shape[-1]
        dx = torch.empty(x.shape, dtype=x.dtype, device=x.device)
        dw = torch.empty_like(w)
        dz = None if gate is None else torch.empty(gate.shape, dtype=gate.dtype, device=x.device)
        rms_norm_bwd_launch(_row_view(x, "x"), w,
                            None if gate is None else _row_view(gate, "the gate"), rstd,
                            dout.view(-1, D), dx.view(-1, D), dw,
                            None if dz is None else dz.view(-1, D))
        return dx, dw, dz

    return _route.call(
        rms_norm_bwd, x,
        plain=lambda: rms_norm_bwd_ref(x, w, rstd, dout, gate),
        device=lambda: _route.device(
            rms_norm_bwd, x, lambda: _shape.rms_norm_bwd(x, w, rstd, dout, gate), launch))
