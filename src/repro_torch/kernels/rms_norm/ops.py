"""Public wrappers of the port's RMSNorm kernels.

``rms_norm``: RMSNorm over the last dim with scale ``w``, of ``x`` itself
(the plain form: the block, final, encoder-decoder and qk norms) or, given a
``gate`` z, of ``x.to(z.dtype) * silu(z)`` (the gated form: the mamba2
mixer's norm, x the scan's y in f32 or in z's dtype).  x and the gate are
read in place: any layout whose leading dims collapse to one row stride, with
unit stride along the normalised dim (the mixer's z is a column slice of the
in_proj output).  On a CUDA tensor it launches the hand-written Hopper kernel
(``csrc/rms_norm.cu``) or raises; when autograd records the call (grad mode
on and an input that needs a gradient) it goes through ``RMSNorm``, a
``torch.autograd.Function`` whose backward is ``rms_norm_bwd``.  On a CPU
tensor it computes the plain version ``rms_norm_ref`` (the models' own
formulation), through which autograd runs as usual.

``rms_norm_bwd``: on a CUDA tensor it launches the hand-written backward (dx,
dz and the scale's partials, then their reduction) or raises; on a CPU tensor
it computes ``rms_norm_bwd_ref`` (the same math, in f32).

On a mesh, ``rms_norm`` takes ``DTensor``s local (``kernels._boundary``):
the normalised dim whole.  CPU ``DTensor``s take the plain version as
``DTensor`` ops, so a mesh's CPU step keeps the unsharded step's numbers bit
for bit (the local region would sum x's gradients in another order).

On a ``meta`` tensor both take the shape-only route (``kernels._shape``):
empty outputs of the kernels' shapes, charged their FLOPs under
``FlopCounterMode``, with no launch counted.

Both check their inputs on every device.  ``rms_norm.launches`` and
``rms_norm_bwd.launches`` count wrapper calls that launched their kernels
(one per call).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from .. import _boundary, _shape
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
    if x.device.type == "meta":
        return _shape.rms_norm(x, w, gate, eps)
    D = x.shape[-1]
    out = torch.empty(x.shape, dtype=(x if gate is None else gate).dtype, device=x.device)
    rstd = torch.empty((x.numel() // D,), dtype=torch.float32, device=x.device)
    rms_norm_fwd(_row_view(x, "x"), w, None if gate is None else _row_view(gate, "the gate"),
                 eps, out.view(-1, D), rstd)
    rms_norm.launches += 1
    return out, rstd


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
    if isinstance(x, _boundary.DTensor):
        if x.device.type == "cpu":  # the plain version in DTensor ops, as the models had it
            return rms_norm_ref(x, w, eps, gate)
        return _boundary.rms_norm(rms_norm, x, w, gate, eps=eps)
    _check(x, w, gate)
    if x.device.type == "cpu":
        return rms_norm_ref(x, w, eps, gate)
    if x.device.type not in ("cuda", "meta"):
        raise ValueError(f"rms_norm: no kernel for device {x.device}")
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in (x, w, gate)):
        return RMSNorm.apply(x, w, gate, eps)
    return _forward(x, w, gate, eps)[0]


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
    if x.device.type == "cpu":
        return rms_norm_bwd_ref(x, w, rstd, dout, gate)
    if x.device.type not in ("cuda", "meta"):
        raise ValueError(f"rms_norm_bwd: no kernel for device {x.device}")
    if x.device.type == "meta":
        return _shape.rms_norm_bwd(x, w, rstd, dout, gate)
    D = x.shape[-1]
    dx = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    dw = torch.empty_like(w)
    dz = None if gate is None else torch.empty(gate.shape, dtype=gate.dtype, device=x.device)
    rms_norm_bwd_launch(_row_view(x, "x"), w,
                        None if gate is None else _row_view(gate, "the gate"), rstd,
                        dout.view(-1, D), dx.view(-1, D), dw,
                        None if dz is None else dz.view(-1, D))
    rms_norm_bwd.launches += 1
    return dx, dw, dz


rms_norm.launches = 0
rms_norm_bwd.launches = 0
