"""Plain PyTorch versions of the port's RMSNorm, plain and gated by SiLU.

``rms_norm_ref`` is the models' formulation before the kernel: with a gate
(the mamba2 mixer's gated norm) the input is first ``p = y.to(z.dtype) *
silu(z)``, in z's dtype, as ``mamba2_mixer`` and ``mamba2_decode`` computed
it; then ``(p32 * rsqrt(mean(p32 ** 2) + eps) * w32)`` back in p's dtype,
where ``p32`` is p in f32 (in f64 for an f64 p).

``rms_norm_bwd_ref`` is its backward with the kernel's math in f32 (or in
``acc``): with ``r`` the row's rstd and ``dn = dout * w``,
``dp = r dn - p r^3 sum(dn p) / D`` and ``dw = sum over rows of dout p r``;
with a gate, ``dy = dp * silu(z)`` and ``dz = dp * y' * silu'(z)``, where
``y'`` and ``silu(z)`` are rounded to z's dtype as the forward rounds them."""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F


def gate_product(x: torch.Tensor, gate: Optional[torch.Tensor]) -> torch.Tensor:
    """The normalised input: ``x`` itself, or ``x.to(gate.dtype) * silu(gate)``
    in the gate's dtype."""
    return x if gate is None else x.to(gate.dtype) * F.silu(gate)


def _acc(*ts: Optional[torch.Tensor]) -> torch.dtype:
    """f32, or f64 when an input is f64."""
    acc = torch.float32
    for t in ts:
        if t is not None:
            acc = torch.promote_types(acc, t.dtype)
    return acc


def rms_norm_ref(
    x: torch.Tensor,  # (..., D); with a gate the mixer's y, in f32 or z's dtype
    w: torch.Tensor,  # (D,)
    eps: float,
    gate: Optional[torch.Tensor] = None,  # (..., D), x's shape
) -> torch.Tensor:
    """RMSNorm of ``gate_product(x, gate)`` over its last dim with scale
    ``w``, in its dtype."""
    p = gate_product(x, gate)
    x32 = p.to(_acc(p))
    var = (x32 * x32).mean(dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * w.to(x32.dtype)).to(p.dtype)


def rstd_ref(x: torch.Tensor, eps: float, gate: Optional[torch.Tensor] = None,
             acc: Optional[torch.dtype] = None) -> torch.Tensor:
    """Each row's ``rsqrt(mean(p ** 2) + eps)``, (rows,) in ``acc`` (f32 by
    default), p rounded as the forward rounds it."""
    p = gate_product(x, gate)
    p = p.to(acc or _acc(p)).reshape(-1, p.shape[-1])
    return torch.rsqrt((p * p).mean(dim=-1) + eps)


def rms_norm_bwd_ref(
    x: torch.Tensor,  # (..., D)
    w: torch.Tensor,  # (D,)
    rstd: torch.Tensor,  # (rows,), rows = x.numel() // D
    dout: torch.Tensor,  # (..., D), the gradient of the output
    gate: Optional[torch.Tensor] = None,
    acc: Optional[torch.dtype] = None,
) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """(dx, dw, dgate) of ``rms_norm_ref`` given the forward's ``rstd``: dx in
    x's dtype, dw in w's, dgate in the gate's (None without one), all
    computed in ``acc`` (f32, or f64 for f64 inputs, by default)."""
    acc = acc or _acc(x, w, dout, gate)
    D = x.shape[-1]
    if gate is None:
        p = x.to(acc)
    else:
        a, s = x.to(gate.dtype), F.silu(gate)
        p = (a * s).to(acc)
    r = rstd.to(acc).reshape(*x.shape[:-1], 1)
    g = dout.to(acc)
    dn = g * w.to(acc)
    dot = (dn * p).sum(dim=-1, keepdim=True)
    dp = r * dn - p * (r * r * r * dot / D)
    dw = (g * (p * r)).reshape(-1, D).sum(dim=0).to(w.dtype)
    if gate is None:
        return dp.to(x.dtype), dw, None
    z = gate.to(acc)
    sig = torch.sigmoid(z)
    dz = dp * a.to(acc) * (sig * (1 + z * (1 - sig)))
    return (dp * s.to(acc)).to(x.dtype), dw, dz.to(gate.dtype)
