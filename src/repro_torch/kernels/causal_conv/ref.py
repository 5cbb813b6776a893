"""Plain PyTorch versions of the mamba2 mixer's depthwise causal conv of
width 4, bias and SiLU over its (x, B, C) columns.

``causal_conv_ref`` is the mixer's formulation before the kernel (the twin of
``models/layers.py::_depthwise_causal_conv`` followed by ``F.silu``: the
input padded by K - 1 rows, one product and sum a tap, in the dtype PyTorch
promotes x and w to), split into the three contiguous outputs the kernel
writes.  ``causal_conv_bwd_ref`` is its backward with the kernel's math in
f32: g = dout * silu'(pre), dx[s] = sum_k w[k] g[s + 3 - k] rounded once to
x's dtype, dw[k] = sum g[t] x[t - 3 + k] and db = sum g[t] in w's dtype."""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F


def _conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """x (B, L, Ch), w (K, Ch), b (Ch,): the pre-activation, the taps summed
    in order, then the bias."""
    K, L = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, K - 1, 0))
    out = torch.zeros_like(x)
    for i in range(K):
        out = out + xp[:, i:i + L, :] * w[i][None, None, :]
    return out + b[None, None, :]


def causal_conv_ref(
    xbc: torch.Tensor,  # (B, L, Ch), Ch = d_inner + 2 G N; any strides
    w: torch.Tensor,  # (4, Ch)
    b: torch.Tensor,  # (Ch,)
    d_inner: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(xs, B, C): silu(conv(xbc) + b) split at ``d_inner`` and
    ``d_inner + G N``, each contiguous, in promote(xbc, w)."""
    gn = (xbc.shape[2] - d_inner) // 2
    out = F.silu(_conv(xbc, w, b))
    return tuple(t.contiguous() for t in torch.split(out, [d_inner, gn, gn], dim=-1))


def causal_conv_bwd_ref(
    xbc: torch.Tensor,  # (B, L, Ch)
    w: torch.Tensor,  # (4, Ch)
    b: torch.Tensor,  # (Ch,)
    dxs: torch.Tensor,  # (B, L, d_inner), the gradient of xs
    dB: torch.Tensor,  # (B, L, G N)
    dC: torch.Tensor,  # (B, L, G N)
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dx, dw, db) of ``causal_conv_ref``: dx (B, L, Ch) in xbc's dtype,
    dw and db in w's, all computed in f32 (f64 inputs in f64)."""
    K, L = w.shape[0], xbc.shape[1]
    acc = torch.promote_types(torch.promote_types(xbc.dtype, w.dtype), torch.float32)
    xa, wa = xbc.to(acc), w.to(acc)
    pre = _conv(xa, wa, b.to(acc))
    s = torch.sigmoid(pre)
    g = torch.cat([dxs, dB, dC], dim=-1).to(acc) * (s * (1 + pre * (1 - s)))
    gp = F.pad(g, (0, 0, 0, K - 1))  # g past L is zero
    xp = F.pad(xa, (0, 0, K - 1, 0))  # x before 0 is zero
    dx = sum(gp[:, K - 1 - k:K - 1 - k + L, :] * wa[k] for k in range(K))
    dw = torch.stack([(g * xp[:, k:k + L, :]).sum((0, 1)) for k in range(K)])
    return dx.to(xbc.dtype), dw.to(w.dtype), g.sum((0, 1)).to(b.dtype)
