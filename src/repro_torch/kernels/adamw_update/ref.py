"""Plain PyTorch version of the AdamW update of one leaf, in place.

The JAX package's ``upd`` (``repro/train/optimizer.py``, ``apply_updates``)
term by term, in f32: ``g32 = g * scale``, ``m = b1 m + (1 - b1) g32``,
``v = b2 v + (1 - b2) g32 g32``, ``delta = (m / c1) / (sqrt(v / c2) + eps)``,
``+ weight_decay * p`` on a leaf of ``ndim >= 2``, ``p - lr * delta``; p, m and
v are written back in their own dtypes."""
from __future__ import annotations

import torch


def adamw_update_ref(
    p: torch.Tensor,  # the leaf, updated in place
    g: torch.Tensor,  # its gradient, p's shape
    m: torch.Tensor,  # first moment, p's shape, updated in place
    v: torch.Tensor,  # second moment, m's dtype, updated in place
    scale: torch.Tensor,  # 0-d f32: the clip scale
    *, lr: float, b1: float, b2: float, eps: float, c1: float, c2: float,
    weight_decay: float,
) -> None:
    f32 = torch.float32
    g32 = g.to(f32) * scale
    m32 = b1 * m.to(f32) + (1 - b1) * g32
    v32 = b2 * v.to(f32) + (1 - b2) * g32 * g32
    delta = (m32 / c1) / (torch.sqrt(v32 / c2) + eps)
    if p.dim() >= 2:  # decoupled weight decay on matrices only
        delta = delta + weight_decay * p.to(f32)
    p.copy_(p.to(f32) - lr * delta)
    m.copy_(m32)
    v.copy_(v32)
