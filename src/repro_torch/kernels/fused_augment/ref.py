"""Plain PyTorch version of fused crop + horizontal flip + normalise (twin
of ``repro/kernels/fused_augment/ref.py``): per image a crop at (y0, x0) of
(out_h, out_w), reversed along W when its flip is > 0, then
``(x / 255 - mean) / std`` in f32.  The corner is taken as
``lax.dynamic_slice`` takes it in the JAX reference: a negative start is
first wrapped once by the dimension, then clamped so the crop fits."""
from __future__ import annotations

import torch


def fused_augment_ref(
    images: torch.Tensor,  # (B, H, W, C) uint8
    crops: torch.Tensor,  # (B, 2) int32 (y0, x0) top-left corners
    flips: torch.Tensor,  # (B,) int32 flags
    mean: torch.Tensor,  # (C,) f32
    std: torch.Tensor,  # (C,) f32
    out_h: int,
    out_w: int,
) -> torch.Tensor:
    B, H, W, _ = images.shape
    dev = images.device
    y0, x0 = crops[:, 0].long(), crops[:, 1].long()
    y0 = torch.where(y0 < 0, y0 + H, y0).clamp(0, H - out_h)
    x0 = torch.where(x0 < 0, x0 + W, x0).clamp(0, W - out_w)
    rows = y0[:, None] + torch.arange(out_h, device=dev)  # (B, out_h)
    cols = x0[:, None] + torch.arange(out_w, device=dev)  # (B, out_w)
    cols = torch.where(flips[:, None] > 0, cols.flip(1), cols)
    tile = images[torch.arange(B, device=dev)[:, None, None], rows[:, :, None], cols[:, None, :]]
    return (tile.float() / 255.0 - mean.float()) / std.float()
