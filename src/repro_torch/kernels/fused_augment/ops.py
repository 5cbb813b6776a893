"""Public wrapper of the fused crop + flip + normalise kernel
(``csrc/fused_augment.cu``, plain version ``fused_augment_ref``; the route:
``kernels._route``).  No model path calls it, in either package: it is the
standalone op of the JAX package's ``repro.kernels.fused_augment``.
"""
from __future__ import annotations

import torch

from .. import _boundary, _route, _shape
from .kernel import MAX_CHANNELS, fused_augment_fwd
from .ref import fused_augment_ref


def _check(images, crops, flips, mean, std, out_h: int, out_w: int) -> None:
    if images.dim() != 4 or images.dtype != torch.uint8:
        raise TypeError(f"fused_augment: want uint8 images (B,H,W,C); got {images.dtype} "
                        f"{tuple(images.shape)}")
    B, H, W, C = images.shape
    if not 1 <= C <= MAX_CHANNELS:
        raise ValueError(f"fused_augment: {C} channels, the kernel takes 1..{MAX_CHANNELS}")
    if not (1 <= out_h <= H and 1 <= out_w <= W):
        raise ValueError(f"fused_augment: crop {out_h}x{out_w} does not fit images {H}x{W}")
    if crops.dtype != torch.int32 or tuple(crops.shape) != (B, 2):
        raise TypeError(f"fused_augment: crops must be int32 ({B}, 2); got {crops.dtype} "
                        f"{tuple(crops.shape)}")
    if flips.dtype != torch.int32 or tuple(flips.shape) != (B,):
        raise TypeError(f"fused_augment: flips must be int32 ({B},); got {flips.dtype} "
                        f"{tuple(flips.shape)}")
    for name, t in (("mean", mean), ("std", std)):
        if t.dtype != torch.float32 or tuple(t.shape) != (C,):
            raise TypeError(f"fused_augment: {name} must be float32 ({C},); got {t.dtype} "
                            f"{tuple(t.shape)}")
    if len({t.device for t in (images, crops, flips, mean, std)}) != 1:
        raise ValueError("fused_augment: inputs on different devices")
    for name, t in (("images", images), ("crops", crops), ("flips", flips), ("mean", mean),
                    ("std", std)):
        if not t.is_contiguous():
            raise ValueError(f"fused_augment: {name} must be contiguous")


def _device(images, crops, flips, mean, std, out_h: int, out_w: int) -> torch.Tensor:
    _check(images, crops, flips, mean, std, out_h, out_w)

    def launch():
        B, _, _, C = images.shape
        out = torch.empty((B, out_h, out_w, C), dtype=torch.float32, device=images.device)
        fused_augment_fwd(images, crops, flips, mean, std, out)
        return out

    return _route.device(
        fused_augment, images,
        lambda: _shape.fused_augment(images, crops, flips, mean, std, out_h, out_w), launch)


def fused_augment(
    images: torch.Tensor,  # (B, H, W, C) uint8
    crops: torch.Tensor,  # (B, 2) int32 (y0, x0) top-left corners
    flips: torch.Tensor,  # (B,) int32 flags
    mean: torch.Tensor,  # (C,) f32
    std: torch.Tensor,  # (C,) f32
    out_h: int = 224,
    out_w: int = 224,
) -> torch.Tensor:
    """Crop each image at its corner to (out_h, out_w), flip it along W when
    its flag is > 0, and normalise: f32 (B, out_h, out_w, C).  A corner out
    of range is taken as ``lax.dynamic_slice`` takes it (a negative start
    wrapped once by the dimension, then clamped so the crop fits).
    ``DTensor``s are taken local (``_boundary``): images, crops and flips
    over the data axes, mean and std whole."""
    return _route.call(
        fused_augment, images, (crops, flips, mean, std),
        mixed="images on the CPU but another input elsewhere",
        boundary=lambda: _boundary.batched(fused_augment, (images, crops, flips, mean, std), 3,
                                           out_h=out_h, out_w=out_w),
        plain=lambda: fused_augment_ref(images, crops, flips, mean, std, out_h, out_w),
        device=lambda: _device(images, crops, flips, mean, std, out_h, out_w))
