"""The port's ``fused_augment`` against the JAX package's.

On the CPU the port's wrapper computes its plain version; these tests hold
it against the Pallas kernel run in interpret mode and against the JAX
reference ``fused_augment_ref``, on the shapes of
``tests/test_kernels.py::TestFusedAugment`` with its tolerance, atol = rtol =
1e-5 (``x * (1 / (255 std)) - mean / std`` in the kernel against
``(x / 255 - mean) / std``: one f32 rounding path against another).  A corner
out of range is taken as ``lax.dynamic_slice`` takes it in the JAX reference
(jax 0.9: a negative start is wrapped once by the dimension, then the start
is clamped so the crop fits), in the port's plain version and its CUDA
kernel alike; the Pallas kernel in interpret mode does the same.

The CUDA kernel itself runs only on the card (``chip_smoke.py``).
"""
import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")
import jax.numpy as jnp
import numpy as np
import torch

from repro.kernels.fused_augment.ops import fused_augment as jax_fused_augment
from repro.kernels.fused_augment.ref import fused_augment_ref as jax_fused_augment_ref
from repro_torch.kernels import KERNELS, launch_counts, reset_launch_counts
from repro_torch.kernels.fused_augment import fused_augment, fused_augment_ref

TOL = 1e-5
MEAN = [0.485, 0.456, 0.406]
STD = [0.229, 0.224, 0.225]


def _inputs(rng, B, H, W, C, oh, ow, corners=None):
    img = rng.integers(0, 256, (B, H, W, C)).astype(np.uint8)
    if corners is None:
        corners = np.stack([rng.integers(0, H - oh + 1, B), rng.integers(0, W - ow + 1, B)], -1)
    crops = np.asarray(corners, np.int32)
    flips = rng.integers(0, 2, B).astype(np.int32)
    mean = np.asarray(MEAN[:C], np.float32)
    std = np.asarray(STD[:C], np.float32)
    return img, crops, flips, mean, std


def _both(args, oh, ow):
    """(port, Pallas interpret, JAX ref) outputs as numpy."""
    got = fused_augment(*(torch.from_numpy(a) for a in args), out_h=oh, out_w=ow)
    jargs = [jnp.asarray(a) for a in args]
    kern = jax_fused_augment(*jargs, out_h=oh, out_w=ow, interpret=True)
    ref = jax_fused_augment_ref(*jargs, oh, ow)
    return got.numpy(), np.asarray(kern), np.asarray(ref)


@pytest.mark.parametrize(
    "B,H,W,C,oh,ow",
    [
        (2, 64, 64, 3, 32, 32),
        (4, 48, 56, 3, 32, 40),
        (1, 224, 224, 3, 192, 192),
        (3, 40, 40, 1, 40, 40),  # no-crop grayscale
    ],
)
def test_vs_pallas_and_ref(B, H, W, C, oh, ow):
    args = _inputs(np.random.default_rng(B * 1000 + H), B, H, W, C, oh, ow)
    got, kern, ref = _both(args, oh, ow)
    assert got.dtype == np.float32 and got.shape == (B, oh, ow, C)
    np.testing.assert_allclose(got, kern, atol=TOL, rtol=TOL)
    np.testing.assert_allclose(got, ref, atol=TOL, rtol=TOL)


def test_flip_is_involution():
    img, _, _, _, _ = _inputs(np.random.default_rng(7), 1, 16, 16, 3, 16, 16)
    args = [torch.from_numpy(img), torch.zeros((1, 2), dtype=torch.int32)]
    mean, std = torch.zeros(3), torch.ones(3)
    a = fused_augment(*args, torch.ones(1, dtype=torch.int32), mean, std, out_h=16, out_w=16)
    b = fused_augment(*args, torch.zeros(1, dtype=torch.int32), mean, std, out_h=16, out_w=16)
    np.testing.assert_allclose(a.flip(2).numpy(), b.numpy(), atol=1e-6)


@pytest.mark.parametrize("corners", [
    [[-5, 3], [40, 30], [100, -7], [2, 200]],  # past every edge, both signs
    [[-1000, -1000], [1000, 1000], [16, 16], [17, 17]],  # far out, and just past the limit
])
def test_out_of_range_corner_is_clamped(corners):
    """A negative y0 (x0) is wrapped once by H (W), then the corner is
    clamped to [0, H - out_h] x [0, W - out_w], as ``lax.dynamic_slice``
    takes it in the JAX reference."""
    H, W, oh, ow = 48, 56, 32, 40
    args = _inputs(np.random.default_rng(3), 4, H, W, 3, oh, ow, corners)
    got, kern, ref = _both(args, oh, ow)
    np.testing.assert_allclose(got, ref, atol=TOL, rtol=TOL)
    np.testing.assert_allclose(got, kern, atol=TOL, rtol=TOL)
    y0, x0 = args[1][:, 0], args[1][:, 1]
    y0, x0 = np.where(y0 < 0, y0 + H, y0), np.where(x0 < 0, x0 + W, x0)
    clamped = np.stack([np.clip(y0, 0, H - oh), np.clip(x0, 0, W - ow)], -1)
    got_clamped, _, _ = _both((args[0], clamped.astype(np.int32)) + args[2:], oh, ow)
    np.testing.assert_array_equal(got, got_clamped)


def test_cpu_takes_plain_version():
    reset_launch_counts()
    args = [torch.from_numpy(a) for a in _inputs(np.random.default_rng(1), 2, 20, 24, 3, 8, 12)]
    got = fused_augment(*args, out_h=8, out_w=12)
    assert torch.equal(got, fused_augment_ref(*args, 8, 12))
    assert launch_counts() == {name: 0 for name in KERNELS}


def test_other_devices_raise():
    """A device that is neither CPU nor CUDA raises; ``meta`` (the dry run's
    device) takes the shape-only route and computes nothing."""

    class Other:  # a tensor on a device with no kernel ("xla")
        device = torch.device("xla")

    with pytest.raises(ValueError, match="no kernel"):
        fused_augment(Other(), *[Other()] * 4, out_h=4, out_w=4)
    img = torch.empty((1, 8, 8, 3), dtype=torch.uint8, device="meta")
    other = [torch.empty(s, dtype=d, device="meta") for s, d in
             (((1, 2), torch.int32), ((1,), torch.int32), ((3,), torch.float32),
              ((3,), torch.float32))]
    out = fused_augment(img, *other, out_h=4, out_w=4)
    assert out.device.type == "meta" and out.shape == (1, 4, 4, 3)
    assert out.dtype == torch.float32
