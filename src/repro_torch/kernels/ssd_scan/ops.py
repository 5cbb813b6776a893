"""Public wrapper of the mamba2 SSD-scan kernel.

On a CUDA tensor it launches the hand-written Hopper kernels
(``csrc/ssd_scan.cu``: chunk states, state passing, chunk output) or
raises; on a CPU tensor it computes the plain version ``ssd_scan_ref``.
``ssd_scan.launches`` counts wrapper calls that launched them (one per
call).
"""
from __future__ import annotations

import torch

from .._grad import refuse_grad
from .kernel import DTYPES, HEAD_DIMS, MAX_CHUNK, MAX_STATE, ssd_scan_fwd
from .ref import ssd_scan_ref


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
    multiple of 16); other shapes raise.
    """
    if x.device.type == "cpu":
        if any(t.device.type != "cpu" for t in (dt, a, Bm, Cm, D)):
            raise ValueError("ssd_scan: x on the CPU but another input elsewhere")
        return ssd_scan_ref(x, dt, a, Bm, Cm, D)
    if x.device.type != "cuda":
        raise ValueError(f"ssd_scan: no kernel for device {x.device}")
    refuse_grad("ssd_scan", x, dt, a, Bm, Cm, D)
    chunk = min(chunk, x.shape[1])
    _check(x, dt, a, Bm, Cm, D, chunk)
    Bsz, L, H, P = x.shape
    y = torch.empty_like(x)
    h = torch.empty((Bsz, H, Bm.shape[3], P), dtype=torch.float32, device=x.device)
    ssd_scan_fwd(x, dt, a, Bm, Cm, D, y, h, chunk=chunk)
    ssd_scan.launches += 1
    return y, h


ssd_scan.launches = 0
