"""Frozen FLOP and byte formulas of the port's kernels and the card's peaks.

A copy of ``repro_torch/launch/flops.py`` as it stood when the benchmark was
defined (``portbench/tests/test_portbench_flops.py`` holds the two equal at the cells'
shapes), with the byte counts that ``chip_smoke.py`` used for the SSD
bounds.  The program may change its own copy; the yardstick does not move
with it.

Every count is the least work the function needs on the call's data: the
SSD counts the causal half of each chunk's products.
"""
from __future__ import annotations

from typing import Dict

# Published dense peaks of one H100 SXM at 700 W: bf16 and tf32 tensor cores,
# f32 outside the tensor cores, HBM3 bandwidth.
PEAK_FLOPS = {"bfloat16": 989e12, "tf32": 495e12, "float32": 67e12}
HBM_BYTES_PER_S = 3.35e12


def bound_s(flops: float, nbytes: float, unit: str) -> float:
    """The least seconds one H100 could take: the larger of ``flops`` at the
    peak of ``unit`` and ``nbytes`` at the HBM rate."""
    return max(flops / PEAK_FLOPS[unit], nbytes / HBM_BYTES_PER_S)


# ---------------------------------------------------------------------------
# SSD scan
# ---------------------------------------------------------------------------
def ssd_product_flops(B, L, H, P, N, chunk, groups=None) -> Dict[str, float]:
    """FLOPs of each product of an ssd_scan call: per chunk of q tokens, the
    q(q+1)/2 causal entries of C.B^T (2N each) once per group, and per head
    those of W x (2P each), C h and the state update (2qNP each)."""
    G = groups or H
    Q = min(chunk, L)
    qs = [min(Q, L - c) for c in range(0, L, Q)]
    return dict(cb=float(B * G * sum(q * (q + 1) * N for q in qs)),
                wx=float(B * H * sum(q * (q + 1) * P for q in qs)),
                ch=float(B * H * sum(2 * q * N * P for q in qs)),
                state=float(B * H * sum(2 * q * N * P for q in qs)))


def ssd_flops(B, L, H, P, N, chunk, groups=None) -> float:
    return sum(ssd_product_flops(B, L, H, P, N, chunk, groups).values())


def ssd_bwd_product_flops(B, L, H, P, N, chunk=64, groups=None) -> Dict[str, float]:
    """FLOPs of each product of an ssd_scan backward: per chunk the causal
    entries of C.B^T (2N) once per group, and per head those of G = dy.x^T
    (2P), of W dy (2P), of (G o L) with C and with B (2N each); per token and
    head five state terms (2NP each), one of them the recomputed forward
    chunk state."""
    G = groups or H
    Q = min(chunk, L)
    qs = [min(Q, L - c) for c in range(0, L, Q)]
    tri = sum(q * (q + 1) for q in qs)
    return dict(cb=float(B * G * tri * N), g=float(B * H * tri * P), wdy=float(B * H * tri * P),
                dbdc=float(2 * B * H * tri * N), state=float(5 * B * H * L * 2 * N * P))


def ssd_bwd_flops(B, L, H, P, N, chunk=64, groups=None) -> float:
    return sum(ssd_bwd_product_flops(B, L, H, P, N, chunk, groups).values())


def ssd_bytes(B, L, H, P, N, G, itemsize, backward=False) -> float:
    """Forward: x read and y written, B and C read (``itemsize`` each), dt,
    a, D and the final state in f32.  Backward: x, dy read and dx written, B
    and C read and dB, dC written, dt read and ddt written, a, D, da, dD."""
    x = B * L * H * P
    bc = B * L * G * N
    if backward:
        return (3.0 * x + 4.0 * bc) * itemsize + 4.0 * (2 * B * L * H + 4 * H)
    return (2.0 * x + 2.0 * bc) * itemsize + 4.0 * (B * L * H + 2 * H + B * H * N * P)


def peak_unit(dtype: str) -> str:
    """The tensor-core peak that prices a kernel's FLOPs: bf16 inputs at the
    bf16 rate, f32 inputs at the tf32 rate (no route in f32 can beat it)."""
    return "bfloat16" if dtype in ("bfloat16", "float16") else "tf32"


def ssd_bound_s(B, L, H, P, N, G, chunk, dtype, backward=False) -> float:
    itemsize = 2 if dtype in ("bfloat16", "float16") else 4
    flops = ssd_bwd_flops(B, L, H, P, N, 64, G) if backward else ssd_flops(B, L, H, P, N,
                                                                             chunk, G)
    return bound_s(flops, ssd_bytes(B, L, H, P, N, G, itemsize, backward), peak_unit(dtype))

