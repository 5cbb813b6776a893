"""Frozen FLOP and byte formulas of the port's flash-attention kernels.

``visible_pairs`` and ``flash_flops`` are copies of
``repro_torch/launch/flops.py``'s as they stood when the flash metrics were
defined (``portbench/tests/test_portbench_flash.py`` holds them equal at
the cell's shape); the bytes are the benchmark's own.  The peaks and
``bound_s`` are ``bench/flops.py``'s.  The program may change its own copy;
the yardstick does not move with it.
"""
from __future__ import annotations

import numpy as np

from portbench.bench.flops import bound_s, peak_unit


def visible_pairs(Sq: int, Sk: int, causal: bool, window: int, q_offset: int = 0) -> int:
    """(query, key) pairs a query block of Sq rows at ``q_offset`` attends
    to over Sk keys under the causal mask and the window."""
    qp = q_offset + np.arange(Sq)
    hi = np.minimum(qp + 1, Sk) if causal else np.full(Sq, Sk)
    lo = np.maximum(qp - window + 1, 0) if window > 0 else np.zeros(Sq, dtype=np.int64)
    return int(np.clip(hi - lo, 0, None).sum())


def flash_flops(B, Sq, Sk, Hq, D, causal=True, window=0, q_offset=0, backward=False) -> float:
    """The least FLOPs of a flash call on this run's masks: 4 D a visible
    pair (Q K^T and P V) forward; 2.5x that backward (Q K^T, dO V^T, P^T dO,
    dS^T Q, dS K)."""
    fwd = 4.0 * B * Hq * D * visible_pairs(Sq, Sk, causal, window, q_offset)
    return 2.5 * fwd if backward else fwd


def flash_bytes(B, Sq, Sk, Hq, Hkv, D, itemsize, backward=False) -> float:
    """Each input read once and each output written once.  Forward: q, k,
    v read, the output written (``itemsize`` each), the rows' f32
    log-sum-exp written.  Backward: q, k, v, the output and its gradient
    read, dq, dk, dv written, the log-sum-exp read."""
    q = B * Sq * Hq * D
    kv = B * Sk * Hkv * D
    lse = 4.0 * B * Hq * Sq
    if backward:
        return (4.0 * q + 4.0 * kv) * itemsize + lse
    return (2.0 * q + 2.0 * kv) * itemsize + lse


def flash_bound_s(B, S, Hq, Hkv, D, window, dtype, backward=False) -> float:
    """The least seconds one H100 could take for one causal self-attention
    call of S positions: its FLOPs at the tensor-core peak of ``dtype`` or
    its bytes at the HBM rate, the larger."""
    itemsize = 2 if dtype in ("bfloat16", "float16") else 4
    return bound_s(flash_flops(B, S, S, Hq, D, True, window, backward=backward),
                   flash_bytes(B, S, S, Hq, Hkv, D, itemsize, backward), peak_unit(dtype))
