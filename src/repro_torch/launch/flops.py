"""The FLOPs and bytes each kernel op is charged: one copy, read by the
dry run (importing this module registers each shape-only op of
``kernels._shape`` with ``FlopCounterMode`` under its formula) and by
``chip_smoke.py``'s bounds.

Every count is the least work the function needs on the call's data: the
attention counts cover the visible (query, key) pairs only, the SSD counts
the causal half of each chunk's products.  ``bound`` turns FLOPs and bytes
into the least time one H100 could take.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import numpy as np
import torch
from torch.utils.flop_counter import register_flop_formula

from ..kernels import _shape  # noqa: F401  (defines the ops charged below)

# Published peaks of one H100 SXM (dense): bf16 tensor cores, tf32 tensor
# cores, f32 outside the tensor cores, and HBM bandwidth.
PEAK_FLOPS = {"bfloat16": 989e12, "tf32": 495e12, "float32": 67e12}
HBM_BYTES_PER_S = 3.35e12


def bound(flops: float, nbytes: float, dtype: str) -> Tuple[float, str]:
    """(ms, "operations" or "bytes"): the larger of ``flops`` at the peak
    rate of ``dtype`` and ``nbytes`` at the HBM rate."""
    t_ops = flops / PEAK_FLOPS[dtype]
    t_mem = nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_mem) * 1e3, ("operations" if t_ops >= t_mem else "bytes")


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------
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


def decode_flops(Hq: int, D: int, visible: int) -> float:
    """A decode call over ``visible`` cache rows in all (summed over the
    sequences): q.k and p.v, 4 D a (query head, visible row)."""
    return 4.0 * Hq * D * visible


def decode_bytes(visible: int, B: int, Hq: int, Hkv: int, D: int, itemsize: int) -> float:
    """The visible K and V rows read once, q read and the output written
    once, and the (B,) int32 lengths."""
    return (2.0 * visible * Hkv * D + 2.0 * B * Hq * D) * itemsize + 4.0 * B


def decode_visible(B: int, S: int, window: int) -> int:
    """Visible rows of a decode call over full caches of S rows, the most a
    call over an S-row cache can read: S a sequence, or the window."""
    return B * (min(S, window) if window > 0 else S)


# ---------------------------------------------------------------------------
# SSD scan
# ---------------------------------------------------------------------------
def ssd_product_flops(B, L, H, P, N, chunk, groups=None) -> Dict[str, float]:
    """FLOPs of each product of an ssd_scan call: per chunk of q tokens, the
    q(q+1)/2 causal entries of C.B^T (2N each) once per group (the heads of
    a group share it), and per head those of W x (2P each, W[i, j] = 0 for
    j > i), C h and the state update (2qNP each); the ragged last chunk
    counts its own q.  ``groups`` None: pre-expanded, one group a head."""
    G = groups or H
    Q = min(chunk, L)
    qs = [min(Q, L - c) for c in range(0, L, Q)]
    return dict(cb=float(B * G * sum(q * (q + 1) * N for q in qs)),
                wx=float(B * H * sum(q * (q + 1) * P for q in qs)),
                ch=float(B * H * sum(2 * q * N * P for q in qs)),
                state=float(B * H * sum(2 * q * N * P for q in qs)))


def ssd_flops(B, L, H, P, N, chunk, groups=None) -> float:
    """The least FLOPs of an ssd_scan call (``ssd_product_flops``, summed)."""
    return sum(ssd_product_flops(B, L, H, P, N, chunk, groups).values())


def ssd_bwd_product_flops(B, L, H, P, N, chunk=64, groups=None) -> Dict[str, float]:
    """FLOPs of each product of an ssd_scan backward, the least the function
    needs: per chunk of q tokens the q(q+1)/2 causal entries of C.B^T (2N
    each) once per group, and per head those of G = dy.x^T (2P), of W dy for
    dx (2P), and of (G o L) with C and with B for dB and dC (2N each); per
    token and head the state terms R^T B, R x, h dy, the backward chunk state
    and the recomputed forward chunk state (2NP each).  ``groups`` None: one
    group a head."""
    G = groups or H
    Q = min(chunk, L)
    qs = [min(Q, L - c) for c in range(0, L, Q)]
    tri = sum(q * (q + 1) for q in qs)
    return dict(cb=float(B * G * tri * N), g=float(B * H * tri * P), wdy=float(B * H * tri * P),
                dbdc=float(2 * B * H * tri * N), state=float(5 * B * H * L * 2 * N * P))


def ssd_bwd_flops(B, L, H, P, N, chunk=64, groups=None) -> float:
    return sum(ssd_bwd_product_flops(B, L, H, P, N, chunk, groups).values())


# ---------------------------------------------------------------------------
# causal conv (the mamba2 mixer's depthwise conv, bias and SiLU)
# ---------------------------------------------------------------------------
def conv_flops(T: int, Ch: int, K: int = 4) -> float:
    """A depthwise causal conv of width K over T tokens of Ch channels: a
    multiply and an add a tap (2 K T Ch; the bias and SiLU not counted)."""
    return 2.0 * K * T * Ch


def conv_bwd_flops(T: int, Ch: int, K: int = 4) -> float:
    """Its backward: the input's gradient and the weights', 2 K T Ch each."""
    return 4.0 * K * T * Ch


def conv_bytes(T: int, Ch: int, x_item: int, out_item: int, backward: bool = False) -> float:
    """Forward: x read and the three outputs written once (T Ch values each).
    Backward: x and the outputs' gradients read, dx written.  The weights and
    the backward's partials (under 3% at the mixer's shapes) not counted."""
    n = float(T * Ch)
    return n * (2 * x_item + out_item) if backward else n * (x_item + out_item)


# ---------------------------------------------------------------------------
# RMSNorm (plain, and the mamba2 mixer's norm gated by SiLU)
# ---------------------------------------------------------------------------
def norm_flops(T: int, D: int, gated: bool = False) -> float:
    """RMSNorm of T rows of D: a square and a sum, then two scalings, a value
    (4 T D); the gate adds its SiLU (an exp, an add and a divide) and the
    product (4 T D)."""
    return (8.0 if gated else 4.0) * T * D


def norm_bwd_flops(T: int, D: int, gated: bool = False) -> float:
    """Its backward: dout w, the row's sum of dn p, the scale's partial sums
    and dp = r dn - p c, 9 a value; the gate adds its recomputation (4), dy
    (1) and dz with SiLU's derivative (4)."""
    return (18.0 if gated else 9.0) * T * D


def norm_bytes(T: int, D: int, x_item: int, out_item: int, z_item: int = 0,
               backward: bool = False) -> float:
    """Forward: x (and the gate, ``z_item`` > 0) read once, the output
    written once, each row's f32 rstd written.  Backward: x, the gate and the
    output's gradient read, dx (and dz) written, rstd read.  The scale and
    the backward's partials (under 5% at the models' shapes) not counted."""
    n = float(T * D)
    if backward:
        return n * (2 * x_item + 2 * z_item + out_item) + 4.0 * T
    return n * (x_item + z_item + out_item) + 4.0 * T


# ---------------------------------------------------------------------------
# AdamW update (one leaf, in place)
# ---------------------------------------------------------------------------
def adamw_flops(n: int, decay: bool = True) -> float:
    """One AdamW step of n elements: the scale (1), the first moment (3), the
    second (4), the two bias corrections, the root, eps and the quotient (5),
    the step (2), 15 a value; the decay adds its product and sum (2)."""
    return (17.0 if decay else 15.0) * n


def adamw_bytes(n: int, p_item: int, g_item: int, state_item: int) -> float:
    """p, m and v read and written once, g read once."""
    return float(n) * (2 * p_item + g_item + 4 * state_item)


# ---------------------------------------------------------------------------
# MoE router
# ---------------------------------------------------------------------------
def router_flops(T: int, E: int, k: int) -> float:
    """softmax (max, exp, sum, divide) and k rounds of compare-select, per
    logit."""
    return float(T * E * (4 + 2 * k))


def router_bwd_flops(T: int, k: int) -> float:
    """The gates' backward: 4 operations a (token, choice)."""
    return float(T * k * 4)


def router_bytes(T: int, E: int, k: int) -> float:
    """(T, E) f32 logits (or their gradient) and three (T, k) 4-byte
    tensors, each moved once; the same for the backward."""
    return 4.0 * (T * E + 3 * T * k)


# ---------------------------------------------------------------------------
# augment
# ---------------------------------------------------------------------------
def augment_flops(B: int, oh: int, ow: int, C: int) -> float:
    """One FMA per output value."""
    return 2.0 * (B * oh * ow * C)


def augment_bytes(B: int, oh: int, ow: int, C: int) -> float:
    """The crop windows read once (uint8) and the output written once (f32),
    plus corners, flags, mean and std."""
    n = B * oh * ow * C
    return 5.0 * n + 12.0 * B + 8.0 * C


def augment_bound(B: int, oh: int, ow: int, C: int) -> Tuple[float, str]:
    return bound(augment_flops(B, oh, ow, C), augment_bytes(B, oh, ow, C), "float32")



# ---------------------------------------------------------------------------
# each shape-only op of kernels._shape, charged its formula by FlopCounterMode;
# decode's reads every row of a full cache (the window's with a window), the
# most a call can read: ``lengths`` is not on a meta tensor
# ---------------------------------------------------------------------------
_ops = torch.ops.repro_torch


@register_flop_formula(_ops.flash_attention_fwd)
def _(q, k, v, causal, window, q_offset, with_lse, *args, out_shape=None, **kwargs):
    B, Sq, Hq, D = q
    return int(flash_flops(B, Sq, k[1], Hq, D, causal, window, q_offset))


@register_flop_formula(_ops.flash_attention_bwd)
def _(q, k, v, o, lse, do, causal, window, q_offset, *args, out_shape=None, **kwargs):
    B, Sq, Hq, D = q
    return int(flash_flops(B, Sq, k[1], Hq, D, causal, window, q_offset, backward=True))


@register_flop_formula(_ops.decode_attention)
def _(q, k_cache, v_cache, lengths, window, num_splits, *args, out_shape=None, **kwargs):
    B, Hq, D = q
    return int(decode_flops(Hq, D, decode_visible(B, k_cache[1], window)))


@register_flop_formula(_ops.ssd_scan)
def _(x, dt, a, Bm, Cm, D, chunk, *args, out_shape=None, **kwargs):
    Bsz, L, H, P = x
    return int(ssd_flops(Bsz, L, H, P, Bm[3], chunk, Bm[2]))


@register_flop_formula(_ops.ssd_scan_bwd)
def _(x, dt, a, Bm, Cm, D, dy, dh_final, *args, out_shape=None, **kwargs):
    Bsz, L, H, P = x
    return int(ssd_bwd_flops(Bsz, L, H, P, Bm[3], groups=Bm[2]))


@register_flop_formula(_ops.causal_conv)
def _(xbc, w, b, d_inner, *args, out_shape=None, **kwargs):
    Bsz, L, Ch = xbc
    return int(conv_flops(Bsz * L, Ch, w[0]))


@register_flop_formula(_ops.causal_conv_bwd)
def _(xbc, w, b, dxs, dB, dC, *args, out_shape=None, **kwargs):
    Bsz, L, Ch = xbc
    return int(conv_bwd_flops(Bsz * L, Ch, w[0]))


@register_flop_formula(_ops.rms_norm)
def _(x, w, gate, eps, *args, out_shape=None, **kwargs):
    return int(norm_flops(math.prod(x[:-1]), x[-1], gated=gate is not None))


@register_flop_formula(_ops.rms_norm_bwd)
def _(x, w, rstd, dout, gate, *args, out_shape=None, **kwargs):
    return int(norm_bwd_flops(math.prod(x[:-1]), x[-1], gated=gate is not None))


@register_flop_formula(_ops.adamw_update)
def _(p, g, m, v, scale, lr, b1, b2, eps, c1, c2, weight_decay, *args, out_shape=None,
      **kwargs):
    return int(adamw_flops(math.prod(p), decay=weight_decay != 0))


@register_flop_formula(_ops.moe_router)
def _(logits, k, *args, out_shape=None, **kwargs):
    T, E = logits
    return int(router_flops(T, E, k))


@register_flop_formula(_ops.moe_router_bwd)
def _(ids, gates, dgates, E, *args, out_shape=None, **kwargs):
    T, k = ids
    return int(router_bwd_flops(T, k))


@register_flop_formula(_ops.fused_augment)
def _(images, crops, flips, mean, std, out_h, out_w, *args, out_shape=None, **kwargs):
    B, _, _, C = images
    return int(augment_flops(B, out_h, out_w, C))
