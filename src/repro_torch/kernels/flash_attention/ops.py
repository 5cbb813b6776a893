"""Public wrappers of the flash-attention kernels; which one serves a call is
the route rule's (``kernels._route``).

``flash_attention``: ``csrc/flash_attention.cu`` (the wgmma/TMA kernel for
bf16, the scalar kernel for f32), plain version ``flash_attention_ref``,
under autograd ``FlashAttention``, whose forward also keeps the rows'
log-sum-exp and whose backward is ``flash_attention_bwd``.  On a mesh the
batch splits over the data axes, the heads over the model axis, and each
rank takes its kv heads when only the q heads split.

``flash_attention_bwd``: ``csrc/flash_attention_bwd.cu``, plain version
``flash_attention_bwd_ref`` (the same math, in f32).

``.launches`` counts kernel launches (the backward's kernels, three for f32
and four for bf16, count as one launch).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from .. import _boundary, _route, _shape
from .kernel import DTYPES, HEAD_DIMS, TILES, flash_attention_bwd_launch
from .kernel import flash_attention_fwd as _launch_fwd
from .ref import flash_attention_bwd_ref, flash_attention_ref


def resolve_tile(dtype: torch.dtype, head_dim: int, block_q: Optional[int] = None,
                 block_k: Optional[int] = None) -> Tuple[int, int]:
    """The forward's (block_q, block_k) for ``dtype``: the dtype's default
    tile where both are None (the fast one), else the pair asked for, which
    must be one of ``TILES[dtype]``."""
    if dtype not in TILES:
        raise TypeError(f"flash_attention: no kernel for {dtype}; want one of {list(TILES)}")
    if block_q is None and block_k is None:
        return TILES[dtype][0]
    default_q, default_k = TILES[dtype][0]
    tile = (default_q if block_q is None else block_q, default_k if block_k is None else block_k)
    if tile not in TILES[dtype]:
        raise ValueError(f"flash_attention: {dtype} takes (block_q, block_k) in "
                         f"{list(TILES[dtype])}; got {tile}")
    if dtype == torch.float32 and head_dim == 128 and tile == (128, 64):
        # the one tile whose shared memory (230 KiB) is over sm_90's 227 KiB
        raise ValueError("flash_attention: f32 with D=128 takes block_q=64 or block_k=32")
    return tile


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"flash_attention: want q (B,Sq,Hq,D), k = v (B,Sk,Hkv,D); "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, _, Hq, D = q.shape
    if k.shape[0] != B or k.shape[3] != D or Hq % k.shape[2]:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} and k {tuple(k.shape)} "
                         "disagree on batch or head dim, or Hq % Hkv != 0")
    if not (q.device == k.device == v.device):
        raise ValueError(f"flash_attention: tensors on {q.device}, {k.device}, {v.device}")
    if q.dtype not in DTYPES or not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"flash_attention: want one of {list(DTYPES)} for q, k, v; "
                        f"got {q.dtype}, {k.dtype}, {v.dtype}")
    if D not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {D} not in {HEAD_DIMS}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"flash_attention: {name} must be contiguous and 16-byte aligned")


def _forward(q, k, v, causal, window, softcap, q_offset, block_q, block_k,
             with_lse: bool) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    _check(q, k, v)
    block_q, block_k = resolve_tile(q.dtype, q.shape[3], block_q, block_k)

    def shape():
        o, lse = _shape.flash_attention_fwd(q, k, v, causal, window, q_offset, with_lse)
        return o, (lse if with_lse else None)

    def launch():
        o = torch.empty_like(q)
        lse = None
        if with_lse:
            B, Sq, Hq, _ = q.shape
            lse = torch.empty((B, Hq, Sq), dtype=torch.float32, device=q.device)
        _launch_fwd(q, k, v, o, lse, causal=causal, window=window, softcap=softcap,
                    q_offset=q_offset, block_q=block_q, block_k=block_k)
        return o, lse

    return _route.device(flash_attention, q, shape, launch)


class FlashAttention(torch.autograd.Function):
    """The CUDA kernels under autograd: the forward saves q, k, v, the
    output and the log-sum-exp; the backward launches ``flash_attention_bwd``."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, softcap, q_offset, block_q, block_k):
        o, lse = _forward(q, k, v, causal, window, softcap, q_offset, block_q, block_k, True)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.attn = (causal, window, softcap, q_offset)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        causal, window, softcap, q_offset = ctx.attn
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do.contiguous(), causal=causal,
                                         window=window, softcap=softcap, q_offset=q_offset)
        return dq, dk, dv, None, None, None, None, None, None


def flash_attention(
    q: torch.Tensor,  # (B, Sq, Hq, D)
    k: torch.Tensor,  # (B, Sk, Hkv, D)
    v: torch.Tensor,  # (B, Sk, Hkv, D)
    causal: bool = True,
    window: int = 0,
    softcap: float = 0.0,
    q_offset: int = 0,
    block_q: Optional[int] = None,
    block_k: Optional[int] = None,
) -> torch.Tensor:
    """Blocked GQA attention with an online softmax; output in q's dtype.

    ``block_q``/``block_k`` pick the forward kernel's tile, one of
    ``TILES[dtype]``; None takes the dtype's default (``resolve_tile``).
    The result does not depend on the tile beyond rounding; the plain
    version ignores it.  ``DTensor``s are taken local (``_boundary``).
    """
    return _route.call(
        flash_attention, q, (k, v), mixed="q on the CPU but k or v elsewhere",
        boundary=lambda: _boundary.grouped_heads(
            flash_attention, q, (k, v), 2, 2, causal=causal, window=window, softcap=softcap,
            q_offset=q_offset, block_q=block_q, block_k=block_k),
        plain=lambda: flash_attention_ref(q, k, v, causal=causal, window=window,
                                          softcap=softcap, q_offset=q_offset),
        function=lambda: FlashAttention.apply(q, k, v, causal, window, softcap, q_offset,
                                              block_q, block_k),
        device=lambda: _forward(q, k, v, causal, window, softcap, q_offset, block_q, block_k,
                                False)[0])


def flash_attention_with_lse(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = True, window: int = 0,
    softcap: float = 0.0, q_offset: int = 0, block_q: Optional[int] = None,
    block_k: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The forward kernel's (output, log-sum-exp (B, Hq, Sq) f32), the pair
    that ``flash_attention_bwd`` takes; CUDA tensors only."""
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_with_lse: no kernel for device {q.device}")
    return _forward(q, k, v, causal, window, softcap, q_offset, block_q, block_k, True)


def _backward(q, k, v, o, lse, do, causal, window, softcap, q_offset):
    _check(q, k, v)
    B, Sq, Hq, _ = q.shape
    for name, t in (("o", o), ("do", do)):
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"flash_attention_bwd: {name} must match q; got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"flash_attention_bwd: {name} must be contiguous and 16-byte aligned")
    if (lse.dtype != torch.float32 or tuple(lse.shape) != (B, Hq, Sq) or lse.device != q.device
            or not lse.is_contiguous()):
        raise ValueError(f"flash_attention_bwd: lse must be contiguous float32 ({B}, {Hq}, {Sq}); "
                         f"got {lse.dtype} {tuple(lse.shape)}")

    def launch():
        dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
        flash_attention_bwd_launch(q, k, v, o, lse, do, dq, dk, dv, causal=causal,
                                   window=window, softcap=softcap, q_offset=q_offset)
        return dq, dk, dv

    return _route.device(
        flash_attention_bwd, q,
        lambda: _shape.flash_attention_bwd(q, k, v, o, lse, do, causal, window, q_offset), launch)


def flash_attention_bwd(
    q: torch.Tensor,  # (B, Sq, Hq, D)
    k: torch.Tensor,  # (B, Sk, Hkv, D)
    v: torch.Tensor,  # (B, Sk, Hkv, D)
    o: torch.Tensor,  # (B, Sq, Hq, D), the forward's output
    lse: torch.Tensor,  # (B, Hq, Sq) f32, the forward's log-sum-exp
    do: torch.Tensor,  # (B, Sq, Hq, D), the gradient of the output
    causal: bool = True,
    window: int = 0,
    softcap: float = 0.0,
    q_offset: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of ``flash_attention``, in the inputs' dtype; dk and dv
    are summed over each GQA group."""
    return _route.call(
        flash_attention_bwd, q, (k, v, o, lse, do),
        mixed="q on the CPU but another input elsewhere",
        plain=lambda: flash_attention_bwd_ref(q, k, v, o, lse, do, causal=causal, window=window,
                                              softcap=softcap, q_offset=q_offset),
        device=lambda: _backward(q, k, v, o, lse, do, causal, window, softcap, q_offset))
