"""Public wrapper of the split-K decode-attention kernel
(``csrc/decode_attention.cu``, plain version ``decode_attention_ref``; the
route: ``kernels._route``).  On a mesh the batch splits over the data axes,
the kv heads over the model axis, or each rank takes its kv head.  It has no
backward: on its device route it raises when a gradient would pass (``_grad``).
``decode_attention.launches`` counts calls that launched the kernel (one per
call, with the split merge's launch when there is more than one split).

The split plan: the kernel splits each (sequence, kv head, row block)'s
visible keys on the card into ``num_splits`` equal shares of 64-key tiles
(``split_range``).  By default the host picks ``num_splits`` from the cache
capacity S, the number of row-block units and the card's SM count
(``split_count``), so it never reads ``lengths``.
"""
from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch

from .. import _boundary, _route, _shape
from .._grad import refuse_grad
from .kernel import DTYPES, HEAD_DIMS, MAX_GROUP, decode_attention_fwd
from .ref import decode_attention_ref

TILE = 64  # keys per tile of the kernel
# The default plan's constants, from chip_smoke.py's split sweep (device time
# per call at 1-128 splits; NVIDIA H100 80GB HBM3, 700 W): about 8 blocks per
# SM over the units, and at least 8 tiles (512 keys) a split of a full cache.
# They pick the fastest count measured, or one within 3% of it, at B=8,
# S=8192 (24/2 heads, window 4096: 16 splits), B=1, S=32768 (24/2: 64) and
# B=8, S=4096 (16/16: 8); past that the merge costs more than the splits save.
BLOCKS_PER_SM = 8
MIN_TILES = 8
MAX_SPLITS = 128


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def rows_per_block(dtype: torch.dtype, G: int) -> int:
    """Query heads per block: 16 on the bf16 tensor-core route (G >= 8),
    else the smallest power of two >= G, at most 8 (CUDA-core route)."""
    if dtype == torch.bfloat16 and G >= 8:
        return 16
    return min(8, 1 << (G - 1).bit_length())


def split_count(S: int, units: int, sms: int) -> int:
    """The card's plan: enough splits for about ``BLOCKS_PER_SM`` blocks per
    SM over ``units`` (sequence, kv head, row block) units, while each split
    of a full cache of S rows keeps ``MIN_TILES`` 64-key tiles (so a short
    cache takes one split and one launch), and at most ``MAX_SPLITS``."""
    return max(1, min(_cdiv(S, TILE * MIN_TILES), _cdiv(BLOCKS_PER_SM * sms, max(units, 1)),
                      MAX_SPLITS))


def split_range(length: int, S: int, window: int, num_splits: int, sp: int) -> Tuple[int, int]:
    """Keys [k0, k1) that split ``sp`` of ``num_splits`` attends to: an equal
    share of the 64-key tiles that tile the visible range [lo, hi) from lo
    (hi = min(length, S); lo = length - window with a window, else 0).  The
    twin of ``split_range`` in ``csrc/decode_attention.cu``."""
    hi = min(length, S)
    lo = max(0, length - window) if window > 0 else 0
    ntiles = _cdiv(max(hi - lo, 0), TILE)
    per = _cdiv(ntiles, num_splits)
    t0 = min(sp * per, ntiles)
    t1 = min(t0 + per, ntiles)
    k0 = lo + t0 * TILE
    return k0, (min(lo + t1 * TILE, hi) if t1 > t0 else k0)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def plan(dtype: torch.dtype, B: int, S: int, Hq: int, Hkv: int, num_splits: Optional[int],
         sms: int) -> Tuple[int, int]:
    """(query heads per block, splits) of a call: ``rows_per_block``, and
    ``num_splits`` capped at the cache's 64-key tiles and ``MAX_SPLITS``, or
    the card's plan (``split_count`` over ``sms`` SMs) when it is None."""
    rows = rows_per_block(dtype, Hq // Hkv)
    if num_splits is None:
        return rows, split_count(S, B * Hkv * _cdiv(Hq // Hkv, rows), sms)
    return rows, max(1, min(int(num_splits), _cdiv(S, TILE), MAX_SPLITS))


def _check(q, k_cache, v_cache, lengths) -> None:
    if q.dim() != 3 or k_cache.dim() != 4 or k_cache.shape != v_cache.shape:
        raise ValueError(f"decode_attention: want q (B,Hq,D), caches (B,S,Hkv,D); got "
                         f"{tuple(q.shape)}, {tuple(k_cache.shape)}, {tuple(v_cache.shape)}")
    B, Hq, D = q.shape
    Hkv = k_cache.shape[2]
    if k_cache.shape[0] != B or k_cache.shape[3] != D or Hq % Hkv:
        raise ValueError(f"decode_attention: q {tuple(q.shape)} and cache "
                         f"{tuple(k_cache.shape)} disagree, or Hq % Hkv != 0")
    if Hq // Hkv > MAX_GROUP:
        raise ValueError(f"decode_attention: {Hq // Hkv} q heads per kv head > {MAX_GROUP}")
    if D not in HEAD_DIMS:
        raise ValueError(f"decode_attention: head dim {D} not in {HEAD_DIMS}")
    if q.dtype not in DTYPES or not (q.dtype == k_cache.dtype == v_cache.dtype):
        raise TypeError(f"decode_attention: want one of {list(DTYPES)} for q and caches; "
                        f"got {q.dtype}, {k_cache.dtype}, {v_cache.dtype}")
    if lengths.dtype != torch.int32 or lengths.shape != (B,):
        raise TypeError(f"decode_attention: lengths must be int32 ({B},); got "
                        f"{lengths.dtype} {tuple(lengths.shape)}")
    if not (q.device == k_cache.device == v_cache.device == lengths.device):
        raise ValueError("decode_attention: q, caches and lengths on different devices")
    for name, t in (("q", q), ("k_cache", k_cache), ("v_cache", v_cache), ("lengths", lengths)):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"decode_attention: {name} must be contiguous and 16-byte aligned")


def _device(q, k_cache, v_cache, lengths, window, num_splits) -> torch.Tensor:
    refuse_grad("decode_attention", q, k_cache, v_cache)
    _check(q, k_cache, v_cache, lengths)

    def launch():
        B, Hq, _ = q.shape
        S, Hkv = k_cache.shape[1], k_cache.shape[2]
        rows, ns = plan(q.dtype, B, S, Hq, Hkv, num_splits, _sm_count(q.device.index or 0))
        out = torch.empty_like(q)
        decode_attention_fwd(q, k_cache, v_cache, lengths, out, rows=rows, num_splits=ns,
                             window=window)
        return out

    return _route.device(
        decode_attention, q,
        lambda: _shape.decode_attention(q, k_cache, v_cache, lengths, window,
                                        -1 if num_splits is None else int(num_splits)), launch)


def decode_attention(
    q: torch.Tensor,  # (B, Hq, D)
    k_cache: torch.Tensor,  # (B, S, Hkv, D)
    v_cache: torch.Tensor,  # (B, S, Hkv, D)
    lengths: torch.Tensor,  # (B,) int32 valid lengths
    window: int = 0,
    num_splits: Optional[int] = None,
    block_s: int = 256,
) -> torch.Tensor:
    """Attention of one new token per sequence over ``lengths[b]`` cache rows
    (the last ``window`` of them when ``window`` > 0); output in q's dtype.

    ``num_splits`` overrides the card's plan (``split_count``), capped at the
    cache's 64-key tiles and at ``MAX_SPLITS``; ``block_s`` is the TPU
    kernel's segment tile and is accepted for its API only (the CUDA
    kernel's tiles are 64 keys).  The plain version ignores both.
    ``DTensor``s are taken local (``_boundary``).
    """
    return _route.call(
        decode_attention, q, (k_cache, v_cache), mixed="q on the CPU but a cache elsewhere",
        boundary=lambda: _boundary.grouped_heads(
            decode_attention, q, (k_cache, v_cache), 1, 2, tail=(lengths,), window=window,
            num_splits=num_splits, block_s=block_s),
        plain=lambda: decode_attention_ref(q, k_cache, v_cache, lengths, window=window),
        device=lambda: _device(q, k_cache, v_cache, lengths, window, num_splits))
