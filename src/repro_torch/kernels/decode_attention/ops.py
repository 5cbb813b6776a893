"""Public wrapper of the split-K decode-attention kernel.

On a CUDA tensor it launches the hand-written Hopper kernel
(``csrc/decode_attention.cu``) or raises; on a CPU tensor it computes the
plain version ``decode_attention_ref``.  ``decode_attention.launches`` counts
kernel launches (phase 1 and its merge count as one).
"""
from __future__ import annotations

import torch

from .._grad import refuse_grad
from .kernel import DTYPES, HEAD_DIMS, MAX_GROUP, decode_attention_fwd
from .ref import decode_attention_ref


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def split_plan(S: int, num_splits: int, block_s: int):
    """(num_splits, seg): the TPU kernel's split of S cache rows into
    segments of ``seg`` rows, a multiple of ``block_s`` (capped at seg)."""
    num_splits = max(1, min(num_splits, _cdiv(S, block_s)))
    seg = _cdiv(S, num_splits)
    block_s = min(block_s, seg)
    return num_splits, _cdiv(seg, block_s) * block_s


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


def decode_attention(
    q: torch.Tensor,  # (B, Hq, D)
    k_cache: torch.Tensor,  # (B, S, Hkv, D)
    v_cache: torch.Tensor,  # (B, S, Hkv, D)
    lengths: torch.Tensor,  # (B,) int32 valid lengths
    window: int = 0,
    num_splits: int = 8,
    block_s: int = 256,
) -> torch.Tensor:
    """Attention of one new token per sequence over ``lengths[b]`` cache rows
    (the last ``window`` of them when ``window`` > 0); output in q's dtype.

    ``num_splits``/``block_s`` set the split-K plan as in the TPU kernel
    (``split_plan``); the CUDA kernel streams each segment in 64-row tiles.
    The plain version ignores them.
    """
    if q.device.type == "cpu":
        if k_cache.device.type != "cpu" or v_cache.device.type != "cpu":
            raise ValueError("decode_attention: q on the CPU but a cache elsewhere")
        return decode_attention_ref(q, k_cache, v_cache, lengths, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention: no kernel for device {q.device}")
    refuse_grad("decode_attention", q, k_cache, v_cache)
    _check(q, k_cache, v_cache, lengths)
    ns, seg = split_plan(k_cache.shape[1], num_splits, block_s)
    out = torch.empty_like(q)
    decode_attention_fwd(q, k_cache, v_cache, lengths, out, num_splits=ns, seg=seg,
                         window=window)
    decode_attention.launches += 1
    return out


decode_attention.launches = 0
