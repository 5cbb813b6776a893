"""Public wrapper of the flash-attention kernel.

On a CUDA tensor it launches the hand-written Hopper kernel
(``csrc/flash_attention.cu``) or raises; on a CPU tensor it computes the
plain version ``flash_attention_ref``.  ``flash_attention.launches`` counts
kernel launches.
"""
from __future__ import annotations

import torch

from .kernel import BLOCKS_K, BLOCKS_Q, DTYPES, HEAD_DIMS, flash_attention_fwd
from .ref import flash_attention_ref


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, block_q: int, block_k: int) -> None:
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
    if block_q not in BLOCKS_Q or block_k not in BLOCKS_K:
        raise ValueError(f"flash_attention: block_q in {BLOCKS_Q}, block_k in {BLOCKS_K}; "
                         f"got {block_q}, {block_k}")
    if q.dtype == torch.float32 and D == 128 and (block_q, block_k) == (128, 64):
        # the one tile whose shared memory (230 KiB) is over sm_90's 227 KiB
        raise ValueError("flash_attention: f32 with D=128 takes block_q=64 or block_k=32")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"flash_attention: {name} must be contiguous and 16-byte aligned")


def flash_attention(
    q: torch.Tensor,  # (B, Sq, Hq, D)
    k: torch.Tensor,  # (B, Sk, Hkv, D)
    v: torch.Tensor,  # (B, Sk, Hkv, D)
    causal: bool = True,
    window: int = 0,
    softcap: float = 0.0,
    q_offset: int = 0,
    block_q: int = 64,
    block_k: int = 64,
) -> torch.Tensor:
    """Blocked GQA attention with an online softmax; output in q's dtype.

    ``block_q``/``block_k`` pick the kernel's tile (the result does not
    depend on them beyond rounding); the plain version ignores them.
    """
    if q.device.type == "cpu":
        if k.device.type != "cpu" or v.device.type != "cpu":
            raise ValueError("flash_attention: q on the CPU but k or v elsewhere")
        return flash_attention_ref(q, k, v, causal=causal, window=window,
                                   softcap=softcap, q_offset=q_offset)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: no kernel for device {q.device}")
    _check(q, k, v, block_q, block_k)
    o = torch.empty_like(q)
    flash_attention_fwd(q, k, v, o, causal=causal, window=window, softcap=softcap,
                        q_offset=q_offset, block_q=block_q, block_k=block_k)
    flash_attention.launches += 1
    return o


flash_attention.launches = 0
