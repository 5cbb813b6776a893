"""Plain PyTorch version of single-token decode attention over a KV cache.
Twin of ``repro/kernels/decode_attention/ref.py``."""
from __future__ import annotations

import math

import torch


def decode_attention_ref(
    q: torch.Tensor,  # (B, Hq, D) - one new token per sequence
    k_cache: torch.Tensor,  # (B, S, Hkv, D)
    v_cache: torch.Tensor,  # (B, S, Hkv, D)
    lengths: torch.Tensor,  # (B,) int32 - valid cache length per sequence
    window: int = 0,
) -> torch.Tensor:
    B, Hq, D = q.shape
    _, S, Hkv, _ = k_cache.shape
    G = Hq // Hkv
    scale = 1.0 / math.sqrt(D)
    qf = q.float().reshape(B, Hkv, G, D) * scale
    s = torch.einsum("bhgd,bkhd->bhgk", qf, k_cache.float())
    kv_pos = torch.arange(S, device=q.device)
    lengths = lengths.to(q.device)
    mask = kv_pos[None, :] < lengths[:, None]  # (B, S)
    if window > 0:
        mask &= kv_pos[None, :] > lengths[:, None] - 1 - window
    m4 = mask[:, None, None, :]
    s = torch.where(m4, s, -torch.inf)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = torch.where(m4, p, 0.0)
    p = p / torch.clamp(p.sum(dim=-1, keepdim=True), min=1e-30)
    out = torch.einsum("bhgk,bkhd->bhgd", p, v_cache.float())
    return out.reshape(B, Hq, D).to(q.dtype)
