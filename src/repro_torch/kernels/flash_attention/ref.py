"""Plain PyTorch version of blocked GQA flash attention (materialises the
scores).  Twin of ``repro/kernels/flash_attention/ref.py``: every product in
f32, the softmax over the full key axis at once."""
from __future__ import annotations

import math

import torch


def flash_attention_ref(
    q: torch.Tensor,  # (B, Sq, Hq, D)
    k: torch.Tensor,  # (B, Sk, Hkv, D)
    v: torch.Tensor,  # (B, Sk, Hkv, D)
    causal: bool = True,
    window: int = 0,
    softcap: float = 0.0,
    q_offset: int = 0,
) -> torch.Tensor:
    B, Sq, Hq, D = q.shape
    _, Sk, Hkv, _ = k.shape
    G = Hq // Hkv
    scale = 1.0 / math.sqrt(D)
    qf = q.float().reshape(B, Sq, Hkv, G, D) * scale
    s = torch.einsum("bqhgd,bkhd->bqhgk", qf, k.float())
    if softcap > 0.0:
        s = softcap * torch.tanh(s / softcap)
    q_pos = q_offset + torch.arange(Sq, device=q.device)
    kv_pos = torch.arange(Sk, device=q.device)
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kv_pos[None, :] <= q_pos[:, None]
    if window > 0:
        mask &= kv_pos[None, :] > q_pos[:, None] - window
    m5 = mask[None, :, None, None, :]
    s = torch.where(m5, s, -torch.inf)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = torch.where(m5, p, 0.0)
    p = p / torch.clamp(p.sum(dim=-1, keepdim=True), min=1e-30)
    out = torch.einsum("bqhgk,bkhd->bqhgd", p, v.float())
    return out.reshape(B, Sq, Hq, D).to(q.dtype)
