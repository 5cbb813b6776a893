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


def decode_attention_split_model(
    q: torch.Tensor,  # (B, Hq, D)
    k_cache: torch.Tensor,  # (B, S, Hkv, D)
    v_cache: torch.Tensor,  # (B, S, Hkv, D)
    lengths: torch.Tensor,  # (B,) int32
    window: int = 0,
    num_splits: int = 1,
) -> torch.Tensor:
    """A plain model of ``csrc/decode_attention.cu``'s algorithm, for the CPU
    tests (nothing on the card calls it): each split takes its share of the
    visible keys (``ops.split_range``) in 64-key tiles; within a tile, warp w
    of 4 takes keys 16 w .. 16 w + 15 and keeps its own online-softmax
    state; the block merges the warps in warp order, and the splits are
    merged in split order.  In f32, as the CUDA-core route computes."""
    from .ops import TILE, split_range

    warps, warp_keys, neg = 4, TILE // 4, -1e30
    B, Hq, D = q.shape
    _, S, Hkv, _ = k_cache.shape
    G = Hq // Hkv
    qf = (q.float() * (1.0 / math.sqrt(D))).to(q.dtype).float().reshape(B, Hkv, G, D)
    out = torch.empty((B, Hkv, G, D), dtype=torch.float32)
    for b in range(B):
        kb, vb = k_cache[b].float().transpose(0, 1), v_cache[b].float().transpose(0, 1)
        parts = []  # per split: (acc (Hkv, G, D), m (Hkv, G), l (Hkv, G))
        for sp in range(num_splits):
            k0, k1 = split_range(int(lengths[b]), S, window, num_splits, sp)
            m = torch.full((warps, Hkv, G), neg)
            l = torch.zeros((warps, Hkv, G))
            acc = torch.zeros((warps, Hkv, G, D))
            for t0 in range(k0, k1, TILE):
                for w in range(warps):
                    lo, hi = t0 + w * warp_keys, min(t0 + (w + 1) * warp_keys, k1)
                    if lo >= hi:
                        continue
                    s = torch.einsum("hgd,hkd->hgk", qf[b], kb[:, lo:hi])
                    m_new = torch.maximum(m[w], s.amax(-1))
                    alpha = torch.exp(m[w] - m_new)
                    p = torch.exp(s - m_new[..., None])
                    l[w] = l[w] * alpha + p.sum(-1)
                    acc[w] = acc[w] * alpha[..., None] + torch.einsum("hgk,hkd->hgd", p,
                                                                      vb[:, lo:hi])
                    m[w] = m_new
            mx = m.amax(0)
            f = torch.exp(m - mx)
            parts.append(((acc * f[..., None]).sum(0), mx, (l * f).sum(0)))
        mg = torch.stack([p[1] for p in parts]).amax(0)
        o = torch.zeros((Hkv, G, D))
        lt = torch.zeros((Hkv, G))
        for acc_s, m_s, l_s in parts:
            f = torch.exp(m_s - mg)
            o = o + acc_s * f[..., None]
            lt = lt + l_s * f
        out[b] = o / torch.clamp(lt, min=1e-30)[..., None]
    return out.reshape(B, Hq, D).to(q.dtype)
