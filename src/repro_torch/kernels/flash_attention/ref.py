"""Plain PyTorch versions of blocked GQA flash attention (materialise the
scores).  ``flash_attention_ref`` is the twin of
``repro/kernels/flash_attention/ref.py``: every product in f32, the softmax
over the full key axis at once.  ``flash_attention_lse_ref`` adds the rows'
log-sum-exp and ``flash_attention_bwd_ref`` is the backward with the math of
the CUDA kernel (FlashAttention-2: probabilities from the log-sum-exp and
Δ = rowsum(dO ∘ O)), in f32."""
from __future__ import annotations

import math
from typing import Tuple

import torch


def _scores(q, k, causal, window, softcap, q_offset):
    """(scores after scale and softcap with masked entries at -inf, the
    mask, tanh(s / softcap) or None), all (B, Sq, Hkv, G, Sk)."""
    B, Sq, Hq, D = q.shape
    _, Sk, Hkv, _ = k.shape
    qf = q.float().reshape(B, Sq, Hkv, Hq // Hkv, D) * (1.0 / math.sqrt(D))
    s = torch.einsum("bqhgd,bkhd->bqhgk", qf, k.float())
    t = None
    if softcap > 0.0:
        t = torch.tanh(s / softcap)
        s = softcap * t
    q_pos = q_offset + torch.arange(Sq, device=q.device)
    kv_pos = torch.arange(Sk, device=q.device)
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kv_pos[None, :] <= q_pos[:, None]
    if window > 0:
        mask &= kv_pos[None, :] > q_pos[:, None] - window
    m5 = mask[None, :, None, None, :]
    return torch.where(m5, s, -torch.inf), m5, t


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
    s, m5, _ = _scores(q, k, causal, window, softcap, q_offset)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = torch.where(m5, p, 0.0)
    p = p / torch.clamp(p.sum(dim=-1, keepdim=True), min=1e-30)
    out = torch.einsum("bqhgk,bkhd->bqhgd", p, v.float())
    return out.reshape(B, Sq, Hq, D).to(q.dtype)


def flash_attention_lse_ref(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = True, window: int = 0,
    softcap: float = 0.0, q_offset: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(output, log-sum-exp (B, Hq, Sq) f32) - the forward kernel's pair."""
    B, Sq, Hq, _ = q.shape
    s, _, _ = _scores(q, k, causal, window, softcap, q_offset)
    lse = torch.logsumexp(s, dim=-1).reshape(B, Sq, Hq).permute(0, 2, 1).contiguous()
    out = flash_attention_ref(q, k, v, causal, window, softcap, q_offset)
    return out, lse


def flash_attention_bwd_ref(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor, lse: torch.Tensor,
    do: torch.Tensor, causal: bool = True, window: int = 0, softcap: float = 0.0,
    q_offset: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) in the inputs' dtypes: P = exp(S - lse), Δ = rowsum(dO ∘ O),
    dS = P ∘ (dO Vᵀ - Δ) (times the softcap's tanh derivative), dq = dS K /
    sqrt(D), dk = dSᵀ Q / sqrt(D) summed over each GQA group, dv = Pᵀ dO."""
    B, Sq, Hq, D = q.shape
    _, Sk, Hkv, _ = k.shape
    G = Hq // Hkv
    scale = 1.0 / math.sqrt(D)
    s, m5, t = _scores(q, k, causal, window, softcap, q_offset)
    lse5 = lse.permute(0, 2, 1).reshape(B, Sq, Hkv, G, 1)
    p = torch.where(m5, torch.exp(s - lse5), 0.0)
    dof = do.float().reshape(B, Sq, Hkv, G, D)
    delta = (dof * o.float().reshape(B, Sq, Hkv, G, D)).sum(-1, keepdim=True)
    dv = torch.einsum("bqhgk,bqhgd->bkhd", p, dof)
    ds = p * (torch.einsum("bqhgd,bkhd->bqhgk", dof, v.float()) - delta)
    if t is not None:
        ds = ds * (1.0 - t * t)
    dq = torch.einsum("bqhgk,bkhd->bqhgd", ds, k.float()) * scale
    dk = torch.einsum("bqhgk,bqhgd->bkhd", ds, q.float().reshape(B, Sq, Hkv, G, D)) * scale
    return dq.reshape(B, Sq, Hq, D).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)
