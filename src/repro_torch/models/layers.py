"""PyTorch model layers of the dense decoder family (twins of the JAX
package's ``repro/models/layers.py``).

Conventions:
  * params are (nested) dicts of tensors; apply fns are plain functions.
  * compute dtype = cfg.dtype (bf16 on the card); accumulations in f32.
  * attention on a CUDA tensor always runs the hand-written Hopper kernels
    (``kernels/flash_attention`` for prefill/forward, ``kernels/decode_attention``
    for each decode step): the port has no XLA, so ``attn_impl`` "xla" and
    "pallas" name the same attention on the card.  On a CPU tensor, "xla"
    runs the ``_attn_chunked`` twin and "pallas*" the kernel's plain version,
    so each CPU path follows the JAX branch of the same name.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from ..kernels.decode_attention import decode_attention
from ..kernels.flash_attention import flash_attention
from .config import ModelConfig

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "float16": torch.float16}

Params = Dict[str, torch.Tensor]


def cdt(cfg: ModelConfig) -> torch.dtype:
    return DTYPES[cfg.dtype]


def pdt(cfg: ModelConfig) -> torch.dtype:
    return DTYPES[cfg.param_dtype]


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------
def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    x32 = x.float()
    var = (x32 * x32).mean(dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * w.float()).to(x.dtype)


# ---------------------------------------------------------------------------
# Rotary embeddings (half-split rotation)
# ---------------------------------------------------------------------------
def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(
    x: torch.Tensor,  # (B, S, H, D)
    positions: torch.Tensor,  # (B, S) integer
    theta: float,
    mrope: bool = False,
) -> torch.Tensor:
    if mrope and positions.dim() == 3:
        raise NotImplementedError("M-RoPE (3-stream positions) comes with the VLM slice "
                                  "(ROADMAP queue 1, item 6)")
    D = x.shape[-1]
    freqs = rope_freqs(D, theta, x.device)  # (D/2,)
    angles = positions.float()[:, :, None] * freqs[None, None, :]
    cos = torch.cos(angles)[:, :, None, :]  # (B, S, 1, D/2)
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------
def _attn_chunked(
    q: torch.Tensor,  # (B, Sq, Hq, D)
    k: torch.Tensor,  # (B, Sk, Hkv, D)
    v: torch.Tensor,  # (B, Sk, Hkv, D)
    q_offset: int,
    causal: bool,
    window: int,
    chunk: int,
    softcap: float = 0.0,
) -> torch.Tensor:
    """Plain online-softmax attention over KV chunks of ``chunk`` (twin of
    the JAX XLA path).  Products of compute-dtype operands accumulate in f32,
    as ``preferred_element_type=f32`` does; q is pre-scaled and rounded to the
    compute dtype before the dot, as in the JAX function."""
    B, Sq, Hq, D = q.shape
    _, Sk, Hkv, _ = k.shape
    G = Hq // Hkv
    scale = 1.0 / math.sqrt(D)
    qf = (q.float() * scale).to(q.dtype).reshape(B, Sq, Hkv, G, D).float()
    q_pos = q_offset + torch.arange(Sq, device=q.device)
    m = torch.full((B, Sq, Hkv, G), -torch.inf, device=q.device)
    l = torch.zeros((B, Sq, Hkv, G), device=q.device)
    acc = torch.zeros((B, Sq, Hkv, G, D), device=q.device)
    for lo in range(0, Sk, chunk):
        kci = k[:, lo:lo + chunk].float()
        vci = v[:, lo:lo + chunk]
        kv_pos = lo + torch.arange(kci.shape[1], device=q.device)
        s = torch.einsum("bqhgd,bkhd->bqhgk", qf, kci)
        if softcap > 0.0:
            s = softcap * torch.tanh(s / softcap)
        mask = torch.ones((Sq, kci.shape[1]), dtype=torch.bool, device=q.device)
        if causal:
            mask &= kv_pos[None, :] <= q_pos[:, None]
        if window > 0:
            mask &= kv_pos[None, :] > q_pos[:, None] - window
        m5 = mask[None, :, None, None, :]
        s = torch.where(m5, s, -torch.inf)
        m_new = torch.maximum(m, s.amax(dim=-1))
        # fully masked rows so far: exp(-inf - -inf) would be NaN, use 0
        m_safe = torch.where(torch.isfinite(m_new), m_new, 0.0)
        p = torch.where(m5, torch.exp(s - m_safe[..., None]), 0.0)
        alpha = torch.where(torch.isfinite(m), torch.exp(m - m_safe), 0.0)
        l = l * alpha + p.sum(dim=-1)
        pv = torch.einsum("bqhgk,bkhd->bqhgd", p.to(vci.dtype).float(), vci.float())
        acc = acc * alpha[..., None] + pv
        m = m_new
    out = acc / torch.clamp(l[..., None], min=1e-30)
    return out.reshape(B, Sq, Hq, D).to(q.dtype)


def _qkv(params: Params, x: torch.Tensor, cfg: ModelConfig):
    B, S, _ = x.shape
    q = (x @ params["wq"].to(x.dtype)).reshape(B, S, cfg.num_heads, cfg.head_dim)
    k = (x @ params["wk"].to(x.dtype)).reshape(B, S, cfg.num_kv_heads, cfg.head_dim)
    v = (x @ params["wv"].to(x.dtype)).reshape(B, S, cfg.num_kv_heads, cfg.head_dim)
    if cfg.qk_norm:
        q = rms_norm(q, params["q_norm"])
        k = rms_norm(k, params["k_norm"])
    return q, k, v


def attention(
    params: Params,
    x: torch.Tensor,  # (B, S, d)
    cfg: ModelConfig,
    positions: torch.Tensor,  # (B, S)
    causal: bool = True,
) -> torch.Tensor:
    """Self-attention over the whole sequence (train / prefill)."""
    B, S, _ = x.shape
    q, k, v = _qkv(params, x, cfg)
    q = apply_rope(q, positions, cfg.rope_theta, cfg.mrope)
    k = apply_rope(k, positions, cfg.rope_theta, cfg.mrope)
    if x.device.type == "cpu" and cfg.attn_impl == "xla":
        out = _attn_chunked(q, k, v, q_offset=0, causal=causal, window=cfg.attn_window,
                            chunk=min(cfg.attn_chunk, S), softcap=cfg.attn_logit_softcap)
    else:
        # The JAX Pallas branch drops cfg.attn_logit_softcap (layers.py:190-195)
        # while its XLA branch applies it; the port passes it on both, which
        # is the same function for every config (all have softcap 0).
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        out = flash_attention(q, k, v, causal=causal, window=cfg.attn_window,
                              softcap=cfg.attn_logit_softcap)
    return out.reshape(B, S, cfg.q_dim) @ params["wo"].to(x.dtype)


def attention_decode(
    params: Params,
    x_t: torch.Tensor,  # (B, 1, d)
    cache: Dict[str, torch.Tensor],  # {"k","v"}: (B, Smax, Hkv, D)
    pos: int,  # current length: the new token's position
    cfg: ModelConfig,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One-token decode against a KV cache.

    The new k and v are written into ``cache`` IN PLACE at ``pos`` (the JAX
    function returns an updated copy via ``dynamic_update_slice``); the same
    dict is returned.  On a CUDA tensor attention runs the decode kernel with
    ``lengths = pos + 1`` for every sequence, which is exactly the mask
    ``kv_pos <= pos`` (and the window) of the JAX function.
    """
    B = x_t.shape[0]
    q, k, v = _qkv(params, x_t, cfg)
    posb = torch.full((B, 1), pos, dtype=torch.int64, device=x_t.device)
    q = apply_rope(q, posb, cfg.rope_theta)
    k = apply_rope(k, posb, cfg.rope_theta)
    k_cache, v_cache = cache["k"], cache["v"]
    k_cache[:, pos] = k[:, 0].to(k_cache.dtype)
    v_cache[:, pos] = v[:, 0].to(v_cache.dtype)

    Hkv, G, D = cfg.num_kv_heads, cfg.num_heads // cfg.num_kv_heads, cfg.head_dim
    if x_t.device.type == "cpu" and cfg.attn_impl == "xla":
        scale = 1.0 / math.sqrt(D)
        qf = (q.float() * scale).to(k_cache.dtype).reshape(B, Hkv, G, D)
        s = torch.einsum("bhgd,bkhd->bhgk", qf.float(), k_cache.float())
        kv_pos = torch.arange(k_cache.shape[1], device=x_t.device)
        mask = kv_pos <= pos
        if cfg.attn_window > 0:
            mask &= kv_pos > pos - cfg.attn_window
        s = torch.where(mask[None, None, None, :], s, -torch.inf)
        p = torch.softmax(s, dim=-1)
        out = torch.einsum("bhgk,bkhd->bhgd", p.to(v_cache.dtype).float(), v_cache.float())
        out = out.to(x_t.dtype)
    else:
        lengths = torch.full((B,), pos + 1, dtype=torch.int32, device=x_t.device)
        out = decode_attention(q[:, 0].contiguous(), k_cache, v_cache, lengths,
                               window=cfg.attn_window)
    out = out.reshape(B, 1, cfg.q_dim) @ params["wo"].to(x_t.dtype)
    return out, cache


# ---------------------------------------------------------------------------
# FFN
# ---------------------------------------------------------------------------
def mlp(params: Params, x: torch.Tensor, act: str) -> torch.Tensor:
    if act == "swiglu":
        h = F.silu(x @ params["w1"].to(x.dtype)) * (x @ params["w3"].to(x.dtype))
    else:
        # jax.nn.gelu defaults to the tanh approximation
        h = F.gelu(x @ params["w1"].to(x.dtype), approximate="tanh")
    return h @ params["w2"].to(x.dtype)


# ---------------------------------------------------------------------------
# Parameter initialization
# ---------------------------------------------------------------------------
def _init(gen: torch.Generator, shape, scale: float, dtype: torch.dtype) -> torch.Tensor:
    x = torch.randn(shape, generator=gen, dtype=torch.float32, device=gen.device)
    return (x * scale).to(dtype)


# ``lead`` prepends dims to every leaf: a stacked group's repeats dim.
def init_attention(gen: torch.Generator, cfg: ModelConfig, lead: Tuple[int, ...] = ()) -> Params:
    d, qd, kvd = cfg.d_model, cfg.q_dim, cfg.kv_dim
    s = 1.0 / math.sqrt(d)
    p = {
        "wq": _init(gen, lead + (d, qd), s, pdt(cfg)),
        "wk": _init(gen, lead + (d, kvd), s, pdt(cfg)),
        "wv": _init(gen, lead + (d, kvd), s, pdt(cfg)),
        "wo": _init(gen, lead + (qd, d), 1.0 / math.sqrt(qd), pdt(cfg)),
    }
    if cfg.qk_norm:
        for name in ("q_norm", "k_norm"):
            p[name] = torch.ones(lead + (cfg.head_dim,), dtype=pdt(cfg), device=gen.device)
    return p


def init_mlp(gen: torch.Generator, cfg: ModelConfig, lead: Tuple[int, ...] = ()) -> Params:
    d, ff = cfg.d_model, cfg.d_ff
    p = {
        "w1": _init(gen, lead + (d, ff), 1.0 / math.sqrt(d), pdt(cfg)),
        "w2": _init(gen, lead + (ff, d), 1.0 / math.sqrt(ff), pdt(cfg)),
    }
    if cfg.mlp_act == "swiglu":
        p["w3"] = _init(gen, lead + (d, ff), 1.0 / math.sqrt(d), pdt(cfg))
    return p
