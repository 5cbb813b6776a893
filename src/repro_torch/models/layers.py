"""PyTorch model layers of every family (twins of the JAX package's
``repro/models/layers.py``, and of ``EncDecModel._cross_decode`` as
``cross_attention_decode``).

Conventions:
  * params are (nested) dicts of tensors; apply fns are plain functions.
  * compute dtype = cfg.dtype (bf16 on the card); accumulations in f32.
  * Route rule, the same for every layer that has a kernel: on a CUDA tensor
    the layer always runs the hand-written Hopper kernel (``flash_attention``
    for prefill/forward attention, self and cross, ``decode_attention`` for
    each decode step and each cross-attention decode step,
    ``ssd_scan`` in ``mamba2_mixer``, ``moe_router`` in ``moe_ffn``): the
    port has no XLA, so ``attn_impl`` "xla" and "pallas" name the same thing
    on the card.  On a CPU tensor, "xla" runs the twin of the JAX
    formulation (``_attn_chunked``, the chunked SSD einsums, ``top_k`` plus
    cumsum) and "pallas*" the kernel wrapper, whose CPU path is the kernel's
    plain version - so the CPU tests reach the kernel route's glue too.
  * The JAX ``moe_ffn`` and ``mamba2_mixer`` call no Pallas kernel; the
    kernels compute the same functions (``tests/test_torch_models.py``
    holds both routes against JAX).
  * Gradients: under autograd on a CUDA tensor, ``flash_attention``,
    ``ssd_scan`` and ``moe_router`` run their forward and backward kernels
    (``FlashAttention``, ``SSDScan``, ``MoERouter``), so the dense, MoE, SSM
    and hybrid families train on the card; ``decode_attention`` (serving)
    has no backward kernel and raises rather than return a tensor that cuts
    the gradient off.  On the CPU every route trains through autograd of the
    plain versions.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..dist.context import shard_activations
from ..kernels.decode_attention import decode_attention
from ..kernels.flash_attention import flash_attention
from ..kernels.moe_router import moe_router
from ..kernels.moe_router.ref import exclusive_slots
from ..kernels.ssd_scan import ssd_scan
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
    positions: torch.Tensor,  # (B, S) integer, or (B, S, 3) for M-RoPE
    theta: float,
    mrope: bool = False,
) -> torch.Tensor:
    D = x.shape[-1]
    freqs = rope_freqs(D, theta, x.device)  # (D/2,)
    if mrope and positions.dim() == 3:
        # M-RoPE (qwen2-vl): the rotary channels split into 3 sections,
        # D//2//3, D//2//3 and the rest, driven by the (temporal, height,
        # width) position streams.
        sec = D // 2 // 3
        bounds = (0, sec, 2 * sec, D // 2)
        angles = torch.cat([positions[..., i].float()[:, :, None]
                            * freqs[None, None, bounds[i]:bounds[i + 1]] for i in range(3)], -1)
    else:
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


def _qkv(params: Params, x: torch.Tensor, cfg: ModelConfig,
         src: Optional[torch.Tensor] = None):
    """q from ``x``; k and v from ``src`` (the cross-attention source), or
    from ``x`` when it is None."""
    src = x if src is None else src
    B, S, _ = x.shape
    Sk = src.shape[1]
    q = (x @ params["wq"].to(x.dtype)).reshape(B, S, cfg.num_heads, cfg.head_dim)
    k = (src @ params["wk"].to(x.dtype)).reshape(B, Sk, cfg.num_kv_heads, cfg.head_dim)
    v = (src @ params["wv"].to(x.dtype)).reshape(B, Sk, cfg.num_kv_heads, cfg.head_dim)
    if cfg.qk_norm:
        q = rms_norm(q, params["q_norm"])
        k = rms_norm(k, params["k_norm"])
    return q, k, v


def attention(
    params: Params,
    x: torch.Tensor,  # (B, S, d)
    cfg: ModelConfig,
    positions: torch.Tensor,  # (B, S), or (B, S, 3) for M-RoPE
    causal: bool = True,
    kv_x: Optional[torch.Tensor] = None,  # (B, Sk, d): the cross-attention source
    use_rope: bool = True,
) -> torch.Tensor:
    """Attention over the whole sequence (train / prefill): self-attention,
    or cross-attention over ``kv_x`` (no rope, no causal mask, Sq != Sk)."""
    B, S, _ = x.shape
    q, k, v = _qkv(params, x, cfg, kv_x)
    if use_rope and kv_x is None:
        q = apply_rope(q, positions, cfg.rope_theta, cfg.mrope)
        k = apply_rope(k, positions, cfg.rope_theta, cfg.mrope)
    causal = causal and kv_x is None
    if x.device.type == "cpu" and cfg.attn_impl == "xla":
        out = _attn_chunked(q, k, v, q_offset=0, causal=causal, window=cfg.attn_window,
                            chunk=min(cfg.attn_chunk, k.shape[1]),
                            softcap=cfg.attn_logit_softcap)
    else:
        # The JAX Pallas branch drops cfg.attn_logit_softcap (layers.py:190-195)
        # while its XLA branch applies it; the port passes it on both, which
        # is the same function for every config (all have softcap 0).
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        out = flash_attention(q, k, v, causal=causal, window=cfg.attn_window,
                              softcap=cfg.attn_logit_softcap)
    return out.reshape(B, S, cfg.q_dim) @ params["wo"].to(x.dtype)


def _decode_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """JAX's einsum decode of q (B, Hq, D) over k, v (B, S, Hkv, D): q scaled
    in f32 and rounded to the cache's dtype, f32 scores (keys outside the (S,)
    ``mask`` dropped, if given), an f32 softmax.  Returns (B, Hkv, G, D) f32."""
    B, Hq, D = q.shape
    Hkv = k.shape[2]
    qf = (q.float() * (1.0 / math.sqrt(D))).to(k.dtype).reshape(B, Hkv, Hq // Hkv, D)
    s = torch.einsum("bhgd,bkhd->bhgk", qf.float(), k.float())
    if mask is not None:
        s = torch.where(mask[None, None, None, :], s, -torch.inf)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhgk,bkhd->bhgd", p.to(v.dtype).float(), v.float())


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

    if x_t.device.type == "cpu" and cfg.attn_impl == "xla":
        kv_pos = torch.arange(k_cache.shape[1], device=x_t.device)
        mask = kv_pos <= pos
        if cfg.attn_window > 0:
            mask &= kv_pos > pos - cfg.attn_window
        out = _decode_plain(q[:, 0], k_cache, v_cache, mask).to(x_t.dtype)
    else:
        lengths = torch.full((B,), pos + 1, dtype=torch.int32, device=x_t.device)
        out = decode_attention(q[:, 0].contiguous(), k_cache, v_cache, lengths,
                               window=cfg.attn_window)
    out = out.reshape(B, 1, cfg.q_dim) @ params["wo"].to(x_t.dtype)
    return out, cache


def cross_attention_decode(
    params: Params,
    x_t: torch.Tensor,  # (B, 1, d)
    xk: torch.Tensor,  # (B, Senc, Hkv, D): the layer's precomputed cross K
    xv: torch.Tensor,  # (B, Senc, Hkv, D)
    cfg: ModelConfig,
) -> torch.Tensor:
    """One decoder token's cross-attention over the whole encoder output
    (twin of JAX ``EncDecModel._cross_decode``): no rope, no q norm, no
    mask, no cache write.  On a CUDA tensor it runs the decode kernel with
    ``lengths = Senc`` for every sequence; on the CPU ("xla") JAX's einsums,
    q scaled in f32 and rounded to the cache's dtype, an f32 softmax."""
    B = x_t.shape[0]
    q = (x_t @ params["wq"].to(x_t.dtype)).reshape(B, cfg.num_heads, cfg.head_dim)
    if x_t.device.type == "cpu" and cfg.attn_impl == "xla":
        out = _decode_plain(q, xk, xv).to(x_t.dtype)
    else:
        lengths = torch.full((B,), xk.shape[1], dtype=torch.int32, device=x_t.device)
        out = decode_attention(q.contiguous(), xk, xv, lengths)
    return out.reshape(B, 1, cfg.q_dim) @ params["wo"].to(x_t.dtype)


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


def _route_top_k(logits: torch.Tensor, k: int):
    """Twin of the JAX formulation: softmax, ``lax.top_k`` (a stable
    descending sort: ties go to the lower expert id, as in ``lax.top_k``),
    gates renormalised, slots by the gshard exclusive cumsum."""
    probs = torch.softmax(logits, dim=-1)
    gate, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate, ids = gate[..., :k], ids[..., :k]
    gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)
    slots = torch.stack([exclusive_slots(i, logits.shape[-1]) for i in ids])
    return ids, gate, slots


def moe_ffn(params: Params, x: torch.Tensor, cfg: ModelConfig,
            dropless: bool = False) -> torch.Tensor:
    """Token-choice top-k MoE with GShard-style grouped capacity dispatch.

    x: (T, d) flattened tokens.  Tokens split into ``cfg.moe_groups`` groups,
    each with its own capacity C (``dropless``: C = tokens per group, as the
    serving path uses).  Routing (softmax, top-k, slots) is the
    ``moe_router`` kernel on the kernel route, once per group; a choice with
    slot >= C is dropped.  The dispatch buffer has a spare slot C per expert
    that takes every dropped choice (``dispatch_slots``), so each kept
    (group, expert, slot) receives exactly one token: the scatter is a plain
    assignment, not a sum.  The spare slot is cut off before the expert
    products and reads as zero in the gather.
    """
    T, d = x.shape
    E, k = cfg.num_experts, cfg.experts_per_token
    G = max(1, cfg.moe_groups if T % max(1, cfg.moe_groups) == 0 else 1)
    t = T // G
    if dropless:
        C = t
    else:
        C = max(1, int(math.ceil(t * k / E * cfg.capacity_factor)))
        C = min(C, t)

    xg = shard_activations(x.reshape(G, t, d), "gtd")
    logits = (xg @ params["router"].to(x.dtype)).float()  # (G, t, E)
    if x.device.type == "cpu" and cfg.attn_impl == "xla":
        expert_ids, gate, pos = _route_top_k(logits, k)
    else:
        routed = [moe_router(logits[g].contiguous(), k) for g in range(G)]
        expert_ids, gate, pos = (torch.stack(r) for r in zip(*routed))
    expert_ids = expert_ids.long()
    gate = gate.to(x.dtype)
    slot = dispatch_slots(pos, C)  # capacity-dropped choices fall back to the residual only
    gid = torch.arange(G, device=x.device)[:, None, None].expand(G, t, k)
    buf = torch.zeros((G, E, C + 1, d), dtype=x.dtype, device=x.device)
    buf[gid, expert_ids, slot] = xg[:, :, None, :].expand(G, t, k, d)
    buf = shard_activations(buf[:, :, :C], "gecd")

    w1 = params["w1"].to(x.dtype)
    if cfg.mlp_act == "swiglu":
        h = F.silu(torch.einsum("gecd,edf->gecf", buf, w1)) * torch.einsum(
            "gecd,edf->gecf", buf, params["w3"].to(x.dtype))
    else:
        h = F.gelu(torch.einsum("gecd,edf->gecf", buf, w1), approximate="tanh")
    out_buf = shard_activations(torch.einsum("gecf,efd->gecd", h, params["w2"].to(x.dtype)),
                                "gecd")
    out_buf = F.pad(out_buf, (0, 0, 0, 1))  # the spare slot C reads zero

    gathered = out_buf[gid, expert_ids, slot]  # (G, t, k, d)
    out = (gathered * gate[..., None]).sum(dim=2)
    return out.reshape(T, d)


def dispatch_slots(pos: torch.Tensor, C: int) -> torch.Tensor:
    """The dispatch slot of each choice: its capacity slot when it is kept
    (``pos < C``), else the spare slot C that collects every dropped choice.
    Kept (group, expert, slot) triples are unique because the router's slots
    count each expert's choices in token-major order."""
    return torch.where(pos < C, pos, C).long()


# ---------------------------------------------------------------------------
# mamba2 (SSD)
# ---------------------------------------------------------------------------
def _segsum(x: torch.Tensor) -> torch.Tensor:
    """Lower-triangular pairwise segment sums: out[..., i, j] = sum_{j<t<=i} x[t]."""
    Q = x.shape[-1]
    cs = torch.cumsum(x, dim=-1)
    seg = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=x.device))
    return torch.where(mask, seg, -torch.inf)


def _depthwise_causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """x: (B, L, Ch), w: (K, Ch) depthwise causal conv.  w and b are used
    uncast, so f32 params promote a bf16 x to f32, as in the JAX function."""
    K, L = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, K - 1, 0))
    out = torch.zeros_like(x)
    for i in range(K):
        out = out + xp[:, i:i + L, :] * w[i][None, None, :]
    return out + b[None, None, :]


def _ssd_chunked(xs, Bc, Cc, dt, a, D, cfg: ModelConfig, Q: int) -> torch.Tensor:
    """Twin of the JAX chunked SSD (einsums per chunk, a loop over chunks for
    ``lax.scan``); (B, L, H, P) f32 with the D term."""
    B, L = xs.shape[:2]
    H, P, N, G = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state, cfg.ssm_groups
    nc = -(-L // Q)
    pad = nc * Q - L
    if pad:
        xs, Bc, Cc, dt = (F.pad(t, (0, 0, 0, pad)) for t in (xs, Bc, Cc, dt))
    Lp = nc * Q
    xh = xs.reshape(B, nc, Q, H, P).float()
    Bh = Bc.reshape(B, nc, Q, G, N).float().repeat_interleave(H // G, dim=3)
    Ch = Cc.reshape(B, nc, Q, G, N).float().repeat_interleave(H // G, dim=3)
    dth = dt.reshape(B, nc, Q, H)

    da = dth * a[None, None, None, :]
    da_cum = torch.cumsum(da, dim=2)
    Lmat = torch.exp(_segsum(da.permute(0, 1, 3, 2)))  # (B, nc, H, Q, Q)
    CB = torch.einsum("bcqhn,bckhn->bchqk", Ch, Bh)
    Y_diag = torch.einsum("bchqk,bckh,bckhp->bcqhp", CB * Lmat, dth, xh)
    decay_states = torch.exp(da_cum[:, :, -1:, :] - da_cum)
    S = torch.einsum("bcqhn,bcqh,bcqh,bcqhp->bchnp", Bh, decay_states, dth, xh)
    chunk_decay = torch.exp(da_cum[:, :, -1, :])  # (B, nc, H)
    h = torch.zeros((B, H, N, P), dtype=torch.float32, device=xs.device)
    h_prev = []
    for c in range(nc):  # state entering each chunk
        h_prev.append(h)
        h = h * chunk_decay[:, c, :, None, None] + S[:, c]
    state_decay = torch.exp(da_cum)
    Y_off = torch.einsum("bcqhn,bchnp,bcqh->bcqhp", Ch, torch.stack(h_prev, dim=1), state_decay)
    Y = (Y_diag + Y_off).reshape(B, Lp, H, P)[:, :L]
    return Y + xs.reshape(B, Lp, H, P)[:, :L] * D.float()[None, None, :, None]


def mamba2_mixer(params: Params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """SSD forward over a full sequence (prefill).  x: (B, L, d).

    The kernel route hands the scan, with D, to ``ssd_scan``: the kernel
    adds ``D * x`` itself, so it is not added again here, and it reads the
    G groups of B and C in place (no ``repeat_interleave``)."""
    B, L, d = x.shape
    H, P, N, G = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state, cfg.ssm_groups
    di = cfg.ssm_d_inner
    Q = min(cfg.ssm_chunk, L)

    zxbcdt = x @ params["in_proj"].to(x.dtype)  # (B, L, 2di + 2GN + H)
    z, xs, Bc, Cc, dt = torch.split(zxbcdt, [di, di, G * N, G * N, H], dim=-1)
    xbc = torch.cat([xs, Bc, Cc], dim=-1)
    xbc = F.silu(_depthwise_causal_conv(xbc, params["conv_w"], params["conv_b"]))
    xs, Bc, Cc = torch.split(xbc, [di, G * N, G * N], dim=-1)
    dt = F.softplus(dt.float() + params["dt_bias"].float())
    a = -torch.exp(params["A_log"].float())  # (H,)

    if x.device.type == "cpu" and cfg.attn_impl == "xla":
        Y = _ssd_chunked(xs, Bc, Cc, dt, a, params["D"], cfg, Q)
    else:
        Y = ssd_scan(xs.reshape(B, L, H, P).contiguous(), dt.contiguous(), a,
                     Bc.reshape(B, L, G, N).contiguous(), Cc.reshape(B, L, G, N).contiguous(),
                     params["D"].float().contiguous(), chunk=Q)[0]
    Y = Y.reshape(B, L, di).to(x.dtype)
    Y = rms_norm(Y * F.silu(z), params["norm_w"])  # gated RMSNorm
    return Y @ params["out_proj"].to(x.dtype)


def mamba2_decode(
    params: Params,
    x_t: torch.Tensor,  # (B, 1, d)
    state: Dict[str, torch.Tensor],  # {"h": (B,H,N,P) f32, "conv": (B,K-1,Ch)}
    cfg: ModelConfig,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Single-token SSD recurrence: h <- exp(dt a) h + dt B x ; y = C h + D x.

    ``state`` is updated IN PLACE (``copy_``, so views of a stacked cache see
    it; the JAX function returns a new state) and returned."""
    B = x_t.shape[0]
    H, P, N, G = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state, cfg.ssm_groups
    di = cfg.ssm_d_inner
    zxbcdt = (x_t @ params["in_proj"].to(x_t.dtype))[:, 0]
    z, xs, Bc, Cc, dt = torch.split(zxbcdt, [di, di, G * N, G * N, H], dim=-1)
    xbc = torch.cat([xs, Bc, Cc], dim=-1)  # (B, Ch)
    full = torch.cat([state["conv"], xbc[:, None, :]], dim=1)  # (B, K, Ch)
    conv_out = (full * params["conv_w"][None]).sum(1) + params["conv_b"]
    xbc = F.silu(conv_out)
    xs, Bc, Cc = torch.split(xbc, [di, G * N, G * N], dim=-1)
    dt = F.softplus(dt.float() + params["dt_bias"].float())  # (B, H)
    a = -torch.exp(params["A_log"].float())
    xh = xs.reshape(B, H, P).float()
    Bh = Bc.reshape(B, G, N).repeat_interleave(H // G, dim=1).float()
    Ch = Cc.reshape(B, G, N).repeat_interleave(H // G, dim=1).float()
    decay = torch.exp(dt * a[None, :])
    h = state["h"] * decay[..., None, None] + torch.einsum("bhn,bh,bhp->bhnp", Bh, dt, xh)
    y = torch.einsum("bhn,bhnp->bhp", Ch, h) + xh * params["D"].float()[None, :, None]
    y = y.reshape(B, 1, di).to(x_t.dtype)
    y = rms_norm(y * F.silu(z[:, None, :]), params["norm_w"])
    out = y @ params["out_proj"].to(x_t.dtype)
    state["h"].copy_(h)
    state["conv"].copy_(full[:, 1:])
    return out, state


# ---------------------------------------------------------------------------
# Parameter initialization
# ---------------------------------------------------------------------------
def _init(gen: torch.Generator, shape, scale: float, dtype: torch.dtype) -> torch.Tensor:
    """Normal(0, scale) in ``dtype``, drawn in f32.  A leaf of three or more
    dims (stacked repeats, experts) is drawn one matrix at a time into a
    tensor of ``dtype``, so the f32 temporary is one matrix, not the leaf
    (moonshot's (47, 64, 2048, 1408) expert leaf would need 34.7 GB).  On
    the ``meta`` device (``lm.MetaGenerator``) it draws nothing and returns
    the shape-only leaf."""
    if gen.device.type == "meta":
        return torch.empty(shape, dtype=dtype, device="meta")
    if len(shape) <= 2:
        x = torch.randn(shape, generator=gen, dtype=torch.float32, device=gen.device)
        return x.mul_(scale).to(dtype)
    out = torch.empty(shape, dtype=dtype, device=gen.device)
    for i in range(shape[0]):
        out[i] = _init(gen, shape[1:], scale, dtype)
    return out


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


def init_moe(gen: torch.Generator, cfg: ModelConfig, lead: Tuple[int, ...] = ()) -> Params:
    d, ff, E = cfg.d_model, cfg.d_ff, cfg.num_experts
    p = {
        "router": _init(gen, lead + (d, E), 1.0 / math.sqrt(d), pdt(cfg)),
        "w1": _init(gen, lead + (E, d, ff), 1.0 / math.sqrt(d), pdt(cfg)),
        "w2": _init(gen, lead + (E, ff, d), 1.0 / math.sqrt(ff), pdt(cfg)),
    }
    if cfg.mlp_act == "swiglu":
        p["w3"] = _init(gen, lead + (E, d, ff), 1.0 / math.sqrt(d), pdt(cfg))
    return p


def init_mamba2(gen: torch.Generator, cfg: ModelConfig, lead: Tuple[int, ...] = ()) -> Params:
    d, di, N, G, H = cfg.d_model, cfg.ssm_d_inner, cfg.ssm_state, cfg.ssm_groups, cfg.ssm_heads
    conv_ch = di + 2 * G * N
    dev, pd = gen.device, pdt(cfg)
    a_log = torch.log(torch.linspace(1.0, 16.0, H, device=dev)).to(pd)
    return {
        "in_proj": _init(gen, lead + (d, 2 * di + 2 * G * N + H), 1.0 / math.sqrt(d), pd),
        "conv_w": _init(gen, lead + (4, conv_ch), 0.5, pd),
        "conv_b": torch.zeros(lead + (conv_ch,), dtype=pd, device=dev),
        "A_log": a_log.expand(lead + (H,)).clone(),
        "D": torch.ones(lead + (H,), dtype=pd, device=dev),
        "dt_bias": torch.zeros(lead + (H,), dtype=pd, device=dev),
        "norm_w": torch.ones(lead + (di,), dtype=pd, device=dev),
        "out_proj": _init(gen, lead + (di, d), 1.0 / math.sqrt(di), pd),
    }
