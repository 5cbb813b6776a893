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
    ``causal_conv`` and ``ssd_scan`` in ``mamba2_mixer``, ``moe_router`` in
    ``moe_ffn``, ``rms_norm`` for every RMSNorm, the mixer's gated one
    included): the port has no XLA, so ``attn_impl`` "xla" and "pallas"
    name the same thing on the card.  On a CPU tensor, "xla" runs the twin
    of the JAX formulation (``_attn_chunked``, the conv's loop over its taps
    and the chunked SSD einsums, ``top_k`` plus cumsum) and "pallas*" the
    kernel wrapper, whose CPU path is the kernel's plain version - so the
    CPU tests reach the kernel route's glue too.
  * The JAX ``moe_ffn`` and ``mamba2_mixer`` call no Pallas kernel; the
    kernels compute the same functions (``tests/test_torch_models.py``
    holds both routes against JAX).
  * On a mesh of more than one device the layers run on ``DTensor``s: what
    they make themselves enters the mesh through ``like_mesh``, the kernel
    wrappers take their inputs local (``kernels/_boundary.py``), and the
    embedding lookup, the MoE routing, scatter and gather and the cache
    writes run on each rank's shard.
  * The decoder's block and final norms are RMSNorm or, with
    ``cfg.norm_type == "layer"``, LayerNorm with a shift, at
    ``cfg.norm_eps`` (``block_norm``); a projection adds its bias where the
    tree holds one (``proj``; ``cfg.use_bias``: q, k, v, o and the dense
    MLP's).  Both are the port's own: the JAX block has neither.
  * Gradients: under autograd on a CUDA tensor, ``flash_attention``,
    ``causal_conv``, ``ssd_scan``, ``moe_router`` and ``rms_norm`` run their
    forward and backward kernels (``FlashAttention``, ``CausalConv``,
    ``SSDScan``, ``MoERouter``, ``RMSNorm``), so the dense, MoE, SSM and
    hybrid families train on the card; ``decode_attention`` (serving) has no
    backward kernel and raises rather than return a tensor that cuts the
    gradient off.  On the CPU every route trains through autograd of the
    plain versions.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from ..dist.context import keep_grad_layout, like_mesh, shard_activations, unshard_dim
from ..kernels.causal_conv import causal_conv
from ..kernels.decode_attention import decode_attention
from ..kernels.flash_attention import flash_attention
from ..kernels.moe_router import moe_router
from ..kernels.moe_router.ref import exclusive_slots
from ..kernels.rms_norm import rms_norm as kernel_rms_norm
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
def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6,
             gate: Optional[torch.Tensor] = None) -> torch.Tensor:
    """RMSNorm over the last dim with scale ``w`` in f32, back in x's dtype;
    with a ``gate`` z (the mamba2 mixer's gated norm) of ``x.to(z.dtype) *
    silu(z)``, in z's dtype.  The kernel ``rms_norm`` on a CUDA tensor, its
    plain version (this formulation) on the CPU."""
    return kernel_rms_norm(x, w, eps, gate)


def layer_norm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, eps: float) -> torch.Tensor:
    """LayerNorm over the last dim with scale ``w`` and shift ``b``, in f32
    as ``rms_norm`` is, back in x's dtype."""
    return F.layer_norm(x.float(), (x.shape[-1],), w.float(), b.float(), eps).to(x.dtype)


def block_norm(x: torch.Tensor, p: Params, name: str, cfg: ModelConfig) -> torch.Tensor:
    """The decoder's norm ``name`` of ``p`` (a block's "ln1" or "ln2", the
    model's "final_norm") at ``cfg.norm_eps``: RMSNorm of the scale
    ``p[name]``, or with ``cfg.norm_type == "layer"`` LayerNorm of it and
    the shift ``p[name + "_bias"]``."""
    if cfg.norm_type == "layer":
        return layer_norm(x, p[name], p[f"{name}_bias"], cfg.norm_eps)
    return rms_norm(x, p[name], cfg.norm_eps)


def proj(x: torch.Tensor, p: Params, w: str, b: Optional[str] = None) -> torch.Tensor:
    """``linear(x, p[w])`` plus the bias ``p[b]`` where the tree holds one (a
    config with ``use_bias``)."""
    return linear(x, p[w], p.get(b))


def linear(x: torch.Tensor, weight: torch.Tensor,
           bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``x @ weight (+ bias)``, both cast to x's dtype.  Off a mesh the bias
    is added in the product's epilogue (``F.linear``: cuBLAS's bias
    epilogue on the card).  On a mesh, a product of an activation whose
    sequence a mesh dim splits runs on each rank's own tokens with the
    weight gathered whole, the result in x's layout: what XLA's partitioner
    emits for the reference (DTensor's own product would flatten the split
    batch and sequence into strided shards, whose strategy search takes
    minutes a layer).  Any other product keeps its gradient in its output's
    layout, so a consumer that splits the sequence hands its backward no
    strided shards either."""
    weight = weight.to(x.dtype)
    bias = None if bias is None else bias.to(x.dtype)
    if not isinstance(x, DTensor):
        return x @ weight if bias is None else F.linear(x, weight.t(), bias)
    if not _splits_sequence(x):
        return keep_grad_layout(x @ weight if bias is None else x @ weight + bias)
    mesh = x.device_mesh
    summed = [Partial() if isinstance(p, Shard) else Replicate() for p in x.placements]

    def whole(t):  # its gradient: a sum over the ranks' tokens
        t = like_mesh(t, x).redistribute(mesh, [Replicate()] * mesh.ndim)
        return t.to_local(grad_placements=summed)

    y = x.to_local() @ whole(weight)
    y = y if bias is None else y + whole(bias)
    return DTensor.from_local(y, mesh, x.placements, run_check=False)


def _splits_sequence(x: DTensor) -> bool:
    """Whether a mesh dim splits a middle dim of x (the sequence of a
    (B, S, d) activation) and none splits its last dim or holds a sum."""
    live = [p for i, p in enumerate(x.placements) if x.device_mesh.size(i) > 1]
    if any(isinstance(p, Partial) or isinstance(p, Shard) and p.dim % x.ndim == x.ndim - 1
           for p in live):
        return False
    return any(isinstance(p, Shard) and p.dim % x.ndim > 0 for p in live)


def assign(dst: torch.Tensor, src: torch.Tensor) -> None:
    """``dst.copy_(src)``, in place (a cache row, a decode state).  On a mesh
    ``src`` is first laid out as ``dst`` and each rank writes its own shard:
    an in-place op cannot move ``dst``."""
    if isinstance(dst, DTensor):
        src = like_mesh(src, dst).redistribute(dst.device_mesh, dst.placements)
        dst.to_local().copy_(src.to_local())
    else:
        dst.copy_(src)


# ---------------------------------------------------------------------------
# Embedding lookup
# ---------------------------------------------------------------------------
def embed_lookup(table: torch.Tensor, tokens: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Rows ``tokens`` (any shape, integer) of ``table`` (V, d), gathered in
    the table's dtype and then cast to ``dtype``: ``table[tokens].to(dtype)``.
    The backward then adds the gradients of repeated ids in the table's
    dtype (f32 for f32 params; a bf16 table gathered after its cast adds
    them in bf16, and a frequent id's gradient stalls), and no cast of the
    whole table is made.  On a mesh whose dim splits the vocabulary it is
    Megatron's vocab-parallel lookup (``_vocab_parallel_lookup``)."""
    if isinstance(table, DTensor):
        vdims = [i for i, p in enumerate(table.placements)
                 if isinstance(p, Shard) and p.dim == 0 and table.device_mesh.size(i) > 1]
        if len(vdims) == 1:
            return _vocab_parallel_lookup(table, tokens, dtype, vdims[0])
    return table[like_mesh(tokens, table).long()].to(dtype)


def _vocab_parallel_lookup(table: DTensor, tokens: torch.Tensor, dtype: torch.dtype,
                           vdim: int) -> DTensor:
    """Every rank looks up all the tokens in its own rows and columns of the
    table (rows outside its vocabulary range read zero): a sum over the
    vocabulary's mesh dim, split along d as the table is.  It is reduced
    (an all-reduce) and its split moved from d to the tokens' leading dim
    (an all-to-all), the layout of ``tokens``."""
    mesh = table.device_mesh
    tokens = like_mesh(tokens, table)
    tok_layout = tokens.placements
    whole = [Replicate()] * mesh.ndim
    v_local = table.shape[0] // mesh.size(vdim)
    lo = mesh.get_local_rank(vdim) * v_local
    d_dim = tokens.ndim  # the model dim of the result
    out = [Partial() if i == vdim else Shard(d_dim) if isinstance(p, Shard) and p.dim == 1
           else Replicate() for i, p in enumerate(table.placements)]

    def lookup(tab, tok):
        idx = tok.long() - lo
        inside = (idx >= 0) & (idx < v_local)
        rows = tab[idx.clamp(0, v_local - 1)].to(dtype)
        return torch.where(inside[..., None], rows, rows.new_zeros(()))

    rows = local_map(lookup, out_placements=(out,), in_placements=(table.placements, whole),
                     device_mesh=mesh, redistribute_inputs=True)(table, _all_tokens(tokens))
    return rows.redistribute(mesh, [p if isinstance(p, Shard) else Replicate()
                                    for p in tok_layout])


def _all_tokens(tokens: DTensor) -> DTensor:
    """``tokens`` whole on every rank.  Split over one data axis as wide as
    the model axis (a square mesh), they are gathered as XLA's partitioner
    gathers the reference's: a collective permute to the transposed device
    ((data d, model m) sends its rows to (m, d)), then an all-gather over
    the model axis.  Otherwise an all-gather over the axes that split
    them."""
    import torch.distributed as dist
    import torch.distributed._functional_collectives as funcol

    mesh = tokens.device_mesh
    whole = [Replicate()] * mesh.ndim
    names = list(mesh.mesh_dim_names or ())
    split = [i for i, p in enumerate(tokens.placements) if isinstance(p, Shard)]
    if (mesh.ndim != 2 or names != ["data", "model"] or split != [0]
            or tokens.placements[0].dim != 0 or mesh.size(0) != mesh.size(1)
            or mesh.size() != dist.get_world_size()):
        return tokens.redistribute(mesh, whole)
    ranks = mesh.mesh.tolist()
    src_dst = [0] * mesh.size()
    for d, row in enumerate(ranks):
        for m, r in enumerate(row):
            src_dst[r] = ranks[m][d]
    local = tokens.to_local()
    # permute_tensor splits by element counts: it moves a flat tensor
    moved = funcol.permute_tensor(local.reshape(-1), src_dst, dist.group.WORLD)
    gather = getattr(funcol, "all_gather_single", None) or funcol.all_gather_tensor
    rows = gather(moved.reshape(local.shape), 0, (mesh, 1))
    return DTensor.from_local(rows, mesh, whole, run_check=False)


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
    positions = like_mesh(positions, x)  # on a mesh: positions and freqs enter it
    freqs = like_mesh(rope_freqs(D, theta, x.device), positions)  # (D/2,)
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


def split_heads(t: torch.Tensor, heads: int) -> torch.Tensor:
    """(..., heads x D) as (..., heads, D).  On a mesh that splits the last
    dim mid-head (more ways than ``heads`` divides: llama3-405b's 8 kv heads
    on a 16-wide model axis) it is gathered first."""
    if isinstance(t, DTensor):
        n = math.prod(t.device_mesh.size(i) for i, p in enumerate(t.placements)
                      if isinstance(p, Shard) and p.dim % t.ndim == t.ndim - 1)
        if heads % n:
            t = unshard_dim(t, -1)
    return keep_grad_layout(t.reshape(*t.shape[:-1], heads, t.shape[-1] // heads))


def _qkv(params: Params, x: torch.Tensor, cfg: ModelConfig,
         src: Optional[torch.Tensor] = None):
    """q from ``x``; k and v from ``src`` (the cross-attention source), or
    from ``x`` when it is None."""
    src = x if src is None else src
    B, S, _ = x.shape
    Sk = src.shape[1]
    q = split_heads(proj(x, params, "wq", "bq"), cfg.num_heads)
    k = split_heads(proj(src, params, "wk", "bk"), cfg.num_kv_heads)
    v = split_heads(proj(src, params, "wv", "bv"), cfg.num_kv_heads)
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
        # causal, window and softcap go by position: a caller that records
        # the call's positional arguments sees the whole call.
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        out = flash_attention(q, k, v, causal, cfg.attn_window, cfg.attn_logit_softcap)
    return proj(keep_grad_layout(out.reshape(B, S, cfg.q_dim)), params, "wo", "bo")


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
    assign(k_cache[:, pos], k[:, 0].to(k_cache.dtype))
    assign(v_cache[:, pos], v[:, 0].to(v_cache.dtype))

    if x_t.device.type == "cpu" and cfg.attn_impl == "xla":
        kv_pos = torch.arange(k_cache.shape[1], device=x_t.device)
        mask = kv_pos <= pos
        if cfg.attn_window > 0:
            mask &= kv_pos > pos - cfg.attn_window
        out = _decode_plain(q[:, 0], k_cache, v_cache, mask).to(x_t.dtype)
    else:
        lengths = like_mesh(torch.full((B,), pos + 1, dtype=torch.int32, device=x_t.device), q)
        out = decode_attention(q[:, 0].contiguous(), k_cache, v_cache, lengths,
                               window=cfg.attn_window)
    out = proj(out.reshape(B, 1, cfg.q_dim), params, "wo", "bo")
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
    q = split_heads(x_t @ params["wq"].to(x_t.dtype), cfg.num_heads)[:, 0]
    if x_t.device.type == "cpu" and cfg.attn_impl == "xla":
        out = _decode_plain(q, xk, xv).to(x_t.dtype)
    else:
        lengths = like_mesh(torch.full((B,), xk.shape[1], dtype=torch.int32, device=x_t.device),
                            q)
        out = decode_attention(q.contiguous(), xk, xv, lengths)
    return out.reshape(B, 1, cfg.q_dim) @ params["wo"].to(x_t.dtype)


# ---------------------------------------------------------------------------
# FFN
# ---------------------------------------------------------------------------
def mlp(params: Params, x: torch.Tensor, act: str) -> torch.Tensor:
    """The dense FFN, with the biases b1 and b2 where the tree holds them
    (``use_bias``).  On a mesh its hidden products are pinned to
    Megatron's layout, batch over the data axes and the hidden width over
    the model axis ("...h"): the layout the rules give w1, w3 and w2, which
    keeps DTensor from splitting the tokens over the model axis (strided
    shards on which its strategy search takes minutes)."""
    roles = "bsh"[3 - x.ndim:] if x.ndim <= 3 else None

    def up(w, b=None):
        y = proj(x, params, w, b)
        return shard_activations(y, roles) if roles else y

    if act == "swiglu":
        h = F.silu(up("w1", "b1")) * up("w3")
    else:
        # jax.nn.gelu defaults to the tanh approximation
        h = F.gelu(up("w1", "b1"), approximate="tanh")
    return proj(h, params, "w2", "b2")


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
    xla = x.device.type == "cpu" and cfg.attn_impl == "xla"
    expert_ids, gate, pos = _per_group(_route, (logits,), 3, k=k, xla=xla)
    slot = dispatch_slots(pos, C)  # capacity-dropped choices fall back to the residual only
    buf = _per_group(_dispatch, (xg, expert_ids, slot), 1, E=E, C=C)  # (G, E, C + 1, d)
    buf = shard_activations(buf[:, :, :C], "gecd")

    w1 = params["w1"].to(x.dtype)
    if cfg.mlp_act == "swiglu":
        h = F.silu(torch.einsum("gecd,edf->gecf", buf, w1)) * torch.einsum(
            "gecd,edf->gecf", buf, params["w3"].to(x.dtype))
    else:
        h = F.gelu(torch.einsum("gecd,edf->gecf", buf, w1), approximate="tanh")
    out_buf = shard_activations(torch.einsum("gecf,efd->gecd", h, params["w2"].to(x.dtype)),
                                "gecd")
    out = _per_group(_combine, (out_buf, expert_ids, slot, gate), 1)
    return out.reshape(T, d)


def _route(logits: torch.Tensor, k: int, xla: bool):
    """(expert ids long, gates f32, capacity slots) (G, t, k) of each
    group's (t, E) logits: the ``moe_router`` kernel per group, or the twin
    of the JAX formulation (``xla``)."""
    if xla:
        ids, gate, pos = _route_top_k(logits, k)
    else:
        routed = [moe_router(logits[g].contiguous(), k) for g in range(logits.shape[0])]
        ids, gate, pos = (torch.stack(r) for r in zip(*routed))
    return ids.long(), gate, pos


def _dispatch(xg: torch.Tensor, expert_ids: torch.Tensor, slot: torch.Tensor, E: int,
              C: int) -> torch.Tensor:
    """The (G, E, C + 1, d) buffer of each expert's tokens, slot C taking
    every dropped choice."""
    G, t, d = xg.shape
    k = expert_ids.shape[-1]
    gid = torch.arange(G, device=xg.device)[:, None, None].expand(G, t, k)
    buf = torch.zeros((G, E, C + 1, d), dtype=xg.dtype, device=xg.device)
    buf[gid, expert_ids, slot] = xg[:, :, None, :].expand(G, t, k, d)
    return buf


def _combine(out_buf: torch.Tensor, expert_ids: torch.Tensor, slot: torch.Tensor,
             gate: torch.Tensor) -> torch.Tensor:
    """Each token's experts' outputs (G, E, C, d) weighted by its gates:
    (G, t, d); the spare slot C reads zero."""
    out_buf = F.pad(out_buf, (0, 0, 0, 1))
    G, t, k = expert_ids.shape
    gid = torch.arange(G, device=out_buf.device)[:, None, None].expand(G, t, k)
    gathered = out_buf[gid, expert_ids, slot]  # (G, t, k, d)
    return (gathered * gate.to(out_buf.dtype)[..., None]).sum(dim=2)


def _per_group(fn, args, n_out: int, **kw):
    """``fn(*args, **kw)``; on a mesh, local to each rank's groups (the
    routing, scatter and gather of ``moe_ffn`` run on the group shard, their
    first dim, split over the data axes as the plan pins it; the expert dim
    whole: what moves between them and the expert products is the layout
    constraint's redistribution)."""
    ref = args[0]
    if not isinstance(ref, DTensor):
        return fn(*args, **kw)
    mesh = ref.device_mesh
    spec = [Shard(0) if isinstance(p, Shard) and p.dim == 0 else Replicate()
            for p in ref.placements]
    ins = [spec if isinstance(a, torch.Tensor) else None for a in args]
    outs = spec if n_out == 1 else (spec,) * n_out
    return local_map(lambda *a: fn(*a, **kw), out_placements=outs, in_placements=tuple(ins),
                     in_grad_placements=tuple(ins), device_mesh=mesh,
                     redistribute_inputs=True)(*args)


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

    The kernel route hands the conv, its bias and SiLU to ``causal_conv``,
    which reads the (x, B, C) columns of the in_proj output in place and
    writes the three contiguous tensors the scan takes, and the scan, with
    D, to ``ssd_scan``: the kernel adds ``D * x`` itself, so it is not added
    again here, and it reads the G groups of B and C in place (no
    ``repeat_interleave``).  The gated norm takes Y in f32 and z in place
    (``rms_norm(..., gate=z)``): on the card one kernel rounds, gates and
    normalises each row."""
    B, L, d = x.shape
    H, P, N, G = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state, cfg.ssm_groups
    di = cfg.ssm_d_inner
    Q = min(cfg.ssm_chunk, L)

    # (B, L, 2di + 2GN + H); on a mesh its pieces' widths need it whole
    zxbcdt = unshard_dim(linear(x, params["in_proj"]), -1)
    z, xbc, dt = torch.split(zxbcdt, [di, di + 2 * G * N, H], dim=-1)
    dt = F.softplus(dt.float() + params["dt_bias"].float())
    a = -torch.exp(params["A_log"].float())  # (H,)

    if x.device.type == "cpu" and cfg.attn_impl == "xla":
        xbc = F.silu(_depthwise_causal_conv(xbc, params["conv_w"], params["conv_b"]))
        xs, Bc, Cc = torch.split(xbc, [di, G * N, G * N], dim=-1)
        Y = _ssd_chunked(xs, Bc, Cc, dt, a, params["D"], cfg, Q)
    else:
        xs, Bc, Cc = causal_conv(xbc, params["conv_w"], params["conv_b"], di)
        Y = ssd_scan(xs.reshape(B, L, H, P), dt.contiguous(), a, Bc.reshape(B, L, G, N),
                     Cc.reshape(B, L, G, N), params["D"].float().contiguous(), chunk=Q)[0]
    # gated RMSNorm of Y by SiLU(z): Y (f32) rounded to z's dtype in the kernel
    Y = rms_norm(Y.reshape(B, L, di), params["norm_w"], cfg.norm_eps, gate=z)
    return linear(Y, params["out_proj"])


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
    zxbcdt = unshard_dim(x_t @ params["in_proj"].to(x_t.dtype), -1)[:, 0]
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
    y = rms_norm(y.reshape(B, 1, di), params["norm_w"], cfg.norm_eps, gate=z[:, None, :])
    out = y @ params["out_proj"].to(x_t.dtype)
    assign(state["h"], h)
    assign(state["conv"], full[:, 1:])
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
    if cfg.use_bias:
        for name, n in (("bq", qd), ("bk", kvd), ("bv", kvd), ("bo", d)):
            p[name] = torch.zeros(lead + (n,), dtype=pdt(cfg), device=gen.device)
    return p


def init_mlp(gen: torch.Generator, cfg: ModelConfig, lead: Tuple[int, ...] = ()) -> Params:
    d, ff = cfg.d_model, cfg.d_ff
    p = {
        "w1": _init(gen, lead + (d, ff), 1.0 / math.sqrt(d), pdt(cfg)),
        "w2": _init(gen, lead + (ff, d), 1.0 / math.sqrt(ff), pdt(cfg)),
    }
    if cfg.mlp_act == "swiglu":
        p["w3"] = _init(gen, lead + (d, ff), 1.0 / math.sqrt(d), pdt(cfg))
    if cfg.use_bias:  # the up and down projections' (a gated MLP's w3 has none)
        for name, n in (("b1", ff), ("b2", d)):
            p[name] = torch.zeros(lead + (n,), dtype=pdt(cfg), device=gen.device)
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
