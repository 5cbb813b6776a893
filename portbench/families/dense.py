"""Plain reference of the dense decoder (starcoder2-3b's family): per layer a
norm, grouped-query attention with rotary positions under a causal mask and
an optional sliding window, a residual add, a second norm, the MLP and a
residual add; a final norm and the head.  StarCoder2's published block
(arXiv:2402.19173; Hugging Face ``Starcoder2DecoderLayer``):

    h = LN1(x);  q = h Wq + bq,  k = h Wk + bk,  v = h Wv + bv  (rotary on q, k)
    x = x + softmax(q k^T / sqrt(D) under the mask) v Wo + bo
    x = x + gelu_tanh(LN2(x) W1 + b1) W2 + b2

with LayerNorm(x) = (x - mean) / sqrt(var + eps) * w + b.  The model file
picks the block: ``norm_type`` "layer" (LayerNorm) or "rms" (RMSNorm, no
shift), ``use_bias``, ``tie_embeddings``; the MLP is GELU's (tanh form).
The window counts W keys including the query's own: key j is seen from
query i when i - W < j <= i.

Float32 with TF32 off (``bench/reference.py``), each layer recomputed in
the backward, and the attention computed in blocks of ``QBLOCK`` queries
over the keys the block can see, each block recomputed in the backward,
so that 8192 positions fit beside the f32 weights, gradients and AdamW
state.

The controls.  ``precision="fp8"`` is ``bench/reference.py``'s e4m3
control; here it also rounds the attention's q, k, v and probabilities to
e4m3.  The harness passes the SSD family's names for the two controls of
a family's own kernel (``limits.py``: ``ssd_tf32`` and ``ssd_bf16`` to the
loss, ``tf32`` and ``bf16`` to ``kernel_reference``).  Attention's products
are stated in bf16 (bf16 operands, f32 softmax and accumulation), so each
name stands for a control one step below that, everything else in f32:

    "tf32" / "ssd_tf32"   the probabilities rounded to e4m3 before P V (as
                          an fp8 attention keeps P)
    "bf16" / "ssd_bf16"   q, k, v and the probabilities all in e4m3
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from portbench.bench import flash_flops as FF
from portbench.bench.reference import layer_checkpoint, lm_loss, mm, rounded

# The program's call whose output the check reads at the timed size: its
# first flash call of the first set-up step (layer 0's forward), as
# (module, name); ``kernel_reference`` works it out again from its inputs.
KERNEL_CALL = ("repro_torch.models.layers", "flash_attention")
KERNEL_NUMBER = "flash_gap"
QBLOCK = 512  # queries of one attention block
# what each control name rounds to e4m3 in the attention (module docstring)
LOWERED = {"fp8": ("qkv", "p"), "tf32": ("p",), "ssd_tf32": ("p",), "bf16": ("qkv", "p"),
           "ssd_bf16": ("qkv", "p")}


def _block_norm(m: Dict[str, Any]) -> bool:
    return m.get("norm_type", "rms") == "layer"


def layer_leaves(m: Dict[str, Any]) -> List[Tuple[str, Tuple[int, ...]]]:
    """(name under the layer, shape of one layer) of every leaf of a block,
    in the order ``_layer`` takes them."""
    d, ff = m["d_model"], m["d_ff"]
    D = m.get("head_dim") or d // m["num_heads"]
    qd, kvd = m["num_heads"] * D, m["num_kv_heads"] * D
    bias, ln = m.get("use_bias", False), _block_norm(m)
    out = [("ln1", (d,))] + ([("ln1_bias", (d,))] if ln else [])
    for w, shape in (("wq", (d, qd)), ("wk", (d, kvd)), ("wv", (d, kvd)), ("wo", (qd, d))):
        out.append((f"attn/{w}", shape))
        if bias:
            out.append((f"attn/b{w[1:]}", shape[-1:]))
    out += [("ln2", (d,))] + ([("ln2_bias", (d,))] if ln else [])
    if m["mlp_act"] != "gelu":
        raise ValueError(f"the dense reference's MLP is GELU's; got {m['mlp_act']!r}")
    for w, shape in (("w1", (d, ff)), ("w2", (ff, d))):
        out.append((f"mlp/{w}", shape))
        if bias:
            out.append((f"mlp/b{w[1:]}", shape[-1:]))
    return out


def leaf_shapes(m: Dict[str, Any]) -> List[Tuple[str, Tuple[int, ...], bool]]:
    """The port's tree: one group of ``num_layers`` repeats of the block, each
    leaf stacked over the layers (a tree of one layer keeps its leaves
    unstacked)."""
    L, d, V = m["num_layers"], m["d_model"], m["vocab_size"]
    out = [("embed", (V, d), False), ("final_norm", (d,), False)]
    if _block_norm(m):
        out.append(("final_norm_bias", (d,), False))
    if not m.get("tie_embeddings"):
        out.append(("lm_head", (d, V), False))
    lead = (L,) if L > 1 else ()
    return out + [(f"group0/0/{k}", lead + shape, L > 1) for k, shape in layer_leaves(m)]


def init_rules(m: Dict[str, Any]) -> Dict[str, Tuple]:
    """StarCoder2's published initialisation (Hugging Face's
    ``_init_weights``): every matrix and the embedding normal with std
    ``initializer_range``.  Departure: the biases and the LayerNorm shifts
    are drawn normal with std ``bias_std``, not zero, and the norm scales
    ``exp(0.9)`` to ``exp(1.1)`` through the "a_log" rule (the log of a
    uniform draw: 0.9 to 1.1), not one, so that a program that drops one of
    them computes another function from the first step."""
    std, b = m["initializer_range"], m["bias_std"]
    rules = {k: ("normal", std) for k in ("embed", "lm_head", "wq", "wk", "wv", "wo", "w1",
                                          "w2")}
    rules.update({k: ("normal", b) for k in ("bq", "bk", "bv", "bo", "b1", "b2", "ln1_bias",
                                             "ln2_bias", "final_norm_bias")})
    rules.update({k: ("a_log", math.exp(0.9), math.exp(1.1))
                  for k in ("ln1", "ln2", "final_norm")})
    return rules


def norm(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor], eps: float
         ) -> torch.Tensor:
    """LayerNorm with the shift ``b``, or RMSNorm where ``b`` is None."""
    if b is None:
        return x * torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + eps) * w
    mu = x.mean(dim=-1, keepdim=True)
    var = ((x - mu) * (x - mu)).mean(dim=-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * w + b


def rotary(x: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary positions 0..S-1 on x (B, S, H, D), Hugging Face's
    ``rotate_half`` form: x cos + rotate_half(x) sin over the two halves."""
    S, D = x.shape[1], x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, D, 2, dtype=torch.float32, device=x.device) / D)
    ang = torch.arange(S, dtype=torch.float32, device=x.device)[:, None] * inv[None, :]
    cos = torch.cat([ang.cos(), ang.cos()], dim=-1)[None, :, None, :]
    sin = torch.cat([ang.sin(), ang.sin()], dim=-1)[None, :, None, :]
    half = torch.cat([-x[..., D // 2:], x[..., :D // 2]], dim=-1)
    return x * cos + half * sin


def _attend_block(q, k, v, q0: int, k0: int, window: int, lowered: Tuple[str, ...]):
    """Queries q0.. (q (B, Sq, Hq, D)) over keys k0.. (k, v (B, Sk, Hkv, D))."""
    B, Sq, Hq, D = q.shape
    Hkv = k.shape[2]
    qg = q.reshape(B, Sq, Hkv, Hq // Hkv, D)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k) / math.sqrt(D)
    qp = q0 + torch.arange(Sq, device=q.device)[:, None]
    kp = k0 + torch.arange(k.shape[1], device=q.device)[None, :]
    seen = kp <= qp
    if window > 0:
        seen = seen & (kp > qp - window)
    p = torch.softmax(s.masked_fill(~seen, -math.inf), dim=-1)
    if "p" in lowered:
        p = rounded(p, "fp8")
    return torch.einsum("bhgqk,bkhd->bqhgd", p, v).reshape(B, Sq, Hq, D)


def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, window: int,
           lowered: Tuple[str, ...] = ()) -> torch.Tensor:
    """Causal attention of q (B, S, Hq, D) over k, v (B, S, Hkv, D) under the
    window, in blocks of ``QBLOCK`` queries over the keys each can see; with
    grad each block is recomputed in the backward."""
    if "qkv" in lowered:
        q, k, v = (rounded(t, "fp8") for t in (q, k, v))
    S = q.shape[1]
    outs = []
    for a in range(0, S, QBLOCK):
        b = min(S, a + QBLOCK)
        k0 = max(0, a - window + 1) if window > 0 else 0
        args = (q[:, a:b], k[:, k0:b], v[:, k0:b], a, k0, window, lowered)
        outs.append(checkpoint(_attend_block, *args, use_reentrant=False)
                    if torch.is_grad_enabled() else _attend_block(*args))
    return torch.cat(outs, dim=1)


def kernel_reference(args, lower: Optional[str] = None) -> torch.Tensor:
    """The flash call ``flash_attention(q, k, v, causal, window, softcap)``
    worked out again in f32 from its inputs: (B, S, Hq, D).  ``lower``
    ("tf32" or "bf16") is one of the controls of the module docstring."""
    q, k, v, causal, window, softcap = args[:6]
    if not causal or softcap:
        raise ValueError(f"the dense reference attends causally without a softcap; "
                         f"got causal={causal}, softcap={softcap}")
    with torch.no_grad():
        return attend(q.float(), k.float(), v.float(), window, LOWERED.get(lower, ()))


def _layer(x, *leaves, m, precision):
    w = dict(zip([name for name, _ in layer_leaves(m)], leaves))
    B, S, _ = x.shape
    D = m.get("head_dim") or m["d_model"] // m["num_heads"]
    eps = m.get("norm_eps", 1e-6)
    lowered = LOWERED.get(precision, ())

    def linear(h, name):
        y = mm(h, w[name], precision)
        bias = w.get(name.replace("/w", "/b"))
        return y if bias is None else y + bias

    h = norm(x, w["ln1"], w.get("ln1_bias"), eps)
    q = linear(h, "attn/wq").reshape(B, S, m["num_heads"], D)
    k = linear(h, "attn/wk").reshape(B, S, m["num_kv_heads"], D)
    v = linear(h, "attn/wv").reshape(B, S, m["num_kv_heads"], D)
    theta = m.get("rope_theta", 10_000.0)
    o = attend(rotary(q, theta), rotary(k, theta), v, m.get("attn_window", 0), lowered)
    x = x + linear(rounded(o.reshape(B, S, -1), precision), "attn/wo")
    h = norm(x, w["ln2"], w.get("ln2_bias"), eps)
    return x + linear(F.gelu(linear(h, "mlp/w1"), approximate="tanh"), "mlp/w2")


def loss(P: Dict[str, Any], tokens, labels, m: Dict[str, Any], z: float, precision: str,
         mask) -> torch.Tensor:
    x = rounded(P["embed"][tokens], precision)
    names = [f"group0/0/{name}" for name, _ in layer_leaves(m)]
    L = m["num_layers"]
    for i in range(L):
        layer = [P[n][i] if L > 1 else P[n] for n in names]
        x = rounded(layer_checkpoint(lambda x, *w: _layer(x, *w, m=m, precision=precision), x,
                                     *layer), precision)
    x = norm(x, P["final_norm"], P.get("final_norm_bias"), m.get("norm_eps", 1e-6))
    head = P["embed"].T if m.get("tie_embeddings") else P["lm_head"]
    return lm_loss(x, head, labels, mask, z, precision)


def matmul_params(m: Dict[str, Any]) -> int:
    """Every layer's projections and MLP matrices and the head (the tied
    embedding read as a matmul); no bias or norm."""
    return sum(math.prod(shape) for name, shape in layer_leaves(m)
               if "/w" in name) * m["num_layers"] + m["d_model"] * m["vocab_size"]


def model_flops(m: Dict[str, Any], B: int, S: int) -> float:
    """6 N T for the matmuls, plus each layer's attention over its visible
    (query, key) pairs, forward and backward once (nothing recomputed)."""
    D = m.get("head_dim") or m["d_model"] // m["num_heads"]
    attn = sum(FF.flash_flops(B, S, S, m["num_heads"], D, True, m.get("attn_window", 0),
                              backward=bwd) for bwd in (False, True))
    return 6.0 * matmul_params(m) * B * S + m["num_layers"] * attn
