"""Plain reference of the Mamba-2 decoder (mamba2-2.7b's family): per layer
RMSNorm, the input projection to (z, x, B, C, dt), a depthwise causal
convolution of width 4 over (x, B, C) and SiLU, dt = softplus(dt + dt_bias),
A = -exp(A_log), the SSD recurrence

    h_t = exp(dt_t A) h_{t-1} + dt_t B_t x_t^T,   y_t = C_t h_t + D x_t,

computed by chunks (the state-space dual form), the gated RMSNorm of y by
SiLU(z) and the output projection; the head is tied to the embedding.
Float32, each layer recomputed in the backward.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from portbench.bench import flops as FL
from portbench.bench.reference import (layer_checkpoint, lm_loss, lowered_einsum, mm, rms_norm,
                                       rounded)

# The program's call whose output the check reads at the timed size: its
# first SSD call of the first set-up step (layer 0's forward), as
# (module, name); ``kernel_reference`` works the call out again from its
# inputs, and ``KERNEL_NUMBER`` is the number that compares the two.
KERNEL_CALL = ("repro_torch.models.layers", "ssd_scan")
KERNEL_NUMBER = "ssd_gap"
LAYER = ("ln1", "ssm/in_proj", "ssm/conv_w", "ssm/conv_b", "ssm/A_log", "ssm/D", "ssm/dt_bias",
         "ssm/norm_w", "ssm/out_proj")
CONV = 4
CHUNK = 128  # the reference's own chunk; any chunk gives the same function


def dims(m: Dict[str, Any]) -> Tuple[int, int, int, int, int]:
    """(d_inner, heads, head dim P, state N, groups G)."""
    di = m["ssm_expand"] * m["d_model"]
    return di, di // m["ssm_head_dim"], m["ssm_head_dim"], m["ssm_state"], m["ssm_groups"]


def init_rules(m: Dict[str, Any]) -> Dict[str, Tuple]:
    """Mamba-2's published initialisation (``mamba_ssm``'s), normals at the
    std of its uniform draws: projections kaiming-uniform (std 1/sqrt(3
    fan-in)), the output projection further over sqrt(layers) (the prenorm
    residual rescaling), the depthwise convolution's weight and bias std
    1/sqrt(3 x 4), dt log-uniform in [1e-3, 1e-1] through dt_bias, A uniform
    in [1, 16], D and the norm scales 1, the (tied) embedding std 0.02."""
    s3 = 1.0 / math.sqrt(3.0)
    return {"embed": ("normal", 0.02), "lm_head": ("normal", 0.02), "final_norm": ("ones",),
            "ln1": ("ones",), "in_proj": ("fan_in", s3),
            "out_proj": ("fan_in", s3 / math.sqrt(m["num_layers"])),
            "conv_w": ("normal", 0.5 * s3), "conv_b": ("normal", 0.5 * s3),
            "A_log": ("a_log", 1.0, 16.0), "D": ("ones",), "dt_bias": ("dt_bias", 1e-3, 0.1),
            "norm_w": ("ones",)}


def leaf_shapes(m: Dict[str, Any]) -> List[Tuple[str, Tuple[int, ...], bool]]:
    L, d, V = m["num_layers"], m["d_model"], m["vocab_size"]
    di, H, P, N, G = dims(m)
    ch = di + 2 * G * N
    per = {"ln1": (d,), "ssm/in_proj": (d, 2 * di + 2 * G * N + H), "ssm/conv_w": (CONV, ch),
           "ssm/conv_b": (ch,), "ssm/A_log": (H,), "ssm/D": (H,), "ssm/dt_bias": (H,),
           "ssm/norm_w": (di,), "ssm/out_proj": (di, d)}
    out = [("embed", (V, d), False), ("final_norm", (d,), False)]
    if not m.get("tie_embeddings"):
        out.append(("lm_head", (d, V), False))
    return out + [(f"group0/0/{k}", (L,) + per[k], True) for k in LAYER]


def segsum(x: torch.Tensor) -> torch.Tensor:
    """out[..., i, j] = x[..., j+1] + ... + x[..., i] for j <= i, else -inf;
    summed directly, not as a difference of cumulative sums."""
    Q = x.shape[-1]
    xx = x[..., None].expand(*x.shape, Q)
    below = torch.tril(torch.ones(Q, Q, dtype=torch.bool, device=x.device), diagonal=-1)
    out = torch.cumsum(xx.masked_fill(~below, 0.0), dim=-2)
    keep = torch.tril(torch.ones(Q, Q, dtype=torch.bool, device=x.device))
    return out.masked_fill(~keep, -torch.inf)


def ssd(x, dt, A, Bm, Cm, chunk: int = CHUNK, lower: Optional[str] = None) -> torch.Tensor:
    """y (b, l, h, p) of the recurrence without the D term.  x (b, l, h, p),
    dt (b, l, h), A (h,), Bm and Cm (b, l, g, n); l a multiple of chunk.
    ``lower`` ("tf32" or "bf16") rounds the products' operands and gradients
    (a control)."""
    b, l, h, p = x.shape
    g = Bm.shape[2]
    c = l // chunk
    Bh = Bm.repeat_interleave(h // g, dim=2).reshape(b, c, chunk, h, -1)
    Ch = Cm.repeat_interleave(h // g, dim=2).reshape(b, c, chunk, h, -1)
    X = (x * dt[..., None]).reshape(b, c, chunk, h, p)
    Adt = (dt * A).reshape(b, c, chunk, h).permute(0, 3, 1, 2)  # (b, h, c, q)
    A_cum = torch.cumsum(Adt, dim=-1)
    Lm = torch.exp(segsum(Adt))  # (b, h, c, q, q)
    y_diag = lowered_einsum("bclhn,bcshn,bhcls,bcshp->bclhp", Ch, Bh, Lm, X, mode=lower)
    decay = torch.exp(A_cum[..., -1:] - A_cum)
    states = lowered_einsum("bclhn,bhcl,bclhp->bchpn", Bh, decay, X, mode=lower)
    states = torch.cat([torch.zeros_like(states[:, :1]), states], dim=1)
    chunk_decay = torch.exp(segsum(F.pad(A_cum[..., -1], (1, 0))))  # (b, h, c+1, c+1)
    states = lowered_einsum("bhzc,bchpn->bzhpn", chunk_decay, states, mode=lower)[:, :-1]
    y_off = lowered_einsum("bclhn,bchpn,bhcl->bclhp", Ch, states, torch.exp(A_cum), mode=lower)
    return (y_diag + y_off).reshape(b, l, h, p)


def kernel_reference(args, lower: Optional[str] = None) -> torch.Tensor:
    """The SSD call ``ssd_scan(x, dt, a, B, C, D, chunk=...)`` worked out again
    in f32 from its inputs: y (b, l, h, p) with the D term.  ``lower`` rounds
    the products as the SSD controls do."""
    x, dt, a, Bm, Cm, D = (t.float() for t in args[:6])
    pad = -x.shape[1] % CHUNK

    def padded(t):
        return F.pad(t, (0, 0) * (t.dim() - 2) + (0, pad)) if pad else t

    y = ssd(padded(x), padded(dt), a, padded(Bm), padded(Cm), lower=lower)[:, :x.shape[1]]
    return y + x * D[:, None]


def causal_conv(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """Depthwise causal convolution: out[t] = sum_i x[t - K + 1 + i] w[i] + b."""
    K, L = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, K - 1, 0))
    return sum(xp[:, i:i + L] * w[i] for i in range(K)) + bias


def _layer(x, ln1, in_proj, conv_w, conv_b, A_log, D, dt_bias, norm_w, out_proj, m, precision):
    B, L, _ = x.shape
    di, H, P, N, G = dims(m)
    eps = m["norm_eps"]
    zxbcdt = mm(rms_norm(x, ln1, eps), in_proj, precision)
    z, xs, Bc, Cc, dt = torch.split(zxbcdt, [di, di, G * N, G * N, H], dim=-1)
    xbc = F.silu(causal_conv(torch.cat([xs, Bc, Cc], dim=-1), conv_w, conv_b))
    xs, Bc, Cc = torch.split(xbc, [di, G * N, G * N], dim=-1)
    dt = F.softplus(dt + dt_bias)
    xh = xs.reshape(B, L, H, P)
    pad = -L % CHUNK
    lower = precision[len("ssd_"):] if precision.startswith("ssd_") else None
    y = ssd(*(F.pad(t, (0, 0) * (t.dim() - 2) + (0, pad)) if pad else t
              for t in (xh, dt)), -torch.exp(A_log),
            *(F.pad(t.reshape(B, L, G, N), (0, 0, 0, 0, 0, pad)) for t in (Bc, Cc)),
            lower=lower)[:, :L]
    y = rounded((y + xh * D[:, None]).reshape(B, L, di), precision)
    y = rms_norm(y * F.silu(z), norm_w, eps)
    return x + mm(y, out_proj, precision)


def loss(P: Dict[str, Any], tokens, labels, m: Dict[str, Any], z: float, precision: str,
         mask) -> torch.Tensor:
    x = rounded(P["embed"][tokens], precision)
    layers = [P[f"group0/0/{k}"] for k in LAYER]
    for i in range(m["num_layers"]):
        x = rounded(layer_checkpoint(lambda x, *w: _layer(x, *w, m, precision), x,
                                     *(leaf[i] for leaf in layers)), precision)
    x = rms_norm(x, P["final_norm"], m["norm_eps"])
    head = P["embed"].T if m.get("tie_embeddings") else P["lm_head"]
    return lm_loss(x, head, labels, mask, z, precision)


def matmul_params(m: Dict[str, Any]) -> int:
    """The in and out projections of every layer and the head (the tied
    embedding read as a matmul); not the depthwise convolution."""
    d = m["d_model"]
    di, H, _, N, G = dims(m)
    return m["num_layers"] * (d * (2 * di + 2 * G * N + H) + di * d) + d * m["vocab_size"]


def model_flops(m: Dict[str, Any], B: int, S: int) -> float:
    """6 N T for the matmuls, plus the SSD's forward (at the configuration's
    chunk) and its backward without the recomputed forward chunk state, once
    a layer."""
    di, H, P, N, G = dims(m)
    bwd = FL.ssd_bwd_product_flops(B, S, H, P, N, 64, G)
    ssd_work = (FL.ssd_flops(B, S, H, P, N, m["ssm_chunk"], G)
                + sum(bwd.values()) - bwd["state"] / 5)
    return 6.0 * matmul_params(m) * B * S + m["num_layers"] * ssd_work
