"""The kernels' shape-only route: what each kernel op returns on the
``meta`` device, and the scratch its CUDA launch allocates.

Each op is a ``torch.library.custom_op`` whose only implementation is its
fake one: on ``meta`` tensors it returns empty outputs of the kernel's
shapes and dtypes and computes no numbers, so it is no fallback (a CPU or
CUDA tensor never reaches it: the route rule, ``_route``, sends a CPU
tensor to the plain version and a CUDA tensor to the kernel).  The dry run
(``repro_torch.launch.dryrun``) builds a whole step on ``meta`` through
these ops, autograd's backward included.

Beside each fake, ``<op>_scratch`` names the buffers the op's CUDA launch
allocates around its kernels (the ``*_scratch`` of its ``kernel.py``); the
memory analysis (``launch.memory``) charges them while the op runs.  Decode's split workspace is persistent, not scratch
(``decode_workspace``, sized by the op's ``num_splits``, -1 for the card's
plan): one a device and stream, grown to the largest call's need.  The
FLOPs each op is charged are registered by ``repro_torch.launch.flops``.

This module keeps its annotations evaluated (no ``from __future__ import
annotations``): ``custom_op`` reads its schema from them.
"""
from typing import Optional, Tuple

import torch

from ._scratch import Scratch
from .adamw_update import kernel as adamw_kernel
from .causal_conv import kernel as conv_kernel
from .decode_attention import kernel as decode_kernel
from .flash_attention import kernel as flash_kernel
from .fused_augment import kernel as augment_kernel
from .moe_router import kernel as router_kernel
from .rms_norm import kernel as norm_kernel
from .ssd_scan import kernel as ssd_kernel

Tensor = torch.Tensor

def _refuse(name: str) -> RuntimeError:
    return RuntimeError(f"repro_torch::{name} is the shape-only route of a kernel; it takes "
                        "meta tensors only")


# --- flash attention ---------------------------------------------------------
@torch.library.custom_op("repro_torch::flash_attention_fwd", mutates_args=())
def flash_attention_fwd(q: Tensor, k: Tensor, v: Tensor, causal: bool, window: int,
                        q_offset: int, with_lse: bool) -> Tuple[Tensor, Tensor]:
    raise _refuse("flash_attention_fwd")


@flash_attention_fwd.register_fake
def _(q, k, v, causal, window, q_offset, with_lse):
    # the kernel writes the log-sum-exp only when autograd keeps it: without
    # it the op returns an empty one, as the CUDA route allocates none
    B, Sq, Hq, _ = q.shape
    lse = (B, Hq, Sq) if with_lse else (0,)
    return torch.empty_like(q), q.new_empty(lse, dtype=torch.float32)


def flash_attention_fwd_scratch(q, k, v, causal, window, q_offset, with_lse):
    B, Sq, Hq, D = q.shape
    return flash_kernel.fwd_scratch(B, Sq, k.shape[1], Hq, D, q.dtype)


@torch.library.custom_op("repro_torch::flash_attention_bwd", mutates_args=())
def flash_attention_bwd(q: Tensor, k: Tensor, v: Tensor, o: Tensor, lse: Tensor, do: Tensor,
                        causal: bool, window: int, q_offset: int) -> Tuple[Tensor, Tensor, Tensor]:
    raise _refuse("flash_attention_bwd")


@flash_attention_bwd.register_fake
def _(q, k, v, o, lse, do, causal, window, q_offset):
    return torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)


def flash_attention_bwd_scratch(q, k, v, o, lse, do, causal, window, q_offset):
    B, Sq, Hq, D = q.shape
    return flash_kernel.bwd_scratch(B, Sq, k.shape[1], Hq, D, q.dtype)


# --- decode attention ----------------------------------------------------------
@torch.library.custom_op("repro_torch::decode_attention", mutates_args=())
def decode_attention(q: Tensor, k_cache: Tensor, v_cache: Tensor, lengths: Tensor,
                     window: int, num_splits: int) -> Tensor:
    raise _refuse("decode_attention")


@decode_attention.register_fake
def _(q, k_cache, v_cache, lengths, window, num_splits):
    return torch.empty_like(q)


def decode_workspace(q, k_cache, v_cache, lengths, window, num_splits, *, sms: int) -> Scratch:
    """The split workspace a decode call needs (``num_splits`` -1: the
    card's plan over ``sms`` SMs)."""
    from .decode_attention.ops import plan

    B, Hq, D = q.shape
    S, Hkv = k_cache.shape[1], k_cache.shape[2]
    rows, ns = plan(q.dtype, B, S, Hq, Hkv, None if num_splits < 0 else num_splits, sms)
    return decode_kernel.workspace_scratch(B, Hq, Hkv, D, rows, ns)


# --- SSD scan ------------------------------------------------------------------
@torch.library.custom_op("repro_torch::ssd_scan", mutates_args=())
def ssd_scan(x: Tensor, dt: Tensor, a: Tensor, Bm: Tensor, Cm: Tensor, D: Tensor,
             chunk: int) -> Tuple[Tensor, Tensor]:
    raise _refuse("ssd_scan")


@ssd_scan.register_fake
def _(x, dt, a, Bm, Cm, D, chunk):
    Bsz, _, H, P = x.shape
    return torch.empty_like(x), x.new_empty((Bsz, H, Bm.shape[3], P), dtype=torch.float32)


def ssd_scan_scratch(x, dt, a, Bm, Cm, D, chunk):
    Bsz, L, H, P = x.shape
    return ssd_kernel.fwd_scratch(Bsz, L, H, P, Bm.shape[3], chunk, x.dtype)


@torch.library.custom_op("repro_torch::ssd_scan_bwd", mutates_args=())
def ssd_scan_bwd(x: Tensor, dt: Tensor, a: Tensor, Bm: Tensor, Cm: Tensor, D: Tensor,
                 dy: Tensor, dh_final: Optional[Tensor]
                 ) -> Tuple[Tensor, Tensor, Tensor, Tensor, Tensor, Tensor]:
    raise _refuse("ssd_scan_bwd")


@ssd_scan_bwd.register_fake
def _(x, dt, a, Bm, Cm, D, dy, dh_final):
    f32 = dict(dtype=torch.float32)
    H = x.shape[2]
    return (torch.empty_like(x), dt.new_empty(dt.shape, **f32), a.new_empty((H,), **f32),
            torch.empty_like(Bm), torch.empty_like(Cm), a.new_empty((H,), **f32))


def ssd_scan_bwd_scratch(x, dt, a, Bm, Cm, D, dy, dh_final):
    Bsz, L, H, P = x.shape
    return ssd_kernel.bwd_scratch(Bsz, L, H, Bm.shape[2], P, Bm.shape[3], x.dtype)


# --- causal conv ---------------------------------------------------------------
@torch.library.custom_op("repro_torch::causal_conv", mutates_args=())
def causal_conv(xbc: Tensor, w: Tensor, b: Tensor, d_inner: int) -> Tuple[Tensor, Tensor, Tensor]:
    raise _refuse("causal_conv")


@causal_conv.register_fake
def _(xbc, w, b, d_inner):
    Bsz, L, Ch = xbc.shape
    gn = (Ch - d_inner) // 2
    dt = torch.promote_types(xbc.dtype, w.dtype)
    return (xbc.new_empty((Bsz, L, d_inner), dtype=dt), xbc.new_empty((Bsz, L, gn), dtype=dt),
            xbc.new_empty((Bsz, L, gn), dtype=dt))


def causal_conv_scratch(xbc, w, b, d_inner):
    return conv_kernel.fwd_scratch(*xbc.shape)


@torch.library.custom_op("repro_torch::causal_conv_bwd", mutates_args=())
def causal_conv_bwd(xbc: Tensor, w: Tensor, b: Tensor, dxs: Tensor, dB: Tensor,
                    dC: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
    raise _refuse("causal_conv_bwd")


@causal_conv_bwd.register_fake
def _(xbc, w, b, dxs, dB, dC):
    return (xbc.new_empty(xbc.shape), torch.empty_like(w, memory_format=torch.contiguous_format),
            torch.empty_like(b, memory_format=torch.contiguous_format))


def causal_conv_bwd_scratch(xbc, w, b, dxs, dB, dC):
    return conv_kernel.bwd_scratch(*xbc.shape)


# --- RMSNorm ------------------------------------------------------------------
@torch.library.custom_op("repro_torch::rms_norm", mutates_args=())
def rms_norm(x: Tensor, w: Tensor, gate: Optional[Tensor], eps: float) -> Tuple[Tensor, Tensor]:
    raise _refuse("rms_norm")


@rms_norm.register_fake
def _(x, w, gate, eps):
    out = (x if gate is None else gate).dtype
    return (x.new_empty(x.shape, dtype=out),
            x.new_empty((x.numel() // x.shape[-1],), dtype=torch.float32))


def rms_norm_scratch(x, w, gate, eps):
    return norm_kernel.fwd_scratch(x.numel() // x.shape[-1], x.shape[-1])


@torch.library.custom_op("repro_torch::rms_norm_bwd", mutates_args=())
def rms_norm_bwd_op(x: Tensor, w: Tensor, rstd: Tensor, dout: Tensor,
                    gate: Optional[Tensor]) -> Tuple[Tensor, Tensor, Tensor]:
    raise _refuse("rms_norm_bwd")


@rms_norm_bwd_op.register_fake
def _(x, w, rstd, dout, gate):
    # the plain form has no gate: its gradient is an empty stand-in
    dz = (0,) if gate is None else gate.shape
    return (x.new_empty(x.shape), torch.empty_like(w, memory_format=torch.contiguous_format),
            x.new_empty(dz, dtype=(x if gate is None else gate).dtype))


def rms_norm_bwd_scratch(x, w, rstd, dout, gate):
    return norm_kernel.bwd_scratch(x.numel() // x.shape[-1], x.shape[-1])


def rms_norm_bwd(x: Tensor, w: Tensor, rstd: Tensor, dout: Tensor,
                 gate: Optional[Tensor]) -> Tuple[Tensor, Tensor, Optional[Tensor]]:
    """(dx, dw, dgate) of the shape-only backward, dgate None without a gate."""
    dx, dw, dz = rms_norm_bwd_op(x, w, rstd, dout, gate)
    return dx, dw, None if gate is None else dz


# --- MoE router ----------------------------------------------------------------
@torch.library.custom_op("repro_torch::moe_router", mutates_args=())
def moe_router(logits: Tensor, k: int) -> Tuple[Tensor, Tensor, Tensor]:
    raise _refuse("moe_router")


@moe_router.register_fake
def _(logits, k):
    T = logits.shape[0]
    return (logits.new_empty((T, k), dtype=torch.int32),
            logits.new_empty((T, k), dtype=torch.float32),
            logits.new_empty((T, k), dtype=torch.int32))


def moe_router_scratch(logits, k):
    return router_kernel.fwd_scratch(*logits.shape)


@torch.library.custom_op("repro_torch::moe_router_bwd", mutates_args=())
def moe_router_bwd(ids: Tensor, gates: Tensor, dgates: Tensor, E: int) -> Tensor:
    raise _refuse("moe_router_bwd")


@moe_router_bwd.register_fake
def _(ids, gates, dgates, E):
    return gates.new_empty((ids.shape[0], E), dtype=torch.float32)


def moe_router_bwd_scratch(ids, gates, dgates, E):
    return router_kernel.bwd_scratch(ids.shape[0], E, ids.shape[1])


# --- fused augment ---------------------------------------------------------------
@torch.library.custom_op("repro_torch::fused_augment", mutates_args=())
def fused_augment(images: Tensor, crops: Tensor, flips: Tensor, mean: Tensor, std: Tensor,
                  out_h: int, out_w: int) -> Tensor:
    raise _refuse("fused_augment")


@fused_augment.register_fake
def _(images, crops, flips, mean, std, out_h, out_w):
    B, _, _, C = images.shape
    return mean.new_empty((B, out_h, out_w, C), dtype=torch.float32)


def fused_augment_scratch(images, crops, flips, mean, std, out_h, out_w):
    return augment_kernel.fwd_scratch(*images.shape, out_h, out_w)


# --- AdamW update -----------------------------------------------------------------
@torch.library.custom_op("repro_torch::adamw_update", mutates_args=("p", "m", "v"))
def adamw_update(p: Tensor, g: Tensor, m: Tensor, v: Tensor, scale: Tensor, lr: float,
                 b1: float, b2: float, eps: float, c1: float, c2: float,
                 weight_decay: float) -> None:
    raise _refuse("adamw_update")


@adamw_update.register_fake
def _(p, g, m, v, scale, lr, b1, b2, eps, c1, c2, weight_decay):
    # in place: p, m and v are its outputs, and it allocates nothing
    return None


def adamw_update_scratch(p, g, m, v, scale, lr, b1, b2, eps, c1, c2, weight_decay):
    return adamw_kernel.update_scratch(p.numel())
