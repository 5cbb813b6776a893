"""Public wrappers of the fused MoE-router kernels; which one serves a call is
the route rule's (``kernels._route``).

``moe_router``: ``csrc/moe_router.cu`` (token blocks routed in parallel,
then the prefix of the earlier blocks' expert counts added to the slots;
``ref.moe_router_blocked_model`` is its plain model), plain version
``moe_router_ref``, under autograd ``MoERouter``, whose backward is
``moe_router_bwd`` (the gates' gradient; ids and slots have none).

``moe_router_bwd``: ``route_bwd``, plain version ``moe_router_bwd_ref``.

``moe_router.launches`` counts calls that launched the forward (its two
launches count as one), ``moe_router_bwd.launches`` those of the backward.
"""
from __future__ import annotations

from typing import Tuple

import torch

from .. import _boundary, _route, _shape
from .kernel import MAX_EXPERTS, MAX_K, moe_router_bwd_launch, moe_router_fwd
from .ref import moe_router_bwd_ref, moe_router_ref


def _check(logits: torch.Tensor, k: int) -> None:
    if logits.dim() != 2:
        raise ValueError(f"moe_router: want logits (T, E); got {tuple(logits.shape)}")
    T, E = logits.shape
    if not 1 <= E <= MAX_EXPERTS or not 1 <= k <= min(E, MAX_K):
        raise ValueError(f"moe_router: want E <= {MAX_EXPERTS} and k <= min(E, {MAX_K}); "
                         f"got E={E}, k={k}")
    if logits.dtype != torch.float32:
        raise TypeError(f"moe_router: logits must be float32; got {logits.dtype}")
    if not logits.is_contiguous():
        raise ValueError("moe_router: logits must be contiguous")


def _forward(logits: torch.Tensor, k: int):
    _check(logits, k)

    def launch():
        T = logits.shape[0]
        ids = torch.empty((T, k), dtype=torch.int32, device=logits.device)
        gates = torch.empty((T, k), dtype=torch.float32, device=logits.device)
        slots = torch.empty((T, k), dtype=torch.int32, device=logits.device)
        moe_router_fwd(logits, ids, gates, slots, k)
        return ids, gates, slots

    return _route.device(moe_router, logits, lambda: _shape.moe_router(logits, k), launch)


class MoERouter(torch.autograd.Function):
    """The CUDA kernels under autograd: the forward saves ids and gates; the
    backward launches ``moe_router_bwd``."""

    @staticmethod
    def forward(ctx, logits, k):
        ids, gates, slots = _forward(logits, k)
        ctx.save_for_backward(ids, gates)
        ctx.num_experts = logits.shape[1]
        ctx.mark_non_differentiable(ids, slots)
        return ids, gates, slots

    @staticmethod
    def backward(ctx, _dids, dgates, _dslots):
        ids, gates = ctx.saved_tensors
        return moe_router_bwd(ids, gates, dgates.contiguous(), ctx.num_experts), None


def moe_router(
    logits: torch.Tensor,  # (T, E) f32
    k: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(expert ids (T, k) int32, gates (T, k) f32, slots (T, k) int32).

    A (token, choice) is dropped under a capacity C iff ``slots >= C``; the
    caller applies C (the TPU kernel takes it only for parity of signature).
    A ``DTensor`` is taken local whole on every rank (``_boundary``): the
    slots are a prefix over all T tokens and top-k reads every expert.
    """
    return _route.call(moe_router, logits,
                       boundary=lambda: _boundary.replicated(moe_router, (logits, k), 3),
                       plain=lambda: moe_router_ref(logits, k),
                       function=lambda: MoERouter.apply(logits, k),
                       device=lambda: _forward(logits, k))


def _backward(ids, gates, dgates, E) -> torch.Tensor:
    if ids.dim() != 2 or gates.shape != ids.shape or dgates.shape != ids.shape:
        raise ValueError(f"moe_router_bwd: want ids, gates, dgates (T, k); got "
                         f"{tuple(ids.shape)}, {tuple(gates.shape)}, {tuple(dgates.shape)}")
    T, k = ids.shape
    if not 1 <= E <= MAX_EXPERTS or not 1 <= k <= min(E, MAX_K):
        raise ValueError(f"moe_router_bwd: want E <= {MAX_EXPERTS} and k <= min(E, {MAX_K}); "
                         f"got E={E}, k={k}")
    if (ids.dtype != torch.int32 or gates.dtype != torch.float32
            or dgates.dtype != torch.float32):
        raise TypeError(f"moe_router_bwd: want int32 ids and float32 gates, dgates; got "
                        f"{ids.dtype}, {gates.dtype}, {dgates.dtype}")
    if not (ids.device == gates.device == dgates.device):
        raise ValueError("moe_router_bwd: inputs on different devices")
    if not all(t.is_contiguous() for t in (ids, gates, dgates)):
        raise ValueError("moe_router_bwd: ids, gates and dgates must be contiguous")

    def launch():
        dlogits = torch.empty((T, E), dtype=torch.float32, device=ids.device)
        moe_router_bwd_launch(ids, gates, dgates, dlogits)
        return dlogits

    return _route.device(moe_router_bwd, ids,
                         lambda: _shape.moe_router_bwd(ids, gates, dgates, E), launch)


def moe_router_bwd(
    ids: torch.Tensor,  # (T, k) int32
    gates: torch.Tensor,  # (T, k) f32, the forward's gates
    dgates: torch.Tensor,  # (T, k) f32, their gradient
    E: int,
) -> torch.Tensor:
    """The gradient of the logits, (T, E) f32, for the gates' gradient."""
    return _route.call(moe_router_bwd, ids, (gates, dgates),
                       mixed="ids on the CPU but gates elsewhere",
                       plain=lambda: moe_router_bwd_ref(ids, gates, dgates, E),
                       device=lambda: _backward(ids, gates, dgates, E))
