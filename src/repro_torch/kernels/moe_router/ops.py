"""Public wrapper of the fused MoE-router kernel.

On a CUDA tensor it launches the hand-written Hopper kernel
(``csrc/moe_router.cu``: token blocks routed in parallel, then the prefix
of the earlier blocks' expert counts added to the slots; ``ref.
moe_router_blocked_model`` is its plain model) or raises; on a CPU tensor it
computes the plain version ``moe_router_ref``.  ``moe_router.launches``
counts calls that launched the kernel (its two launches count as one).
"""
from __future__ import annotations

from typing import Tuple

import torch

from .._grad import refuse_grad
from .kernel import MAX_EXPERTS, MAX_K, moe_router_fwd
from .ref import moe_router_ref


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


def moe_router(
    logits: torch.Tensor,  # (T, E) f32
    k: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(expert ids (T, k) int32, gates (T, k) f32, slots (T, k) int32).

    A (token, choice) is dropped under a capacity C iff ``slots >= C``; the
    caller applies C (the TPU kernel takes it only for parity of signature).
    """
    if logits.device.type == "cpu":
        return moe_router_ref(logits, k)
    if logits.device.type != "cuda":
        raise ValueError(f"moe_router: no kernel for device {logits.device}")
    refuse_grad("moe_router", logits)
    _check(logits, k)
    T = logits.shape[0]
    ids = torch.empty((T, k), dtype=torch.int32, device=logits.device)
    gates = torch.empty((T, k), dtype=torch.float32, device=logits.device)
    slots = torch.empty((T, k), dtype=torch.int32, device=logits.device)
    moe_router_fwd(logits, ids, gates, slots, k)
    moe_router.launches += 1
    return ids, gates, slots


moe_router.launches = 0
