"""Plain PyTorch version of the fused MoE router.  Twin of
``repro/kernels/moe_router/ref.py``.

Softmax over experts, top-k by iterated argmax (``torch.argmax`` returns the
first maximal index, so ties go to the lower expert id, as ``lax.top_k`` and
the TPU kernel break them; ``torch.topk`` promises no order), gates
renormalised over the k winners.  Capacity slots are assigned token-major
over the flattened (T·k) choice list - the gshard exclusive cumsum of
``moe_ffn`` - so ``slot >= capacity`` means the (token, choice) is dropped.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F


def moe_router_ref(
    logits: torch.Tensor,  # (T, E)
    k: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    T, E = logits.shape
    probs = torch.softmax(logits.float(), dim=-1)
    rows = torch.arange(T, device=logits.device)
    ids, gates = [], []
    p = probs.clone()
    for _ in range(k):
        idx = torch.argmax(p, dim=-1)
        ids.append(idx)
        gates.append(p[rows, idx])
        p[rows, idx] = -1.0
    ids_t = torch.stack(ids, dim=1)  # (T, k)
    gates_t = torch.stack(gates, dim=1)
    gates_t = gates_t / torch.clamp(gates_t.sum(dim=1, keepdim=True), min=1e-9)
    return ids_t.to(torch.int32), gates_t, exclusive_slots(ids_t, E)


def exclusive_slots(ids: torch.Tensor, E: int) -> torch.Tensor:
    """Slot of each (token, choice) in its expert's queue: the exclusive
    cumsum of the one-hot choices over the token-major (T·k) list."""
    T, k = ids.shape
    flat = F.one_hot(ids.long(), E).reshape(T * k, E)
    pos = torch.cumsum(flat, dim=0) - flat
    return (pos * flat).sum(-1).reshape(T, k).to(torch.int32)


def moe_router_blocked_model(
    logits: torch.Tensor,  # (T, E)
    k: int,
    block_t: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain model of the kernel's decomposition (``csrc/moe_router.cu``):
    each block of ``block_t`` tokens is routed on its own and its slots
    counted within the block (``route_blocks``), then each choice's slot is
    raised by the exclusive prefix over the blocks of its expert's counts
    (``add_prefix``).  It must give ``moe_router_ref``'s result; only the
    CPU tests run it."""
    T, E = logits.shape
    ids, gates, slots, counts = [], [], [], []
    for t0 in range(0, T, block_t):
        i, g, s = moe_router_ref(logits[t0:t0 + block_t], k)
        ids.append(i)
        gates.append(g)
        slots.append(s)
        counts.append(torch.bincount(i.reshape(-1).long(), minlength=E))
    counts_t = torch.stack(counts)  # (blocks, E)
    base = torch.cumsum(counts_t, dim=0) - counts_t  # the earlier blocks' counts
    slots = [s + b[i.long()].to(torch.int32) for s, b, i in zip(slots, base, ids)]
    return torch.cat(ids), torch.cat(gates), torch.cat(slots)


def moe_router_bwd_ref(
    ids: torch.Tensor,  # (T, k) int
    gates: torch.Tensor,  # (T, k) f32, the forward's renormalised gates
    dgates: torch.Tensor,  # (T, k), the gradient of the gates
    E: int,
) -> torch.Tensor:
    """The gradient of the logits (T, E) f32 for the gates' gradient: the
    renormalised top-k of a softmax is a softmax over the k winning logits,
    so dlogits[t, ids[t, j]] = g_tj (dg_tj - sum_i g_ti dg_ti), and 0 at every
    other expert (ids and slots have no gradient; the forward's 1e-9 clamp
    never binds, since the winners' probabilities sum to at least k / E)."""
    g, dg = gates.float(), dgates.float()
    vals = g * (dg - (g * dg).sum(-1, keepdim=True))
    out = torch.zeros((ids.shape[0], E), dtype=torch.float32, device=ids.device)
    return out.scatter_(1, ids.long(), vals)
