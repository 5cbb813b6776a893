"""int8 gradient wire compression and a compressed sum over a mesh axis (twin
of the JAX package's ``repro/dist/compression.py``).

Per-tensor symmetric int8 quantization (scale = max|x| / 127).  Given a
``torch.Generator``, rounding is stochastic, floor(x/s + u) with u ~ U[0, 1),
which makes the dequantized value an unbiased estimator of x; without one,
``torch.round`` rounds to nearest (half to even, as ``jnp.round``), which
halves the worst-case error.

``compressed_psum`` is the wire story: each rank quantizes its local partial,
all-gathers the int8 codes and the f32 scales over one mesh dim's group
(4.06 bytes a element and rank on the wire against 4 for an f32 ring
all-reduce, but a payload term 4x smaller), then dequantizes and sums
locally, in rank order.  JAX computes all of this in plain ``jnp``, with no
Pallas kernel; this is its plain PyTorch counterpart.
"""
from __future__ import annotations

from typing import Any, Optional, Tuple

import torch

from ..bridge import flatten_with_paths, map_with_paths


def _scale_of(x32: torch.Tensor) -> torch.Tensor:
    s = x32.abs().max() / 127.0
    return torch.where(s > 0.0, s, torch.ones_like(s))


def quantize_int8(x: torch.Tensor, generator: Optional[torch.Generator] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x -> (int8 codes, f32 0-d scale).  Stochastic rounding iff
    ``generator`` (on ``x``'s device)."""
    x32 = x.float()
    s = _scale_of(x32)
    y = x32 / s
    if generator is not None:
        u = torch.rand(x32.shape, generator=generator, device=x32.device, dtype=torch.float32)
        y = torch.floor(y + u)
    else:
        y = torch.round(y)
    return y.clamp(-127, 127).to(torch.int8), s


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def compression_error_bound(x: torch.Tensor) -> float:
    """Worst-case |dq(q(x)) - x| (covers stochastic rounding; nearest
    rounding achieves half of this)."""
    return float(x.float().abs().max() / 127.0)


def quantize_tree(tree: Any, generator: Optional[torch.Generator] = None) -> Tuple[Any, Any]:
    """Quantize every leaf, in the tree's flattening order (one generator
    draws for all of them); returns (codes tree, scales tree)."""
    pairs = {k: quantize_int8(x, generator) for k, x in flatten_with_paths(tree)}
    return (map_with_paths(tree, lambda k, _: pairs[k][0]),
            map_with_paths(tree, lambda k, _: pairs[k][1]))


def dequantize_tree(qtree: Any, stree: Any) -> Any:
    scales = dict(flatten_with_paths(stree))
    return map_with_paths(qtree, lambda k, q: dequantize_int8(q, scales[k]))


def compressed_psum(x: torch.Tensor, mesh: Any, axis: str) -> torch.Tensor:
    """Sum ``x`` over mesh dim ``axis`` of a ``DeviceMesh`` with int8 wire
    compression: all-gather the codes and scales over that dim's group, then
    dequantize and reduce locally; every rank returns the same sum."""
    import torch.distributed as dist

    group = mesh.get_group(axis)
    n = dist.get_world_size(group)
    q, s = quantize_int8(x)
    gq = [torch.empty_like(q) for _ in range(n)]
    gs = [torch.empty_like(s) for _ in range(n)]
    dist.all_gather(gq, q.contiguous(), group=group)
    dist.all_gather(gs, s, group=group)
    scales = torch.stack(gs).reshape((-1,) + (1,) * x.ndim)
    return (torch.stack(gq).float() * scales).sum(dim=0)
