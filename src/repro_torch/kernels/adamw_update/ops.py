"""Public wrapper of the AdamW update kernel; which implementation serves a
call is the route rule's (``kernels._route``).

``adamw_update``: one AdamW step of one leaf, in place on p, m and v, with
the clip scale read from a 0-d f32 tensor on the leaf's device (no host
read): ``csrc/adamw.cu``, its plain version ``adamw_update_ref`` (JAX's
``upd`` in PyTorch ops).  Weight decay applies to a leaf of ``ndim >= 2``.
On a mesh each rank updates its own shards: the gradient is first laid out
as the leaf (a pending sum reduced), the moments must already be.  A call
that launches counts one in ``.launches``.
"""
from __future__ import annotations

import torch

from .. import _boundary, _route, _shape
from .kernel import DTYPES, adamw_update_launch
from .ref import adamw_update_ref


def _check(p, g, m, v, scale) -> None:
    """Raises on what the kernel does not take."""
    if g.shape != p.shape or m.shape != p.shape or v.shape != p.shape:
        raise ValueError(f"adamw_update: g, m and v must have the leaf's shape "
                         f"{tuple(p.shape)}; got {tuple(g.shape)}, {tuple(m.shape)}, "
                         f"{tuple(v.shape)}")
    if any(t.dtype not in DTYPES for t in (p, g, m)) or v.dtype != m.dtype:
        raise TypeError(f"adamw_update: p, g and the moments must each be one of "
                        f"{list(DTYPES)}, m and v in one dtype; got {p.dtype}, {g.dtype}, "
                        f"{m.dtype}, {v.dtype}")
    if scale.shape != () or scale.dtype != torch.float32:
        raise ValueError(f"adamw_update: the clip scale must be a 0-d f32 tensor; got "
                         f"{scale.dtype} {tuple(scale.shape)}")
    if len({t.device for t in (p, g, m, v, scale)}) != 1:
        raise ValueError("adamw_update: inputs on different devices")
    if not all(t.is_contiguous() for t in (p, g, m, v)):
        raise ValueError("adamw_update: p, g, m and v must be contiguous")


def adamw_update(
    p: torch.Tensor,  # the leaf, updated in place
    g: torch.Tensor,  # its gradient, p's shape
    m: torch.Tensor,  # first moment, updated in place
    v: torch.Tensor,  # second moment, m's dtype, updated in place
    scale: torch.Tensor,  # 0-d f32: the clip scale
    *, lr: float, b1: float, b2: float, eps: float, c1: float, c2: float,
    weight_decay: float,
) -> None:
    """One AdamW step of the leaf p, in place: the moments and the update in
    f32, each stored in its own dtype rounded to nearest.  ``lr``, ``c1``
    and ``c2`` are the step's learning rate and bias corrections.
    ``DTensor``s are taken local (``_boundary``)."""
    kw = dict(lr=lr, b1=b1, b2=b2, eps=eps, c1=c1, c2=c2, weight_decay=weight_decay)
    wd = weight_decay if p.dim() >= 2 else 0.0
    return _route.call(
        adamw_update, p, (g, m, v, scale), check=lambda: _check(p, g, m, v, scale),
        mixed="the leaf on the CPU but its gradient, moments or scale elsewhere",
        boundary=lambda: _boundary.adamw_update(adamw_update, p, g, m, v, scale, **kw),
        plain=lambda: adamw_update_ref(p, g, m, v, scale, **kw),
        device=lambda: _route.device(
            adamw_update, p,
            lambda: _shape.adamw_update(p, g, m, v, scale, lr, b1, b2, eps, c1, c2, wd),
            lambda: adamw_update_launch(p, g, m, v, scale, **{**kw, "weight_decay": wd})))
