"""The guard of the kernels that have no backward.

``decode_attention``, ``ssd_scan`` and ``moe_router`` return tensors with no
``grad_fn``: a CUDA launch inside a graph that autograd records would cut
the gradient off silently (``wq``/``wk``/``wv`` of a decode step, the router
weights behind the gates, the SSM leaves behind the scan).  Their wrappers
call ``refuse_grad`` on the CUDA route, so training such a path on the card
raises instead.  On a CPU tensor every wrapper computes its plain version,
through which autograd runs as usual.
"""
from __future__ import annotations

import torch

BACKWARD_ITEM = "ROADMAP queue 1, item 1 (backward kernels for ssd_scan and moe_router)"


def refuse_grad(name: str, *tensors: torch.Tensor) -> None:
    """Raises when autograd is recording and any of ``tensors`` needs a
    gradient: the kernel ``name`` has no backward."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name}: the CUDA kernel has no backward, so a gradient through it would be "
            f"lost; run it under torch.no_grad() (serving), or train on the CPU route until "
            f"{BACKWARD_ITEM} lands"
        )
