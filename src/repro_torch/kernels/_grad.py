"""The guard of ``decode_attention``, the one kernel with no backward.

A decode step is a serving step: neither package differentiates it (the
JAX package has no backward for its decode kernel either), so the kernel
has none.  Its CUDA launch returns tensors with no ``grad_fn``, and inside
a graph that autograd records it would cut the gradient of ``wq``/``wk``/
``wv`` off silently.  The wrapper calls ``refuse_grad`` on its CUDA route, so
such a graph raises instead.  On a CPU tensor the wrapper computes its plain
version, through which autograd runs as usual.
"""
from __future__ import annotations

import torch

BACKWARD_ITEM = ("a decode step is serving, which neither package differentiates; train "
                 "through the forward (flash_attention), which has a backward kernel")


def refuse_grad(name: str, *tensors: torch.Tensor) -> None:
    """Raises when autograd is recording and any of ``tensors`` needs a
    gradient: the kernel ``name`` has no backward."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name}: the CUDA kernel has no backward, so a gradient through it would be "
            f"lost; run it under torch.no_grad(): {BACKWARD_ITEM}"
        )
