"""The kernel layer's route rule: which implementation serves a call.

Each wrapper in ``<kernel>/ops.py`` keeps its checks, its plain version, its
launch and its ``torch.autograd.Function``, and hands the decision here:

* a ``DTensor`` goes to the wrapper's boundary (``_boundary``), which calls
  the wrapper again on the local shards;
* a CPU tensor gets the plain version;
* any device other than CUDA or ``meta`` raises;
* when autograd records the call (grad mode on and an input that needs a
  gradient) it goes through the wrapper's ``Function``;
* otherwise the device route (``device``): on ``meta`` the shape-only op
  (``_shape``), on CUDA the launch, counted in the wrapper's ``.launches``.

A wrapper's own exception is declared by keyword: ``check`` (checks that
run on every device) and ``plain_cpu_dtensor`` (``rms_norm``: a CPU
``DTensor`` takes the plain version as ``DTensor`` ops, so a mesh's CPU step
keeps the unsharded step's numbers bit for bit).
"""
from __future__ import annotations

from typing import Any, Callable, Optional, Sequence

import torch
from torch.distributed.tensor import DTensor


def call(wrapper: Callable, lead: torch.Tensor, others: Sequence[Optional[torch.Tensor]] = (), *,
         plain: Callable[[], Any], device: Callable[[], Any],
         boundary: Optional[Callable[[], Any]] = None, function: Optional[Callable[[], Any]] = None,
         check: Optional[Callable[[], Any]] = None, mixed: Optional[str] = None,
         plain_cpu_dtensor: bool = False) -> Any:
    """The result of ``wrapper``'s call whose first tensor is ``lead`` and
    whose other tensors are ``others`` (None for an absent optional one).
    ``mixed`` (the wrapper's words, e.g. "q on the CPU but k or v
    elsewhere") makes a CPU call refuse ``others`` on another device;
    ``function`` serves the call when autograd records it on ``lead`` or
    ``others``.  A wrapper with no ``boundary`` takes a ``DTensor`` as it
    takes any tensor."""
    if boundary is not None and isinstance(lead, DTensor):
        if plain_cpu_dtensor and lead.device.type == "cpu":
            return plain()
        return boundary()
    if check is not None:
        check()
    if lead.device.type == "cpu":
        if mixed and any(t is not None and t.device.type != "cpu" for t in others):
            raise ValueError(f"{wrapper.__name__}: {mixed}")
        return plain()
    if lead.device.type not in ("cuda", "meta"):
        raise ValueError(f"{wrapper.__name__}: no kernel for device {lead.device}")
    if function is not None and torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (lead, *others)):
        return function()
    return device()


def device(wrapper: Callable, lead: torch.Tensor, shape: Callable[[], Any],
           launch: Callable[[], Any]) -> Any:
    """``shape()`` (the shape-only op) on ``meta``; else ``launch()``, counted
    as one launch of ``wrapper``."""
    if lead.device.type == "meta":
        return shape()
    out = launch()
    wrapper.launches += 1
    return out
