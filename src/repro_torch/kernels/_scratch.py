"""The kernels' scratch as data: each launch function's ``*_scratch(...)``
returns ``{name: (shape, dtype)}`` of the device buffers it allocates
around its kernels, and the launch allocates them from that table
(``allocate``).  The dry run's memory analysis (``launch.memory``) charges
the same table when a kernel's shape-only op runs on ``meta``, so both
routes read one reckoning.  A kernel with no scratch returns ``{}``."""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

Scratch = Dict[str, Tuple[Tuple[int, ...], torch.dtype]]


def allocate(spec: Scratch, device: torch.device) -> Dict[str, torch.Tensor]:
    """One empty tensor of each entry of ``spec`` on ``device``."""
    return {name: torch.empty(shape, dtype=dt, device=device)
            for name, (shape, dt) in spec.items()}


def nbytes(spec: Scratch) -> Dict[str, int]:
    """Bytes of each entry of ``spec``."""
    return {name: math.prod(shape) * torch.empty((), dtype=dt).element_size()
            for name, (shape, dt) in spec.items()}
