"""repro_torch - the PyTorch and CUDA port of the accelerator side of the
repo, beside the JAX package ``repro`` (the reference).  It imports neither
``jax`` nor anything of ``repro``.

It serves and trains the models of every family - decoder-only LMs (dense,
MoE, SSM (mamba2), hybrid (jamba), the VLM backbone (qwen2-vl)) and the
encoder-decoder (whisper) - on one NVIDIA H100: configs (``repro_torch.configs``),
the model (``repro_torch.models``), the serving engine
(``repro_torch.serve``), the feed from the data service
(``repro_torch.feed``), training (``repro_torch.train``), the sharding
layer (``repro_torch.dist``: plans, rules, placement on a ``DeviceMesh``,
int8 gradient compression) and the
hand-written Hopper kernels and their backwards (``repro_torch.kernels``).
``repro_torch.bridge`` carries parameters from the JAX model across,
through numpy.

Entry points run on CUDA unless the caller passes ``device="cpu"``.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``device`` as a ``torch.device``; with no device, the current CUDA
    device, and an error when there is none (never a silent CPU run)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on a CUDA device and none is available; "
                "pass device='cpu' to run the plain CPU versions"
            )
        return torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device
