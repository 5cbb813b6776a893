"""Input stand-ins on the ``meta`` device for every (arch x shape) cell (twin
of the JAX package's ``repro/launch/specs.py``).

``*_input_specs`` give the keys, shapes and dtypes of JAX's
``ShapeDtypeStruct`` specs as empty tensors on ``meta``: they hold no
memory, and the dry run (``launch.dryrun``) runs the step against them.
Integer leaves are int32, as in JAX.  The modality frontends are stubs, as
in JAX: whisper takes precomputed 1500-frame mel embeddings, qwen2-vl
pre-embedded mixed text and vision tokens with (t, h, w) M-RoPE position
ids.  ``params_shape`` and ``opt_shape`` build the parameters and AdamW
state shape-only, through the model's own ``init`` on ``meta`` (no number
is drawn, so llama3-405b takes no memory).
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from ..bridge import flatten_with_paths
from ..models import Model
from ..models.config import ModelConfig, ShapeConfig
from ..models.layers import DTYPES
from ..train import optimizer as opt

META = torch.device("meta")


def _spec(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def train_input_specs(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, torch.Tensor]:
    B, S = shape.global_batch, shape.seq_len
    dt = DTYPES[cfg.dtype]
    i32 = torch.int32
    if cfg.family == "encdec":
        return {"enc_embeds": _spec((B, cfg.encoder_seq, cfg.d_model), dt),
                "tokens": _spec((B, S), i32), "labels": _spec((B, S), i32)}
    if cfg.family == "vlm":
        return {"embeds": _spec((B, S, cfg.d_model), dt),
                "positions": _spec((B, S, 3), i32), "labels": _spec((B, S), i32)}
    return {"tokens": _spec((B, S), i32), "labels": _spec((B, S), i32)}


def prefill_input_specs(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, torch.Tensor]:
    specs = train_input_specs(cfg, shape)
    specs.pop("labels")
    return specs


def decode_input_specs(model: Model, cfg: ModelConfig,
                       shape: ShapeConfig) -> Tuple[Dict[str, torch.Tensor], Any]:
    """(token specs, cache) for one-new-token decode over a seq_len-deep
    cache (the ``decode_*`` / ``long_*`` cells run the serve step, not the
    train step).  The cache's ``"pos"`` is a host int, 0 as ``init_cache``
    leaves it."""
    B, S = shape.global_batch, shape.seq_len
    if cfg.family == "encdec":
        cache = model.init_cache(params_shape(model), B, S)
    else:
        cache = model.init_cache(B, S, device=META)
    return {"tokens": _spec((B,), torch.int32)}, cache


def params_shape(model: Model) -> Any:
    return model.init(device=META)


def opt_shape(model: Model, opt_cfg: opt.AdamWConfig) -> Dict[str, Any]:
    """AdamW's state for ``params_shape(model)``, every leaf on ``meta``
    (the step count too)."""
    state = opt.init_state(params_shape(model), opt_cfg)
    state["step"] = state["step"].to(META)
    return state


def nbytes(tree: Any) -> int:
    """Bytes of every tensor leaf of ``tree``."""
    return sum(t.numel() * t.element_size() for _, t in flatten_with_paths(tree)
               if isinstance(t, torch.Tensor))
