"""Carries parameter trees between the JAX model and the port, through numpy.

``params_from_jax(tree)`` turns a numpy pytree from the JAX
``LanguageModel.init`` or ``EncDecModel.init`` (``jax.device_get`` of it)
into the port's parameters;
``params_to_numpy(params)`` goes the other way.  Both keep the tree as it is
(nested dicts and lists, stacked groups with their leading repeats dim), so
every leaf maps to exactly one tensor under the same key.  Keys are those of
the JAX checkpoint format: path components joined by "/", dict keys sorted,
list items by index (``group0/0/attn/wq``, ``group1/0/moe/router``,
``group0/0/ssm/conv_w``, and the enc-dec's ``dec/xattn/wk``, stacked over
its layers): every family's leaves carry across the same way,
and ``like`` checks them against the port's own layout (a mamba2 block
without an FFN has no ``ln2`` on either side).  Nothing here imports JAX.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from . import DeviceLike

_NP_TO_TORCH = {
    np.dtype(np.float32): torch.float32,
    np.dtype(np.float16): torch.float16,
    np.dtype(np.int32): torch.int32,
    np.dtype(np.int64): torch.int64,
}


def flatten_with_paths(tree: Any, prefix: str = "") -> List[Tuple[str, Any]]:
    """(key, leaf) pairs in the JAX flattening order."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += flatten_with_paths(tree[k], f"{prefix}{k}/")
        return out
    if isinstance(tree, (list, tuple)):
        out = []
        for i, v in enumerate(tree):
            out += flatten_with_paths(v, f"{prefix}{i}/")
        return out
    return [(prefix[:-1], tree)]


def map_with_paths(tree: Any, fn, prefix: str = "") -> Any:
    """The same tree (tuples become lists) with each leaf replaced by
    ``fn(key, leaf)``, keys as in ``flatten_with_paths``."""
    if isinstance(tree, dict):
        return {k: map_with_paths(v, fn, f"{prefix}{k}/") for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [map_with_paths(v, fn, f"{prefix}{i}/") for i, v in enumerate(tree)]
    return fn(prefix[:-1], tree)


def _is_bf16(dt: np.dtype) -> bool:
    return dt.name == "bfloat16"  # ml_dtypes' numpy bfloat16, as JAX hands it out


def _to_torch(key: str, leaf: Any, device: Optional[torch.device]) -> torch.Tensor:
    arr = np.array(leaf, copy=True, order="C")  # owned and writable
    if _is_bf16(arr.dtype):
        t = torch.from_numpy(arr.view(np.uint16)).view(torch.bfloat16)
    elif arr.dtype in _NP_TO_TORCH:
        t = torch.from_numpy(arr)
    else:
        raise TypeError(f"{key}: no torch dtype for numpy {arr.dtype}")
    if tuple(t.shape) != arr.shape:
        raise AssertionError(f"{key}: shape {tuple(t.shape)} != {arr.shape}")
    return t if device is None else t.to(device)


def params_from_jax(
    tree: Any, like: Optional[Any] = None, device: DeviceLike = None
) -> Dict[str, Any]:
    """The port's parameters from a numpy pytree of the JAX model.

    ``device`` defaults to the CPU (the tree comes from host memory).  With
    ``like`` (e.g. ``build_model(cfg).init(device="cpu")``), the result must
    have exactly its keys, shapes and dtypes, or this raises.
    """
    dev = None if device is None else torch.device(device)
    out = map_with_paths(tree, lambda k, leaf: _to_torch(k, leaf, dev))
    if like is not None:
        got = {k: (tuple(t.shape), t.dtype) for k, t in flatten_with_paths(out)}
        want = {k: (tuple(t.shape), t.dtype) for k, t in flatten_with_paths(like)}
        if got.keys() != want.keys():
            raise AssertionError(
                f"parameter keys differ: only in JAX {sorted(got.keys() - want.keys())}, "
                f"only in the port {sorted(want.keys() - got.keys())}"
            )
        bad = {k: (got[k], want[k]) for k in got if got[k] != want[k]}
        if bad:
            raise AssertionError(f"shape/dtype mismatch (JAX, port): {bad}")
    return out


def params_to_numpy(params: Any) -> Any:
    """The same tree with numpy leaves (bf16 as ml_dtypes' bfloat16)."""

    def conv(key: str, t: torch.Tensor) -> np.ndarray:
        t = t.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            import ml_dtypes  # numpy's bfloat16, only needed for bf16 leaves

            return t.view(torch.uint16).numpy().view(ml_dtypes.bfloat16).copy()
        return t.numpy().copy()

    return map_with_paths(params, conv)
