"""Checkpointing in the JAX package's on-disk format (twin of
``repro/train/checkpoint.py``), so a checkpoint written by either package
restores in the other.

Layout: ``directory/step_<N:08d>/`` holds one ``.npy`` per leaf, named by the
leaf's key with ``/`` written as ``__``, and ``manifest.json`` (``{"step",
"entries": [{"key", "file", "shape", "dtype"}]}``).  Keys are
``bridge.flatten_with_paths``'s (dict keys sorted, list items by index), the
JAX flattening.  A save writes ``step_<N>.tmp`` and renames it into place, so
a crashed save never corrupts an earlier checkpoint; the ``keep`` newest
checkpoints are kept.

bf16 leaves are written as raw 2-byte values with the header descr ``'<V2'``
and ``"bfloat16"`` in the manifest: the bytes that numpy writes for JAX's
(ml_dtypes) bfloat16 arrays.  They are read back through the manifest's
dtype, so neither direction needs ``ml_dtypes``.
"""
from __future__ import annotations

import json
import os
import shutil
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from .. import DeviceLike
from ..bridge import flatten_with_paths, map_with_paths

MANIFEST = "manifest.json"

_TO_NUMPY = {torch.float32: np.float32, torch.float16: np.float16, torch.int32: np.int32,
             torch.int64: np.int64, torch.uint8: np.uint8, torch.bool: np.bool_}
_FROM_NAME = {"float32": torch.float32, "float16": torch.float16, "int32": torch.int32,
              "int64": torch.int64, "uint8": torch.uint8, "bool": torch.bool}


def _save_leaf(path: str, t: torch.Tensor) -> Tuple[list, str]:
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        with open(path, "wb") as f:
            np.lib.format.write_array_header_1_0(
                f, {"descr": "<V2", "fortran_order": False, "shape": tuple(t.shape)})
            f.write(t.view(torch.int16).numpy().tobytes())
        return list(t.shape), "bfloat16"
    if t.dtype not in _TO_NUMPY:
        raise TypeError(f"checkpoint: no numpy dtype for {t.dtype}")
    arr = t.numpy()
    np.save(path, arr)
    return list(arr.shape), str(arr.dtype)


def _load_leaf(path: str, entry: Dict[str, Any]) -> torch.Tensor:
    arr = np.load(path)
    if entry["dtype"] == "bfloat16":
        if arr.dtype.itemsize != 2:
            raise TypeError(f"{path}: bfloat16 leaf stored with itemsize {arr.dtype.itemsize}")
        return torch.from_numpy(np.ascontiguousarray(arr).view(np.int16).copy()).view(
            torch.bfloat16)
    want = _FROM_NAME.get(entry["dtype"])
    if want is None:
        raise TypeError(f"{path}: no torch dtype for {entry['dtype']}")
    return torch.from_numpy(np.array(arr, copy=True)).to(want)


def save_checkpoint(directory: str, step: int, state: Any, keep: int = 3) -> str:
    """Write ``state`` under ``directory/step_<N>/``; prune all but the
    ``keep`` newest."""
    ckpt_dir = os.path.join(directory, f"step_{step:08d}")
    tmp_dir = ckpt_dir + ".tmp"
    os.makedirs(tmp_dir, exist_ok=True)
    entries = []
    for key, leaf in flatten_with_paths(state):
        fname = key.replace("/", "__") + ".npy"
        shape, dtype = _save_leaf(os.path.join(tmp_dir, fname), torch.as_tensor(leaf))
        entries.append({"key": key, "file": fname, "shape": shape, "dtype": dtype})
    with open(os.path.join(tmp_dir, MANIFEST), "w") as f:
        json.dump({"step": step, "entries": entries}, f)
    if os.path.exists(ckpt_dir):
        shutil.rmtree(ckpt_dir)
    os.replace(tmp_dir, ckpt_dir)  # atomic publish
    _prune(directory, keep)
    return ckpt_dir


def _prune(directory: str, keep: int) -> None:
    steps = sorted(
        d for d in os.listdir(directory) if d.startswith("step_") and not d.endswith(".tmp")
    )
    for d in steps[:-keep]:
        shutil.rmtree(os.path.join(directory, d), ignore_errors=True)


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = [
        int(d.split("_")[1])
        for d in os.listdir(directory)
        if d.startswith("step_") and not d.endswith(".tmp")
        and os.path.exists(os.path.join(directory, d, MANIFEST))
    ]
    return max(steps) if steps else None


def restore_checkpoint(
    directory: str, target: Any, step: Optional[int] = None, device: DeviceLike = None,
) -> Tuple[Any, int]:
    """Restore into the structure of ``target`` (a tree of tensors, e.g. a
    fresh train state): ``(tree, step)``.  Each leaf goes to ``device``, or
    to the target leaf's device; its shape must equal the target's."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {directory}")
    ckpt_dir = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(ckpt_dir, MANIFEST)) as f:
        by_key = {e["key"]: e for e in json.load(f)["entries"]}
    restored = {}
    for key, leaf in flatten_with_paths(target):
        e = by_key.get(key)
        if e is None:
            raise KeyError(f"checkpoint missing leaf {key}")
        t = _load_leaf(os.path.join(ckpt_dir, e["file"]), e)
        if isinstance(leaf, torch.Tensor) and tuple(leaf.shape) != tuple(t.shape):
            raise ValueError(f"{key}: checkpoint shape {tuple(t.shape)} != {tuple(leaf.shape)}")
        dev = device if device is not None else getattr(leaf, "device", None)
        restored[key] = t if dev is None else t.to(dev)
    return map_with_paths(target, lambda key, _: restored[key]), step

