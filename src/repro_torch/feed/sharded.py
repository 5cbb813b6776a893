"""Host→device placement of service batches (twin of the JAX package's
``repro/feed/sharded.py``, for one device).

A service batch is a tree (dicts, lists, tuples) of numpy arrays.  On a CUDA
device ``put_batch`` copies each leaf into a pinned host buffer, then issues
``copy_(..., non_blocking=True)`` on a side CUDA stream and records one
``torch.cuda.Event`` per batch: the consumer makes its own stream wait on
that event before it reads the batch.  The pinned buffers form a ring of
``depth + 1`` slots (``PinnedRing``), and a slot is refilled only after the
event of the batch that last used it has completed, so a copy in flight
never reads a buffer that is being overwritten.  On the CPU each leaf
becomes an owned tensor (a copy: the zero-copy views of a service session
are read-only and valid only until the next fetch).

Sharding over a mesh is not ported yet: ``infer_batch_shardings`` raises,
naming ROADMAP's ``dist/`` item.
"""
from __future__ import annotations

import itertools
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

DIST_ITEM = "ROADMAP queue 1, item 4 (dist/)"


def host_layout() -> Tuple[int, int]:
    """(host_index, num_hosts): the ``torch.distributed`` rank and world
    size, or (0, 1) when no process group is initialised."""
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _map(tree: Any, fn: Callable[[Any], Any]) -> Any:
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(v, fn) for v in tree)
    return fn(tree)


def leaves(tree: Any) -> List[Any]:
    out: List[Any] = []
    _map(tree, out.append)
    return out


def leaf_nbytes(tree: Any) -> int:
    return sum(int(getattr(leaf, "nbytes", 0)) for leaf in leaves(tree))


def infer_batch_shardings(batch: Any, mesh: Any, plan: Any) -> Any:
    raise NotImplementedError(f"batch shardings over a mesh are not ported yet; see {DIST_ITEM}")


def _torch_dtype(dtype: np.dtype) -> torch.dtype:
    try:
        return torch.from_numpy(np.empty(0, dtype)).dtype
    except TypeError as e:
        raise TypeError(f"put_batch: no torch dtype for numpy {dtype}") from e


def _owned(leaf: Any) -> torch.Tensor:
    return torch.from_numpy(np.array(leaf, copy=True, order="C"))


class PinnedRing:
    """``slots`` pinned staging buffers per leaf and a side stream for
    host→device copies onto one CUDA ``device``."""

    def __init__(self, device: torch.device, slots: int):
        self.device = device
        self.stream = torch.cuda.Stream(device)
        self._bufs: List[Dict[int, torch.Tensor]] = [{} for _ in range(max(1, slots))]
        self._events: List[Optional[torch.cuda.Event]] = [None] * max(1, slots)
        self._next = 0

    def put(self, batch: Any) -> Tuple[Any, torch.cuda.Event]:
        """Stages ``batch`` in the next slot and starts its copy; returns the
        device tree and the event recorded after the copy."""
        i = self._next
        self._next = (i + 1) % len(self._bufs)
        if self._events[i] is not None:
            self._events[i].synchronize()  # the slot's previous copy is done
        bufs = self._bufs[i]
        counter = itertools.count()

        def one(leaf: Any) -> torch.Tensor:
            arr = np.asarray(leaf)
            j = next(counter)
            buf = bufs.get(j)
            dtype = _torch_dtype(arr.dtype)
            if buf is None or tuple(buf.shape) != arr.shape or buf.dtype != dtype:
                buf = bufs[j] = torch.empty(arr.shape, dtype=dtype, pin_memory=True)
            np.copyto(buf.numpy(), arr)  # the one host copy, out of the (borrowed) view
            out = torch.empty(arr.shape, dtype=dtype, device=self.device)
            out.copy_(buf, non_blocking=True)
            return out

        with torch.cuda.device(self.device), torch.cuda.stream(self.stream):
            placed = _map(batch, one)
            event = torch.cuda.Event()
            event.record(self.stream)
        self._events[i] = event
        return placed, event


def put_batch(batch: Any, device: torch.device,
              ring: Optional[PinnedRing] = None) -> Tuple[Any, Optional[torch.cuda.Event]]:
    """Places one host batch on ``device``: (tree of tensors, event).  On the
    CPU the tensors are owned copies and the event is None; on CUDA the copy
    goes through ``ring`` (required there) and may still be in flight until
    the event completes."""
    if device.type == "cpu":
        return _map(batch, _owned), None
    if device.type != "cuda" or ring is None:
        raise ValueError(f"put_batch: no transfer path to {device} (a CUDA device takes a "
                         "PinnedRing)")
    return ring.put(batch)
