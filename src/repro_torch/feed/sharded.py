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

Over a mesh, per-leaf ``NamedSharding``s come from the caller or are derived
once from a (mesh, ``ShardingPlan``) pair by ``dist.sharding_rules.
batch_sharding``, the rule the train step's inputs follow.  In JAX one process
holds the host batch and ``device_put`` splits it over its devices; in
PyTorch every device is a rank.  So the mesh is one host: its first rank
(the leader) holds the host batch, cuts it into every rank's shard
(``shard_payloads``: row ranges of the data axes, the same rows for peers on
the model axis) and scatters them over a gloo group of the mesh's ranks, and
each rank places its shard and wraps it as the global tensor
(``dist.placement.from_local``, the twin of
``make_array_from_process_local_data``): no rank receives rows it does not
hold, and there is never a gather.
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..bridge import flatten_with_paths, map_with_paths
from ..dist.context import NamedSharding
from ..dist.placement import from_local, shard_slices


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
    """Per-leaf ``NamedSharding``s of a concrete batch: leading (batch) dim
    over the plan's data axes, everything else replicated, as
    ``sharding_rules.batch_sharding`` declares the train step's inputs.
    Derived from the batch's own shapes, so an indivisible leading dim is
    replicated instead of failing the placement."""
    from ..dist.sharding_rules import batch_sharding

    return batch_sharding(mesh, plan, batch)


def resolve_shardings(batch: Any, shardings: Any) -> Any:
    """A shardings argument as a per-leaf tree matching ``batch``: a single
    ``NamedSharding`` applies to every leaf; a tree is returned as it is."""
    if shardings is None:
        return None
    if isinstance(shardings, NamedSharding):
        return _map(batch, lambda _: shardings)
    return shardings


def sharding_mesh(shardings: Any) -> Any:
    """The mesh of a ``NamedSharding`` or of the first one in a tree."""
    for _, s in flatten_with_paths(shardings):
        if isinstance(s, NamedSharding):
            return s.mesh
    raise ValueError("shardings= holds no NamedSharding")


@dataclass(frozen=True)
class Shard:
    """One rank's shard of a batch leaf: ``local`` (an owned array), the
    leaf's global ``shape`` and its ``spec`` (a leaf to the tree helpers,
    which recurse into tuples)."""

    local: np.ndarray
    shape: Tuple[int, ...]
    spec: Any


def shard_payloads(batch: Any, shardings: Any, coordinates: List[Tuple[int, ...]]) -> List[Any]:
    """For each mesh coordinate, the batch tree with every leaf replaced by
    its ``Shard`` at that coordinate."""
    specs = dict(flatten_with_paths(shardings))

    def payload(coord):
        def one(key: str, leaf: Any) -> Shard:
            arr = np.asarray(leaf)
            sharding = specs[key]
            local = np.ascontiguousarray(arr[shard_slices(sharding, arr.shape, coord)])
            return Shard(local, arr.shape, sharding.spec)

        return map_with_paths(batch, one)

    return [payload(c) for c in coordinates]


def local_arrays(payload: Any) -> Any:
    """The ``local`` arrays of a ``Shard`` tree."""
    return _map(payload, lambda s: s.local)


def wrap_global(placed: Any, payload: Any, mesh: Any) -> Any:
    """The placed local tree (``put_batch`` of the payload's ``local``
    arrays) as global tensors over ``mesh``."""
    shards = iter(leaves(payload))

    def one(t: torch.Tensor) -> Any:
        s = next(shards)
        return from_local(t, NamedSharding(mesh, s.spec), s.shape)

    return _map(placed, one)


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
