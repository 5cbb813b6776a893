"""Collective bytes of a partitioned step (the twin of the JAX package's
``hlo_cost`` collective pass and ``roofline.parse_collective_bytes``).

JAX reads the collectives of a partitioned step from XLA's HLO text.  The
port's partitioned step runs eagerly on ``DTensor``s, and every collective
it issues - a redistribution, a vocab-parallel reduction, a kernel
boundary's - reaches the dispatcher as a functional collective on this
rank's local tensors.  ``CommCounter`` is a dispatch mode that records each
one: its kind, its operand bytes on this device and the mesh axis it ran
over.  JAX's conventions:

* kinds: ``all-gather``, ``all-reduce``, ``reduce-scatter``, ``all-to-all``
  and ``collective-permute`` (an ``all_to_all_single`` in which each rank
  sends to one peer);
* operand bytes: the input of the collective on this device - the shard of
  an all-gather, the whole input of a reduce-scatter or an all-reduce;
* a collective inside a layer is counted once per layer that runs (JAX
  weights a while body's collectives by its trip count).

On a CPU mesh (gloo, or the dry run's fake process group) DTensor moves a
split from one dim to another by an all-gather and a slice rather than an
all-to-all, which gloo lacks; the counter records that all-gather as the
all-to-all it stands for (same operand bytes: the local shard).

``detail()`` has the shape of JAX's ``collective_detail``: bytes by kind,
``counts`` by kind and ``total``; ``by_axis`` adds the bytes by mesh axis.
"""
from __future__ import annotations

import contextlib
from typing import Any, Dict, Iterator, Optional

import torch
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all", "collective-permute")
_NAMESPACES = ("_c10d_functional", "_c10d_functional_autograd", "_dtensor")
_KIND_OF = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "shard_dim_alltoall": "all-to-all",
}


def collective_kind(func: Any, args: Any) -> Optional[str]:
    """The JAX kind of a functional collective op, or None for any other
    op."""
    if func.namespace not in _NAMESPACES:
        return None
    kind = _KIND_OF.get(func.overloadpacket.__name__)
    if kind == "all-to-all" and func.overloadpacket.__name__ == "all_to_all_single":
        splits = args[2] if len(args) > 2 else None
        if splits is not None and sum(1 for s in splits if s) <= 1:
            return "collective-permute"
    return kind


def _nbytes(x: Any) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(x) if isinstance(t, torch.Tensor))


class CommCounter(TorchDispatchMode):
    """Records the functional collectives of the local program under it.

    ``mesh`` names the axes: a collective over one mesh dim's group is
    booked to that dim's name, any other group to "world".  Ops on tensor
    subclasses (``DTensor``) pass to the subclass, whose local program
    reaches the counter."""

    def __init__(self, mesh: Any = None):
        super().__init__()
        self.bytes: Dict[str, int] = {k: 0 for k in KINDS}
        self.counts: Dict[str, int] = {k: 0 for k in KINDS}
        self.by_axis: Dict[str, int] = {}
        self.tag: Optional[str] = None
        self._axes: Dict[str, str] = {}
        if mesh is not None and getattr(mesh, "mesh_dim_names", None):
            for i, name in enumerate(mesh.mesh_dim_names):
                self._axes[mesh.get_group(i).group_name] = name

    def record(self, func: Any, args: Any) -> bool:
        """Books ``func`` if it is a collective; True if it was one."""
        kind = collective_kind(func, args)
        if kind is None:
            return False
        if self.tag is not None and kind == "all-gather":
            kind = self.tag
        n = _nbytes(args[0])
        self.bytes[kind] += n
        self.counts[kind] += 1
        group = args[-1] if isinstance(args[-1], str) else None
        axis = self._axes.get(group, "world")
        self.by_axis[axis] = self.by_axis.get(axis, 0) + n
        return True

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented  # DTensor runs it on the local shards
        if not any(t is not torch.Tensor for t in types):
            self.record(func, args)
        return func(*args, **(kwargs or {}))

    @property
    def total(self) -> int:
        return sum(self.bytes.values())

    def detail(self) -> Dict[str, Any]:
        out: Dict[str, Any] = dict(self.bytes)
        out["total"] = self.total
        out["counts"] = dict(self.counts)
        out["by_axis"] = dict(self.by_axis)
        return out


@contextlib.contextmanager
def alltoall_as_alltoall(counter: CommCounter) -> Iterator[None]:
    """While active, the all-gather by which DTensor moves a split between
    dims on a CPU mesh is booked as the all-to-all it stands for.  It wraps
    DTensor's ``shard_dim_alltoall`` (private to torch; with no such
    function the all-gather is booked as one)."""
    from torch.distributed.tensor import placement_types as pt

    orig = getattr(pt, "shard_dim_alltoall", None)
    if orig is None:
        yield
        return

    def tagged(*args, **kw):
        counter.tag = "all-to-all"
        try:
            return orig(*args, **kw)
        finally:
            counter.tag = None

    pt.shard_dim_alltoall = tagged
    try:
        yield
    finally:
        pt.shard_dim_alltoall = orig


@contextlib.contextmanager
def count_collectives(mesh: Any = None) -> Iterator[CommCounter]:
    """``with count_collectives(mesh) as c: step()`` -> ``c.detail()``."""
    counter = CommCounter(mesh)
    with alltoall_as_alltoall(counter), counter:
        yield counter
