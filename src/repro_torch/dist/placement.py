"""Placing tensors by a ``NamedSharding`` on a ``DeviceMesh`` (the twin of
``jax.device_put(leaf, NamedSharding)``).

A spec names, per tensor dim, the mesh axes it is split over; DTensor names,
per mesh dim, the tensor dim it splits (``Shard(d)``) or ``Replicate()``.  A
tensor dim split over ("pod", "data") takes ``Shard(d)`` on both mesh dims,
which DTensor applies in mesh-dim order: JAX's major-to-minor order, so the
spec must list the axes in the mesh's order.

On a mesh of one device ``place`` returns a plain tensor on that device (a
one-device array in JAX is an ordinary array, and the kernels' ctypes
wrappers take plain tensors).  On a larger mesh it returns a ``DTensor``
built from this rank's local shard (``DTensor.from_local``, the twin of
``jax.make_array_from_process_local_data``).
"""
from __future__ import annotations

from typing import Any, List, Sequence, Tuple

import torch

from ..bridge import flatten_with_paths, map_with_paths
from .context import AbstractMesh, NamedSharding, mesh_size


def _axes(part: Any) -> Tuple[str, ...]:
    return (part,) if isinstance(part, str) else tuple(part)


def mesh_dims(sharding: NamedSharding) -> List[Tuple[int, int]]:
    """(mesh dim, tensor dim) of every split, in mesh-dim order."""
    names = list(sharding.mesh.mesh_dim_names)
    out = []
    for d, part in enumerate(sharding.spec):
        if part is None:
            continue
        dims = [names.index(a) for a in _axes(part)]
        if dims != sorted(dims):
            raise ValueError(f"spec {sharding.spec} lists axes of dim {d} out of the mesh's "
                             f"order {tuple(names)}")
        out += [(m, d) for m in dims]
    return sorted(out)


def placements(sharding: NamedSharding) -> list:
    """One ``Shard(d)`` or ``Replicate()`` per mesh dim."""
    from torch.distributed.tensor import Replicate, Shard

    out: list = [Replicate()] * sharding.mesh.ndim
    for m, d in mesh_dims(sharding):
        out[m] = Shard(d)
    return out


def shard_slices(sharding: NamedSharding, shape: Sequence[int],
                 coordinate: Sequence[int]) -> Tuple[slice, ...]:
    """The index of the shard of a ``shape`` tensor that the device at mesh
    ``coordinate`` holds."""
    mesh = sharding.mesh
    lo, hi = [0] * len(shape), list(shape)
    for m, d in mesh_dims(sharding):
        n = mesh.size(m)
        step = (hi[d] - lo[d]) // n
        if (hi[d] - lo[d]) % n:
            raise ValueError(f"dim {d} of {tuple(shape)} does not divide over mesh dim {m} ({n})")
        lo[d] += coordinate[m] * step
        hi[d] = lo[d] + step
    return tuple(slice(a, b) for a, b in zip(lo, hi))


def mesh_device(mesh: Any) -> torch.device:
    """This rank's device of ``mesh``."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def from_local(local: torch.Tensor, sharding: NamedSharding, shape: Sequence[int]) -> Any:
    """The global tensor of ``shape`` whose shard on this rank is ``local``:
    ``local`` itself on a mesh of one device, else a ``DTensor``."""
    mesh = sharding.mesh
    if mesh_size(mesh) == 1:
        return local
    from torch.distributed.tensor import DTensor

    stride = torch.empty(tuple(shape), device="meta").stride()
    return DTensor.from_local(local, mesh, placements(sharding), run_check=False,
                              shape=torch.Size(shape), stride=stride)


def place(tensor: torch.Tensor, sharding: NamedSharding) -> Any:
    """``tensor`` (the same full value on every rank) laid out by
    ``sharding``: on a mesh of one device a plain tensor on its device (the
    object itself when it is there already), else this rank's shard as a
    ``DTensor``.  A ``meta`` tensor stays on ``meta`` (the dry run's
    shapes)."""
    mesh = sharding.mesh
    if isinstance(mesh, AbstractMesh):
        raise TypeError("an AbstractMesh has no devices to place a tensor on")
    device = tensor.device if tensor.device.type == "meta" else mesh_device(mesh)
    if mesh_size(mesh) == 1:
        return tensor.to(device)
    local = tensor[shard_slices(sharding, tensor.shape, mesh.get_coordinate())]
    return from_local(local.to(device).contiguous(), sharding, tensor.shape)


def place_tree(tree: Any, shardings: Any) -> Any:
    """``place`` over a tree of tensors and a matching tree of shardings;
    leaves that are not tensors (a step count kept as a number) stay."""
    flat = dict(flatten_with_paths(shardings))

    def one(key: str, leaf: Any) -> Any:
        return place(leaf, flat[key]) if isinstance(leaf, torch.Tensor) else leaf

    return map_with_paths(tree, one)

