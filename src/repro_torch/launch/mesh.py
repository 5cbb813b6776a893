"""Meshes and the plan over them (twin of the JAX package's
``repro/launch/mesh.py``).

Single-pod: (data=16, model=16) = 256 chips.  Multi-pod: (pod=2, data=16,
model=16) = 512 chips; the ``pod`` axis carries data parallelism (params
replicated per pod by default; FSDP may extend over ("pod", "data") for the
1T-parameter configs, see ``ShardingPlan``).

One card cannot hold 256 ranks, so ``make_production_mesh`` returns an
``AbstractMesh``: the axis names and sizes the sharding rules read, with no
devices (the twin of ``jax.sharding.AbstractMesh``).  A ``DeviceMesh`` is
built where tensors are placed (``make_test_mesh``): over gloo ranks on the
CPU, or over NCCL ranks on the card.  The dry run partitions its step on a
``fake_device_mesh``: the production mesh's names and sizes over a "fake"
process group (one process, seen from rank 0, whose collectives move
nothing), so ``meta`` ``DTensor``s run the step one device runs.
"""
from __future__ import annotations

from typing import Any, Optional

import torch

from ..dist.context import AbstractMesh, ShardingPlan, mesh_axis_sizes


def make_production_mesh(*, multi_pod: bool = False) -> AbstractMesh:
    if multi_pod:
        return AbstractMesh((2, 16, 16), ("pod", "data", "model"))
    return AbstractMesh((16, 16), ("data", "model"))


def make_plan(mesh: Any, *, fsdp_over_pod: bool = False, seq_shard: bool = False) -> ShardingPlan:
    multi = "pod" in mesh_axis_sizes(mesh)
    data_axes = ("pod", "data") if multi else ("data",)
    fsdp = ("pod", "data") if (multi and fsdp_over_pod) else "data"
    return ShardingPlan(
        data_axes=data_axes,
        model_axis="model",
        fsdp_axis=fsdp,
        seq_axis="model" if seq_shard else None,
    )


def make_test_mesh(data: int = 1, model: int = 1, device_type: str = "cpu") -> Optional[Any]:
    """A (data, model) ``DeviceMesh`` over the first data x model ranks of
    the initialised process group, or None when there are too few ranks (or
    no group).  Every rank of the group calls it, as ``DeviceMesh`` needs."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    n = data * model
    if not (dist.is_available() and dist.is_initialized()) or dist.get_world_size() < n:
        return None
    ranks = torch.arange(n).reshape(data, model)
    return DeviceMesh(device_type, ranks, mesh_dim_names=("data", "model"))


def fake_device_mesh(mesh: AbstractMesh, device_type: str = "cpu") -> Any:
    """A ``DeviceMesh`` with ``mesh``'s axis names and sizes over a "fake"
    process group of ``mesh.size`` ranks, seen from rank 0.  The group is
    the process's default group: the caller destroys it
    (``torch.distributed.destroy_process_group()``) before it makes
    another."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    # the one import of torch's private fake process group (it ships with
    # torch and registers the "fake" backend when imported)
    from torch.testing._internal.distributed.fake_pg import FakeStore

    sizes = mesh_axis_sizes(mesh)
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=mesh.size)
    ranks = torch.arange(mesh.size).reshape(tuple(sizes.values()))
    return DeviceMesh(device_type, ranks, mesh_dim_names=tuple(sizes))
