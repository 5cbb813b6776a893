"""Meshes and the plan over them (twin of the JAX package's
``repro/launch/mesh.py``).

Single-pod: (data=16, model=16) = 256 chips.  Multi-pod: (pod=2, data=16,
model=16) = 512 chips; the ``pod`` axis carries data parallelism (params
replicated per pod by default; FSDP may extend over ("pod", "data") for the
1T-parameter configs, see ``ShardingPlan``).

One card cannot hold 256 ranks, so ``make_production_mesh`` returns an
``AbstractMesh``: the axis names and sizes the sharding rules read, with no
devices (the twin of ``jax.sharding.AbstractMesh``).  A ``DeviceMesh`` is
built only where tensors are placed (``make_test_mesh``): over gloo ranks on
the CPU, or over NCCL ranks on the card.
"""
from __future__ import annotations

from typing import Any, Optional

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
