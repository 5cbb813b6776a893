"""Sharding plan, meshes and the activation-constraint hook (twin of the JAX
package's ``repro/dist/context.py``).

A ``ShardingPlan`` maps LOGICAL tensor roles onto PHYSICAL mesh axes.  The
model code never names mesh axes: layers call ``shard_activations(x, "bsd")``
with a role string (one character per dim) and the active plan decides which
mesh axis, if any, each role pins to:

  role  meaning                      default axis
  ----  ---------------------------  -------------------------------
  b     global batch                 plan.data_axes
  s     sequence                     plan.seq_axis (None unless
                                     sequence parallelism is on)
  d     d_model / hidden             None (replicated)
  g     MoE dispatch group           plan.data_axes
  t     tokens within a group        None
  e     expert                       plan.moe_expert_axis (subject to
                                     plan.moe_pin)
  c     expert capacity slot         None
  h     heads                        plan.model_axis

Outside an active plan, and on a mesh of one device, the hook returns its
input object unchanged.  A dim that its axes do not divide is replicated.

Meshes.  The rules read only a mesh's axis names and sizes
(``mesh_axis_sizes``), so they take either a ``torch`` ``DeviceMesh`` (ranks
with devices, where tensors are placed) or an ``AbstractMesh`` (names and
sizes, no devices: the twin of ``jax.sharding.AbstractMesh``, for the dry
run's 256- and 512-chip meshes on one card).  A spec is a ``P``, a tuple
with one entry per leading tensor dim (None, an axis name or a tuple of
names), trailing Nones trimmed, as ``jax.sharding.PartitionSpec`` holds it.
"""
from __future__ import annotations

import contextlib
import math
import threading
from dataclasses import dataclass
from typing import Any, Dict, Optional, Sequence, Tuple, Union

Axis = Union[str, Tuple[str, ...]]


class P(tuple):
    """A per-dim spec: ``P("data", None, ("pod", "model"))``."""

    def __new__(cls, *parts: Any) -> "P":
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


class AbstractMesh:
    """Axis names and sizes with no devices behind them."""

    def __init__(self, axis_sizes: Sequence[int], axis_names: Sequence[str]):
        if len(axis_sizes) != len(axis_names):
            raise ValueError(f"{len(axis_sizes)} sizes for {len(axis_names)} axis names")
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, (int(s) for s in axis_sizes)))

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    def __repr__(self) -> str:
        return f"AbstractMesh({self.shape})"


def mesh_axis_sizes(mesh: Any) -> Dict[str, int]:
    """{axis name: size} of an ``AbstractMesh`` or a ``DeviceMesh``."""
    if isinstance(mesh, AbstractMesh):
        return dict(mesh.shape)
    names = mesh.mesh_dim_names
    if names is None:
        raise ValueError("a DeviceMesh for the sharding rules needs mesh_dim_names")
    return dict(zip(names, (int(s) for s in mesh.shape)))


def mesh_size(mesh: Any) -> int:
    return math.prod(mesh_axis_sizes(mesh).values())


def _axes_size(sizes: Dict[str, int], axes: Sequence[str]) -> int:
    return math.prod(int(sizes.get(a, 0) or 0) for a in axes)


@dataclass(frozen=True)
class NamedSharding:
    """A spec over a mesh (twin of ``jax.sharding.NamedSharding``)."""

    mesh: Any
    spec: P

    def shard_shape(self, shape: Sequence[int]) -> Tuple[int, ...]:
        """The shape of one device's shard of a ``shape`` tensor."""
        sizes = mesh_axis_sizes(self.mesh)
        out = list(shape)
        for i, part in enumerate(self.spec):
            if part is None:
                continue
            n = _axes_size(sizes, (part,) if isinstance(part, str) else part)
            if out[i] % n:
                raise ValueError(f"dim {i} of {tuple(shape)} does not divide over {part} ({n})")
            out[i] //= n
        return tuple(out)


@dataclass(frozen=True)
class ShardingPlan:
    """Logical-axis → mesh-axis assignment for one launch.

    ``data_axes`` may span several mesh axes (("pod", "data") on the
    multi-pod mesh).  ``fsdp_axis`` is the axis parameters are fully sharded
    over (ZeRO-3 style); it may equal the data axis or extend over ("pod",
    "data") for the 1T-parameter configs.
    """

    data_axes: Tuple[str, ...] = ("data",)
    model_axis: str = "model"
    fsdp_axis: Optional[Axis] = "data"
    seq_axis: Optional[str] = None
    # MoE dispatch-buffer pinning: "auto"/"group_ep" pins (G→data, E→expert
    # axis); "group" pins only G and leaves E to the partitioner.
    moe_pin: str = "auto"
    moe_expert_axis: str = "model"

    @property
    def fsdp_axes(self) -> Tuple[str, ...]:
        if self.fsdp_axis is None:
            return ()
        if isinstance(self.fsdp_axis, str):
            return (self.fsdp_axis,)
        return tuple(self.fsdp_axis)


class _PlanState(threading.local):
    def __init__(self) -> None:
        self.plan: Optional[ShardingPlan] = None
        self.mesh: Any = None


_STATE = _PlanState()


@contextlib.contextmanager
def use_plan(plan: ShardingPlan, mesh: Any = None):
    """Activate ``plan`` (over ``mesh``) for the dynamic extent, in this
    thread."""
    prev_plan, prev_mesh = _STATE.plan, _STATE.mesh
    _STATE.plan, _STATE.mesh = plan, mesh
    try:
        yield plan
    finally:
        _STATE.plan, _STATE.mesh = prev_plan, prev_mesh


def current_plan() -> Optional[ShardingPlan]:
    return _STATE.plan


def current_mesh() -> Any:
    return _STATE.mesh


def _role_axes(role: str, plan: ShardingPlan) -> Optional[Tuple[str, ...]]:
    if role == "b" or role == "g":
        return tuple(plan.data_axes)
    if role == "s":
        return (plan.seq_axis,) if plan.seq_axis else None
    if role == "h":
        return (plan.model_axis,)
    if role == "e":
        if plan.moe_pin in ("auto", "group_ep"):
            return (plan.moe_expert_axis,)
        return None
    return None  # d, t, c, and anything unrecognized: replicate


def plan_spec(roles: str, plan: ShardingPlan, shape: Optional[Sequence[int]] = None,
              mesh: Any = None) -> P:
    """The spec of a role string, dropping axes that do not divide (given a
    shape and a mesh) and axes an earlier dim took."""
    sizes = mesh_axis_sizes(mesh) if mesh is not None else None
    parts = []
    used: set = set()
    for i, role in enumerate(roles):
        axes = _role_axes(role, plan)
        if axes and not (set(axes) & used):
            if sizes is not None and shape is not None:
                size = _axes_size(sizes, axes)
                if size == 0 or shape[i] % size:
                    parts.append(None)
                    continue
            used.update(axes)
            parts.append(axes[0] if len(axes) == 1 else tuple(axes))
        else:
            parts.append(None)
    while parts and parts[-1] is None:
        parts.pop()
    return P(*parts)


def shard_activations(x: Any, roles: str) -> Any:
    """Constrain an activation's layout per the active plan: ``x`` itself with
    no plan, no mesh, a mesh of one device or a tensor that is not a
    ``DTensor`` (a plain tensor on a larger mesh is a rank's local data, whose
    layout the hook cannot know); a ``DTensor`` is redistributed to the
    plan's placements (the twin of ``with_sharding_constraint``)."""
    plan, mesh = _STATE.plan, _STATE.mesh
    if plan is None or mesh is None or mesh_size(mesh) == 1:
        return x
    if len(roles) != x.ndim:
        raise ValueError(f"roles {roles!r} for a tensor of shape {tuple(x.shape)}")
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor):
        return x
    from .placement import placements

    spec = plan_spec(roles, plan, shape=x.shape, mesh=mesh)
    return x.redistribute(x.device_mesh, placements(NamedSharding(x.device_mesh, spec)))
