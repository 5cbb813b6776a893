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

The partitioned step.  On a ``DeviceMesh`` of more than one device the
steps run on ``DTensor``s (the twin of ``jax.jit(step, in_shardings=...)``):
the parameters, optimizer state, inputs and caches are placed by the rules,
and DTensor propagates their layout op by op.  What the model makes itself
(rope tables, positions, masks, the MoE dispatch buffer) enters the mesh
through ``like_mesh``, with an explicit placement; on a plain tensor it is
the identity, so the one-device path is unchanged.  The kernel wrappers are
where a ``DTensor`` becomes local (``kernels/_boundary.py``).

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
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

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


# ---------------------------------------------------------------------------
# the partitioned step
# ---------------------------------------------------------------------------
def is_dtensor(x: Any) -> bool:
    return isinstance(x, DTensor)


def like_mesh(t: torch.Tensor, ref: Any, placements: Optional[Sequence[Any]] = None) -> Any:
    """``t`` itself when ``ref`` is not a ``DTensor`` (or ``t`` is one); else
    ``t`` on ``ref``'s mesh as a ``DTensor``: replicated on every mesh dim (``t`` is then the
    same value on every rank), or laid out by ``placements`` (``t`` is then
    this rank's shard)."""
    if not isinstance(ref, DTensor) or isinstance(t, DTensor):
        return t
    mesh = ref.device_mesh
    return DTensor.from_local(t, mesh, list(placements or [Replicate()] * mesh.ndim),
                              run_check=False)


def mesh_roles(mesh: Any) -> Tuple[List[int], Optional[int]]:
    """(mesh dims of the data axes, mesh dim of the model axis or None) of a
    ``DeviceMesh``, by the active plan's axis names (JAX's default names
    without one)."""
    plan = _STATE.plan or ShardingPlan(data_axes=("pod", "data"))
    names = list(mesh.mesh_dim_names or ())
    data = [i for i, n in enumerate(names) if n in plan.data_axes]
    return data, (names.index(plan.model_axis) if plan.model_axis in names else None)


def unshard_dim(x: Any, dim: int) -> Any:
    """``x`` with tensor dim ``dim`` whole on every rank: a ``DTensor`` split
    (or pending a sum) along it is redistributed, its other splits kept; any
    other ``x`` is returned as it is."""
    if not isinstance(x, DTensor):
        return x
    dim %= x.ndim
    want = [Replicate() if (isinstance(p, Shard) and p.dim % x.ndim == dim)
            or isinstance(p, Partial) else p for p in x.placements]
    return x if tuple(want) == tuple(x.placements) else x.redistribute(x.device_mesh, want)


# per-layer cache leaf -> its heads dim (KV caches (B, S, Hkv, D), SSM state
# (B, H, N, P)); the conv window (B, K-1, Ch) has none
CACHE_HEADS = {"k": 2, "v": 2, "xk": 2, "xv": 2, "h": 1}


def unsplit_repeats(t: Any, head_dim: Optional[int]) -> Any:
    """A stacked decode-cache leaf (repeats, B, ...) laid out so that its
    repeats and sequence dims are whole: batch over the data axes, heads
    (``head_dim`` of one layer's leaf) over the model axis where they
    divide.  The rules split a stacked leaf's leading dims (the repeats over
    data, the sequence over the model axis, as JAX's do), and ``t[r]`` of a
    split repeats dim is a gathered copy, which a step's in-place write
    would miss.  Any other ``t`` is returned as it is."""
    if not isinstance(t, DTensor):
        return t
    mesh = t.device_mesh
    data, model = mesh_roles(mesh)
    want: List[Any] = [Replicate()] * mesh.ndim
    if t.shape[1] % math.prod(mesh.size(i) for i in data) == 0:
        for i in data:
            want[i] = Shard(1)
    if model is not None and head_dim is not None and t.shape[head_dim + 1] % mesh.size(model) == 0:
        want[model] = Shard(head_dim + 1)
    return t if tuple(want) == tuple(t.placements) else t.redistribute(mesh, want)


class _GradLayout(torch.autograd.Function):
    """The identity; its backward lays the gradient out as the forward's
    output was (a pending sum's gradient replicated)."""

    @staticmethod
    def forward(ctx, x):
        # a pending sum's gradient is the same on every rank
        ctx.placements = [Replicate() if isinstance(p, Partial) else p for p in x.placements]
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        if tuple(g.placements) == tuple(ctx.placements):
            return g
        return g.redistribute(g.device_mesh, ctx.placements)


def keep_grad_layout(x: Any) -> Any:
    """``x``; on a mesh its gradient comes back in ``x``'s layout.  A
    reshape that merges or splits a dim runs its backward as a view of the
    gradient, which a split in the wrong place (a head split mid-way)
    refuses."""
    if isinstance(x, DTensor) and x.requires_grad:
        return _GradLayout.apply(x)
    return x
