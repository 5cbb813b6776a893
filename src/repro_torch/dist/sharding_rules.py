"""Parameter / optimizer / batch / cache specs (twin of the JAX package's
``repro/dist/sharding_rules.py``).

Megatron-style tensor parallelism over ``plan.model_axis`` plus FSDP (ZeRO-3)
over ``plan.fsdp_axis``:

  * projections IN to a wide space (wq/wk/wv, mlp w1/w3, ssm in_proj,
    lm_head) shard the wide output dim over the model axis and the d_model
    input dim over the fsdp axis;
  * projections OUT of the wide space (wo, mlp w2, ssm out_proj) shard the
    wide input dim over the model axis and d_model over fsdp;
  * MoE expert stacks shard the expert dim over ``plan.moe_expert_axis``
    (the ff dim also over the model axis when the expert axis is another
    mesh axis);
  * the embedding shards vocab over the model axis, d_model over fsdp;
  * 1-D params (norm scales, biases, A_log/D/dt_bias) replicate.
  * The port's own leaves (``use_bias``, ``norm_type="layer"``; JAX has
    none of them): a projection's bias follows its weight's output split
    (bq/bk/bv and the MLP's b1 over the model axis, bo and b2 over
    fsdp), and a LayerNorm's scale and shift replicate, stacked or not.

Every axis assignment is divisibility-gated: a dim that the mesh axis does
not divide is replicated.  Stacked leaves (a repeated group's leading
repeats dim) align each rule to the TRAILING dims and replicate the leading
ones; a stacked 1-D leaf such as ``q_norm`` (L, hd) matches no rule and has 2
dims, so it takes the generic (fsdp, model) split, as in JAX.

The trees are the port's (nested dicts and lists, JAX's keys); a leaf is
identified by the dict keys on its path (list indices are skipped, as JAX's
``_path_names`` skips sequence keys).  The mesh may be a ``DeviceMesh`` or an
``AbstractMesh``: only its axis names and sizes are read.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple

from ..bridge import flatten_with_paths
from ..models.config import ModelConfig
from .context import NamedSharding, P, ShardingPlan, _axes_size, mesh_axis_sizes

# role tokens for trailing dims: F = fsdp axis, M = model axis,
# E = expert axis, X = model axis only if the expert axis differs from it,
# None = replicate
_Role = Optional[str]

_IN_PROJ: Tuple[_Role, ...] = ("F", "M")
_OUT_PROJ: Tuple[_Role, ...] = ("M", "F")

_LEAF_RULES: Dict[str, Tuple[_Role, ...]] = {
    "wq": _IN_PROJ,
    "wk": _IN_PROJ,
    "wv": _IN_PROJ,
    "wo": _OUT_PROJ,
    "in_proj": _IN_PROJ,
    "out_proj": _OUT_PROJ,
    "lm_head": _IN_PROJ,
    "embed": ("M", "F"),  # Megatron vocab-parallel embedding
    "router": ("F", None),
    "conv_w": (None, None),
    "bq": ("M",),
    "bk": ("M",),
    "bv": ("M",),
    "bo": ("F",),
    "b1": ("M",),
    "b2": ("F",),
}

# a LayerNorm's leaves (``norm_type="layer"``): replicated
_LAYER_NORM_LEAVES = ("ln1", "ln2", "final_norm", "ln1_bias", "ln2_bias", "final_norm_bias")

_MOE_RULES: Dict[str, Tuple[_Role, ...]] = {
    "w1": ("E", "F", "X"),
    "w3": ("E", "F", "X"),
    "w2": ("E", "X", "F"),
}

_MLP_RULES: Dict[str, Tuple[_Role, ...]] = {
    "w1": _IN_PROJ,
    "w3": _IN_PROJ,
    "w2": _OUT_PROJ,
}


def _path_names(path: Sequence[Any]) -> Tuple[str, ...]:
    return tuple(k for k in path if isinstance(k, str))


def _trailing_roles(names: Tuple[str, ...], cfg: ModelConfig) -> Optional[Tuple[_Role, ...]]:
    leaf = names[-1] if names else ""
    if cfg.norm_type == "layer" and leaf in _LAYER_NORM_LEAVES:
        return (None,)
    if leaf in ("w1", "w2", "w3"):
        return _MOE_RULES[leaf] if "moe" in names else _MLP_RULES[leaf]
    return _LEAF_RULES.get(leaf)


def _role_to_axes(role: _Role, plan: ShardingPlan) -> Tuple[str, ...]:
    if role == "F":
        return plan.fsdp_axes
    if role == "M":
        return (plan.model_axis,)
    if role == "E":
        return (plan.moe_expert_axis,)
    if role == "X":
        if plan.moe_expert_axis != plan.model_axis:
            return (plan.model_axis,)
    return ()


def _axes_part(axes: Tuple[str, ...]) -> Any:
    return axes[0] if len(axes) == 1 else tuple(axes)


def _build_spec(shape: Sequence[int], roles: Tuple[_Role, ...], plan: ShardingPlan,
                mesh: Any) -> P:
    """Align ``roles`` to the trailing dims; divisibility-gate each axis."""
    sizes = mesh_axis_sizes(mesh)
    ndim = len(shape)
    lead = ndim - len(roles)
    if lead < 0:  # rule written for more dims than the leaf has: replicate
        return P()
    parts: list = [None] * lead
    used: set = set()
    for dim, role in zip(shape[lead:], roles):
        axes = _role_to_axes(role, plan)
        size = _axes_size(sizes, axes) if axes else 0
        if axes and size > 0 and dim % size == 0 and not (set(axes) & used):
            used.update(axes)
            parts.append(_axes_part(axes))
        else:
            parts.append(None)
    while parts and parts[-1] is None:
        parts.pop()
    return P(*parts)


def param_spec(path: Sequence[Any], leaf: Any, cfg: ModelConfig, plan: ShardingPlan,
               mesh: Any) -> NamedSharding:
    """Sharding of one parameter leaf, identified by its tree path (a
    sequence of dict keys and list indices)."""
    shape = tuple(getattr(leaf, "shape", ()))
    roles = _trailing_roles(_path_names(path), cfg)
    if roles is None:
        if len(shape) >= 2:  # unknown matrix: generic (fsdp, model) split
            roles = _IN_PROJ
        else:  # scalars / vectors replicate
            return NamedSharding(mesh, P())
    return NamedSharding(mesh, _build_spec(shape, roles, plan, mesh))


def map_with_path(tree: Any, fn, path: Tuple[Any, ...] = ()) -> Any:
    """The tree with each leaf replaced by ``fn(path, leaf)``; ``path`` is
    the tuple of dict keys and list indices leading to it."""
    if isinstance(tree, dict):
        return {k: map_with_path(v, fn, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [map_with_path(v, fn, path + (i,)) for i, v in enumerate(tree)]
    return fn(path, tree)


def make_param_shardings(mesh: Any, pshape: Any, cfg: ModelConfig, plan: ShardingPlan) -> Any:
    """A ``NamedSharding`` for every leaf of the params (shape-)tree."""
    return map_with_path(pshape, lambda path, leaf: param_spec(path, leaf, cfg, plan, mesh))


def make_opt_shardings(mesh: Any, oshape: Any, cfg: ModelConfig, plan: ShardingPlan) -> Any:
    """Optimizer-state shardings: the m/v moment trees mirror the param
    shardings; the step counter and any other scalar replicate."""

    def one(path, leaf):
        if path and path[0] in ("m", "v", "mu", "nu"):
            return param_spec(path[1:], leaf, cfg, plan, mesh)
        return NamedSharding(mesh, P())

    return map_with_path(oshape, one)


def batch_sharding(mesh: Any, plan: ShardingPlan, in_specs: Any) -> Any:
    """Input batches shard their leading (global batch) dim over the data
    axes; all other dims replicate."""
    data = tuple(plan.data_axes)
    dsize = _axes_size(mesh_axis_sizes(mesh), data)

    def one(_, leaf):
        shape = tuple(getattr(leaf, "shape", ()))
        if shape and dsize > 0 and shape[0] % dsize == 0:
            return NamedSharding(mesh, P(_axes_part(data)))
        return NamedSharding(mesh, P())

    return map_with_path(in_specs, one)


# cache leaf name -> index of its heads dim (the dim sharded over the model
# axis): KV caches are (B, S, Hkv, D), SSM state is (B, H, N, P).  Conv tails
# ("conv": (B, K-1, Ch)) and anything unrecognized get batch-only.
_CACHE_HEAD_DIM = {"k": 2, "v": 2, "h": 1}


def cache_sharding(mesh: Any, plan: ShardingPlan, cache_shape: Any, cfg: ModelConfig) -> Any:
    """KV / SSM decode caches: batch over the data axes; the heads dim,
    identified by leaf NAME as ``param_spec`` keys its rules, over the model
    axis when it divides."""
    data = tuple(plan.data_axes)
    sizes = mesh_axis_sizes(mesh)
    dsize = _axes_size(sizes, data)
    msize = _axes_size(sizes, (plan.model_axis,))

    def one(path, leaf):
        shape = tuple(getattr(leaf, "shape", ()))
        parts: list = [None] * len(shape)
        if shape and dsize > 0 and shape[0] % dsize == 0:
            parts[0] = _axes_part(data)
        names = _path_names(path)
        hdim = _CACHE_HEAD_DIM.get(names[-1]) if names else None
        if hdim is not None and hdim < len(shape) and msize > 1 and shape[hdim] % msize == 0:
            parts[hdim] = plan.model_axis
        while parts and parts[-1] is None:
            parts.pop()
        return NamedSharding(mesh, P(*parts))

    return map_with_path(cache_shape, one)


def sharded_nbytes(tree: Any, shardings: Any) -> int:
    """Bytes of one device's shards of the tensor leaves of ``tree`` (the
    sum of ``shard_shape`` bytes: the twin of JAX's per-device argument
    size)."""
    flat = dict(flatten_with_paths(shardings))
    total = 0
    for key, leaf in flatten_with_paths(tree):
        if hasattr(leaf, "shape") and hasattr(leaf, "element_size"):
            n = 1
            for s in flat[key].shard_shape(tuple(leaf.shape)):
                n *= s
            total += n * leaf.element_size()
    return total
