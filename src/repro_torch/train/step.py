"""Train-step factory: loss, gradients, AdamW update and microbatch
accumulation (twin of the JAX package's ``repro/train/step.py``).

``make_train_step(model, opt_cfg, microbatches)`` returns ``step(state,
batch) -> (state, metrics)`` with ``state = {"params", "opt": {"step", "m",
"v"}}``, JAX's keys and layout.  The step updates ``state`` IN PLACE and
returns it (the JAX step returns a new state).

Gradients.  The port keeps JAX's stacked layout (a repeated group's leaves
carry a leading repeats dim).  Autograd of ``w[r]`` would scatter each
layer's gradient into a zero tensor of the whole stacked leaf, once per
layer; instead the step hands the model one autograd leaf per repeat, a
detached view ``w[r]`` of the parameter's storage whose ``.grad`` is preset to
the view ``G[r]`` of a stacked gradient buffer ``G``.  Autograd accumulates
into ``.grad`` in place, so every layer's gradient lands in ``G`` with no
copy, and microbatches add up there.  The buffers are allocated at the first
step and zeroed at each.

Microbatches (``microbatches > 1``) split the batch's leading dim into
contiguous slices, as JAX's ``reshape((microbatches, -1) + ...)`` does; their
gradients are summed in f32 (in ``G`` for f32 parameters, in an f32
accumulator for narrower ones) and divided by ``microbatches``, and the
metrics are JAX's for that path: ``loss`` and ``total_loss`` the mean
microbatch loss, ``z_loss`` and ``accuracy`` zeros.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from .. import DeviceLike
from ..bridge import map_with_paths
from ..models import Model
from . import optimizer as opt

PAD_ID = 0  # label id treated as padding (masked out of the loss)


def _vocab_dim(logits: Any) -> Optional[int]:
    """The mesh dim that splits the vocabulary of ``DTensor`` logits over
    more than one device, or None (a plain tensor, or the vocabulary whole
    on every rank)."""
    if not isinstance(logits, DTensor):
        return None
    dims = [i for i, p in enumerate(logits.placements) if isinstance(p, Shard)
            and p.dim % logits.ndim == logits.ndim - 1 and logits.device_mesh.size(i) > 1]
    return dims[0] if len(dims) == 1 else None


def _vocab_parallel(logits: DTensor, labels: Any, vdim: int):
    """(log-sum-exp, gold logit, max) of logits whose vocabulary mesh dim
    ``vdim`` splits (Megatron's vocab-parallel loss, what XLA's partitioner
    emits for the reference: the max and the sum of exps reduced over the
    vocabulary shards by an all-reduce each); the gold logit is each rank's
    masked pick of its own vocabulary range, summed over the shards."""
    mesh = logits.device_mesh
    # each other mesh dim keeps its split of (B, S); a pending sum there
    # (a product whose contraction it split) takes the labels' split
    lab = [Replicate() if i == vdim else p if not isinstance(p, Partial) else
           labels.placements[i] if isinstance(labels, DTensor) else Replicate()
           for i, p in enumerate(logits.placements)]
    logits = logits.redistribute(mesh, [p if i == vdim else lab[i]
                                        for i, p in enumerate(logits.placements)])
    m = logits.detach().amax(dim=-1)
    lse = m + torch.log(torch.exp(logits - m[..., None]).sum(dim=-1))
    v_local = logits.shape[-1] // mesh.size(vdim)
    lo = mesh.get_local_rank(vdim) * v_local
    out = [Partial() if i == vdim else p for i, p in enumerate(lab)]

    def pick(lg, lb):
        idx = lb - lo
        inside = (idx >= 0) & (idx < v_local)
        got = torch.gather(lg, -1, idx.clamp(0, v_local - 1)[..., None])[..., 0]
        return torch.where(inside, got, torch.zeros((), dtype=got.dtype, device=got.device))

    gold = local_map(pick, out_placements=(out,), in_placements=(logits.placements, lab),
                     device_mesh=mesh, redistribute_inputs=True)(logits, labels)
    return lse, gold, m


def cross_entropy(
    logits: torch.Tensor,  # (B, S, V) f32
    labels: torch.Tensor,  # (B, S) integer
    z_loss: float = 1e-4,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Mean next-token loss with z-loss.  On logits whose vocabulary a mesh
    dim splits it is vocab-parallel (``_vocab_parallel``); its accuracy
    counts a token whose gold logit is the row's maximum (argmax up to
    exact ties)."""
    labels = labels.long()
    mask = (labels != PAD_ID).float()
    vdim = _vocab_dim(logits)
    if vdim is None:
        lse = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, labels[..., None])[..., 0]
    else:
        lse, gold, top = _vocab_parallel(logits, labels, vdim)
    nll = (lse - gold) * mask
    zl = z_loss * lse.square() * mask
    denom = torch.clamp(mask.sum(), min=1.0)
    loss = (nll + zl).sum() / denom
    with torch.no_grad():
        hit = logits.argmax(-1) == labels if vdim is None else gold >= top
        acc = (hit * mask).sum() / denom
    return loss, {"loss": nll.sum() / denom, "z_loss": zl.sum() / denom, "accuracy": acc}


def make_loss_fn(model: Model) -> Callable:
    def loss_fn(params: Any, batch: Dict[str, Any]) -> Tuple[torch.Tensor, Dict]:
        logits = model.forward(params, batch)
        return cross_entropy(logits, batch["labels"])

    return loss_fn


def _unit_dims_whole(t: Any) -> Any:
    """A ``DTensor`` read as whole (``Replicate``) on every mesh dim of one
    device: the same local tensor, no copy (``p[r]`` of it is then a view);
    any other ``t`` as it is."""
    if not isinstance(t, DTensor):
        return t
    mesh = t.device_mesh
    want = [Replicate() if mesh.size(i) == 1 else p for i, p in enumerate(t.placements)]
    if tuple(want) == tuple(t.placements):
        return t
    return DTensor.from_local(t.to_local(), mesh, want, run_check=False, shape=t.shape,
                              stride=t.stride())


def _graph_leaf(p: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    leaf = p.detach().requires_grad_(True)
    leaf.grad = g
    return leaf


def _graph_params(params: Any, grads: Any, repeats: Dict[str, int]) -> Any:
    """The params tree the model runs on under autograd: per leaf an
    autograd leaf sharing the parameter's storage with ``.grad`` preset to
    the gradient buffer; a stacked leaf becomes a list of per-repeat leaves
    (the model's ``_index`` takes element r of it).  A ``DTensor`` whose
    repeats dim a mesh dim of more than one device splits stays one leaf:
    ``p[r]`` of it is a gathered copy, not a view, so the model indexes it
    under autograd."""

    def walk(p, g, stacked: bool):
        if isinstance(p, dict):
            return {k: walk(p[k], g[k], stacked) for k in p}
        if isinstance(p, list):
            return [walk(a, b, stacked) for a, b in zip(p, g)]
        p, g = _unit_dims_whole(p), _unit_dims_whole(g)
        if stacked and not (isinstance(p, DTensor) and any(
                isinstance(s, Shard) and s.dim == 0 for s in p.placements)):
            return [_graph_leaf(p[r], g[r]) for r in range(p.shape[0])]
        return _graph_leaf(p, g)

    return {k: walk(v, grads[k], repeats.get(k, 1) > 1) for k, v in params.items()}


def _map2(a: Any, b: Any, fn) -> Any:
    if isinstance(a, dict):
        return {k: _map2(a[k], b[k], fn) for k in a}
    if isinstance(a, list):
        return [_map2(x, y, fn) for x, y in zip(a, b)]
    return fn(a, b)


def _shapes(tree: Any) -> List[Tuple]:
    return [(tuple(t.shape), t.dtype, t.device) for t in opt._leaves(tree)]


def make_train_step(
    model: Model,
    opt_cfg: Optional[opt.AdamWConfig] = None,
    microbatches: int = 1,
) -> Callable:
    """Returns step(train_state, batch) -> (train_state, metrics), updating
    ``train_state`` in place."""
    opt_cfg = opt_cfg or opt.AdamWConfig()
    loss_fn = make_loss_fn(model)
    repeats = model.repeats
    buffers: Dict[str, Any] = {}

    def grad_buffers(params: Any) -> Any:
        if buffers.get("shapes") != _shapes(params):
            buffers.clear()  # free the old buffers before allocating new ones
            buffers["grads"] = map_with_paths(params, lambda _, p: torch.zeros_like(p))
            buffers["shapes"] = _shapes(params)
        else:
            for g in opt._leaves(buffers["grads"]):
                g.zero_()
        return buffers["grads"]

    def step(state: Dict[str, Any], batch: Dict[str, Any]):
        params = state["params"]
        grads = grad_buffers(params)
        if microbatches <= 1:
            loss, aux = loss_fn(_graph_params(params, grads, repeats), batch)
            loss.backward()
            loss = loss.detach()
            aux = {k: v.detach() for k, v in aux.items()}
        else:
            # f32 sums: straight into the f32 buffers, through f32 copies for others
            acc = _map2(params, grads, lambda p, g: g if g.dtype == torch.float32
                        else torch.zeros(g.shape, dtype=torch.float32, device=g.device))
            loss = None
            for i in range(microbatches):
                mb = {k: v.reshape((microbatches, -1) + tuple(v.shape[1:]))[i]
                      for k, v in batch.items()}
                l, _ = loss_fn(_graph_params(params, grads, repeats), mb)
                l.backward()
                loss = l.detach() if loss is None else loss + l.detach()

                def fold(a, g):
                    if a is not g:
                        a.add_(g)
                        g.zero_()

                _map2(acc, grads, fold)
            grads = acc
            for g in opt._leaves(grads):
                g.div_(microbatches)
            loss = loss / microbatches
            zero = torch.zeros((), device=loss.device)
            aux = {"loss": loss, "z_loss": zero, "accuracy": zero.clone()}
        _, new_opt, om = opt.apply_updates(params, grads, state["opt"], opt_cfg)
        state["opt"] = new_opt
        metrics = {**aux, **om, "total_loss": loss}
        return state, metrics

    return step


def make_eval_step(model: Model) -> Callable:
    loss_fn = make_loss_fn(model)

    @torch.no_grad()
    def step(params: Any, batch: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        _, aux = loss_fn(params, batch)
        return aux

    return step


def init_train_state(
    model: Model, generator: Any = 0, opt_cfg: Optional[opt.AdamWConfig] = None,
    device: DeviceLike = None,
) -> Dict[str, Any]:
    """Random parameters from ``generator`` (a ``torch.Generator`` or a seed)
    on ``device`` (CUDA unless the caller asks for ``"cpu"``), and AdamW
    state for them."""
    params = model.init(generator, device=device)
    return {"params": params, "opt": opt.init_state(params, opt_cfg or opt.AdamWConfig())}
