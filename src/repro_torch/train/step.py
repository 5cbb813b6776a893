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

from .. import DeviceLike
from ..bridge import map_with_paths
from ..models import Model
from . import optimizer as opt

PAD_ID = 0  # label id treated as padding (masked out of the loss)


def cross_entropy(
    logits: torch.Tensor,  # (B, S, V) f32
    labels: torch.Tensor,  # (B, S) integer
    z_loss: float = 1e-4,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    labels = labels.long()
    mask = (labels != PAD_ID).float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None])[..., 0]
    nll = (lse - gold) * mask
    zl = z_loss * lse.square() * mask
    denom = torch.clamp(mask.sum(), min=1.0)
    loss = (nll + zl).sum() / denom
    with torch.no_grad():
        acc = ((logits.argmax(-1) == labels) * mask).sum() / denom
    return loss, {"loss": nll.sum() / denom, "z_loss": zl.sum() / denom, "accuracy": acc}


def make_loss_fn(model: Model) -> Callable:
    def loss_fn(params: Any, batch: Dict[str, Any]) -> Tuple[torch.Tensor, Dict]:
        logits = model.forward(params, batch)
        return cross_entropy(logits, batch["labels"])

    return loss_fn


def _graph_leaf(p: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    leaf = p.detach().requires_grad_(True)
    leaf.grad = g
    return leaf


def _graph_params(params: Any, grads: Any, repeats: Dict[str, int]) -> Any:
    """The params tree the model runs on under autograd: per leaf an
    autograd leaf sharing the parameter's storage with ``.grad`` preset to
    the gradient buffer; a stacked leaf becomes a list of per-repeat leaves
    (the model's ``_index`` takes element r of it)."""

    def walk(p, g, stacked: bool):
        if isinstance(p, dict):
            return {k: walk(p[k], g[k], stacked) for k in p}
        if isinstance(p, list):
            return [walk(a, b, stacked) for a, b in zip(p, g)]
        if stacked:
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
