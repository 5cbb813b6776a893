"""Where a ``DTensor`` becomes local: the kernels' boundary on a mesh.

Each wrapper in ``<kernel>/ops.py`` given ``DTensor``s hands them to one of
the functions here, which take them local with
``torch.distributed.tensor.experimental.local_map`` and call the wrapper
again on the local tensors - so the local call does exactly what a plain
call does: the ctypes kernel on CUDA, the plain version on the CPU, the
``_shape`` custom op on ``meta``.  The results are wrapped back.  The
autograd ``Function``s (``FlashAttention``, ``SSDScan``, ``MoERouter``,
``CausalConv``, ``RMSNorm``) are applied to the local tensors, so their
backward kernels run on shards too.

The placements declared are the kernel's own: the batch dim over the data
axes (when they divide it), the heads over the model axis where the heads
divide it, everything else replicated.  A mesh dim of size 1 keeps the
input's own placement (a pending sum is reduced), so a (1, 1) mesh moves
nothing and runs the plain call's numbers.

Grouped heads (``head_split``).  When the q heads divide the model axis but
the kv heads do not (llama3-405b: 128 q and 8 kv heads on 16), k and v stay
whole on the model axis and each rank slices the kv heads its q heads use:
rank r holds q heads r*per .. (r+1)*per - 1, which use kv head r*per // G
(the local call's G is per).  Their gradient is then a sum over the model
axis (``Partial``).  The SSD scan's B and C groups follow the same rule.
"""
from __future__ import annotations

import math
from typing import Any, Callable, List, Optional, Sequence, Tuple

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from ..dist.context import mesh_roles


def head_split(heads: int, groups: int, m: int) -> str:
    """How ``heads`` heads that share ``groups`` kv heads (or B/C groups)
    split over a model axis of ``m``: "both" (heads and groups split),
    "heads" (heads split, each rank slices the one group its heads use) or
    "none" (both whole)."""
    if m == 1:
        return "both"
    if heads % m:
        return "none"
    if groups % m == 0:
        return "both"
    return "heads" if (heads // groups) % (heads // m) == 0 else "none"


class _Layout:
    """The mesh's data and model dims and the model axis's size and this
    rank's coordinate on it."""

    def __init__(self, mesh: Any):
        self.mesh = mesh
        self.data, self.model = mesh_roles(mesh)
        self.m = mesh.size(self.model) if self.model is not None else 1
        self.rank = mesh.get_local_rank(self.model) if self.m > 1 else 0

    def place(self, t: Any, batch_dim: Optional[int], head_dim: Optional[int] = None,
              grad: bool = False, partial_model: bool = False,
              partial_data: bool = False) -> List[Any]:
        """One placement per mesh dim for ``t``: ``Shard(batch_dim)`` on the
        data dims when they divide it, ``Shard(head_dim)`` on the model dim;
        ``grad`` gives the gradient's (``Partial`` where asked)."""
        mesh = self.mesh
        out: List[Any] = [Replicate()] * mesh.ndim
        n = math.prod(mesh.size(i) for i in self.data)
        for i in self.data:
            if batch_dim is not None and t.shape[batch_dim] % n == 0:
                out[i] = Shard(batch_dim)
            elif grad and partial_data:
                out[i] = Partial()
        if self.model is not None:
            if head_dim is not None:
                out[self.model] = Shard(head_dim)
            elif grad and partial_model:
                out[self.model] = Partial()
        for i in range(mesh.ndim):  # a dim of one device moves nothing
            if mesh.size(i) == 1:
                cur = t.placements[i] if isinstance(t, DTensor) else Replicate()
                out[i] = Replicate() if isinstance(cur, Partial) else cur
        return out


class _ContiguousGrad(torch.autograd.Function):
    """The identity, whose backward makes the gradient contiguous: DTensor
    runs a reshape's backward as a view of the local gradient, which a
    transposed local layout (a product's backward) cannot take."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.contiguous()


def contiguous_grads(fn: Callable) -> Callable:
    """``fn`` whose tensor arguments that need a gradient pass through
    ``_ContiguousGrad``: the gradients that leave a local region are
    contiguous."""

    def run(*args, **kw):
        args = [_ContiguousGrad.apply(a) if isinstance(a, torch.Tensor) and a.requires_grad
                else a for a in args]
        return fn(*args, **kw)

    return run


def _call(fn: Callable, lay: _Layout, args: Sequence[Any], ins: Sequence[Any],
          grads: Sequence[Any], outs: Sequence[Any]) -> Any:
    wrapped = local_map(contiguous_grads(fn), out_placements=tuple(outs),
                        in_placements=tuple(ins),
                        in_grad_placements=tuple(grads), device_mesh=lay.mesh,
                        redistribute_inputs=True)
    return wrapped(*args)


def _group_slice(t: torch.Tensor, dim: int, lay: _Layout, heads: int, groups: int) -> torch.Tensor:
    """The one group (kv head, B/C group) that this rank's heads use."""
    per, size = heads // lay.m, heads // groups
    return t.narrow(dim, lay.rank * per // size, 1).contiguous()


def grouped_heads(fn: Callable, q: Any, kv: Sequence[Any], q_head_dim: int, kv_head_dim: int,
                  tail: Sequence[Any] = (), **kw: Any) -> Any:
    """``fn(q, *kv, *tail, **kw)`` on local shards: q (batch first, heads at
    ``q_head_dim``), ``kv`` (k and v; batch first, kv heads at
    ``kv_head_dim``), ``tail`` (batch-first tensors such as decode's
    ``lengths``); one output laid out like q.  Flash attention and decode."""
    lay = _Layout(q.device_mesh)
    heads, groups = q.shape[q_head_dim], kv[0].shape[kv_head_dim]
    mode = head_split(heads, groups, lay.m)
    qh = q_head_dim if mode != "none" else None
    kh = kv_head_dim if mode == "both" else None
    ins = [lay.place(q, 0, qh)] + [lay.place(t, 0, kh) for t in kv] + [
        lay.place(t, 0) for t in tail]
    grads = ([ins[0]] + [lay.place(t, 0, kh, grad=True, partial_model=mode == "heads")
                         for t in kv] + ins[1 + len(kv):])

    def local(q_, *rest):
        kv_ = rest[:len(kv)]
        if mode == "heads":
            kv_ = [_group_slice(t, kv_head_dim, lay, heads, groups) for t in kv_]
        return fn(q_, *kv_, *rest[len(kv):], **kw)

    return _call(local, lay, [q, *kv, *tail], ins, grads, [ins[0]])


def ssd_heads(fn: Callable, x: Any, dt: Any, a: Any, Bm: Any, Cm: Any, D: Any,
              **kw: Any) -> Tuple[Any, Any]:
    """``fn(x, dt, a, Bm, Cm, D, **kw)`` -> (y, h) on local shards: batch over
    the data axes, heads (and B/C groups) over the model axis by
    ``head_split``.  a and D have no batch dim: their gradient is a sum
    over the data axes."""
    lay = _Layout(x.device_mesh)
    heads, groups = x.shape[2], Bm.shape[2]
    mode = head_split(heads, groups, lay.m)
    hs = mode != "none"
    gh = 2 if mode == "both" else None
    x_pl, dt_pl = lay.place(x, 0, 2 if hs else None), lay.place(dt, 0, 2 if hs else None)
    vec = [lay.place(t, None, 0 if hs else None) for t in (a, D)]
    bc = [lay.place(t, 0, gh) for t in (Bm, Cm)]
    ins = [x_pl, dt_pl, vec[0], bc[0], bc[1], vec[1]]
    vec_g = [lay.place(t, None, 0 if hs else None, grad=True, partial_data=True) for t in (a, D)]
    bc_g = [lay.place(t, 0, gh, grad=True, partial_model=mode == "heads") for t in (Bm, Cm)]
    grads = [x_pl, dt_pl, vec_g[0], bc_g[0], bc_g[1], vec_g[1]]
    h_pl = lay.place(x, 0, 1 if hs else None)

    def local(x_, dt_, a_, B_, C_, D_):
        if mode == "heads":
            B_, C_ = (_group_slice(t, 2, lay, heads, groups) for t in (B_, C_))
        return fn(x_, dt_, a_, B_, C_, D_, **kw)

    return _call(local, lay, [x, dt, a, Bm, Cm, D], ins, grads, [x_pl, h_pl])


def causal_conv(fn: Callable, x: Any, w: Any, b: Any, **kw: Any) -> Tuple[Any, Any, Any]:
    """``fn(x, w, b, **kw)`` -> (xs, B, C) on local shards: batch over the data
    axes, time and channels whole (a causal conv cannot be cut along time
    without a halo); w and b whole, their gradient a sum over the data
    axes."""
    lay = _Layout(x.device_mesh)
    x_pl = lay.place(x, 0)
    ins = [x_pl] + [lay.place(t, None) for t in (w, b)]
    grads = [x_pl] + [lay.place(t, None, grad=True, partial_data=True) for t in (w, b)]
    return _call(lambda *a: fn(*a, **kw), lay, [x, w, b], ins, grads, [x_pl] * 3)


def rms_norm(fn: Callable, x: Any, w: Any, gate: Any, **kw: Any) -> Any:
    """``fn(x, w, gate=gate, **kw)`` on local shards: batch over the data
    axes, the normalised (last) dim whole, a split of another dim on the
    model axis kept (qk-norm's heads); the gate laid out as x; w whole, its
    gradient a sum over the axes that split the rows."""
    lay = _Layout(x.device_mesh)
    keep = None
    if lay.model is not None and lay.m > 1:
        cur = x.placements[lay.model]
        if isinstance(cur, Shard) and 0 < cur.dim % x.ndim < x.ndim - 1:
            keep = cur.dim % x.ndim
    x_pl = lay.place(x, 0, keep)
    split = any(isinstance(x_pl[i], Shard) for i in lay.data)
    w_pl = lay.place(w, None)
    w_g = lay.place(w, None, grad=True, partial_data=split, partial_model=keep is not None)
    # x's and the gate's gradients leave whole on a mesh dim of one device,
    # where a split and a copy hold the same.  Left as x's Shard(0) there,
    # the batch split reaches the embedding's backward, DTensor's index_put,
    # on a (1, 1) mesh; torch 2.11's index_put rule maps a Shard(0) of the
    # (B, S, d) gradient onto the (V, d) table's dim 0 + 2 - 3 = -1 and raises
    # ("must be normalized").  Above one device the gradient reaches the
    # embedding as the plain ops hand it (tests/test_torch_rms_norm.py).
    x_g = [Replicate() if lay.mesh.size(i) == 1 else p for i, p in enumerate(x_pl)]
    if gate is None:
        return _call(lambda x_, w_: fn(x_, w_, gate=None, **kw), lay, [x, w], [x_pl, w_pl],
                     [x_g, w_g], [x_pl])
    return _call(lambda x_, w_, g_: fn(x_, w_, gate=g_, **kw), lay, [x, w, gate],
                 [x_pl, w_pl, x_pl], [x_g, w_g, x_g], [x_pl])


def replicated(fn: Callable, args: Sequence[Any], n_out: int, **kw: Any) -> Any:
    """``fn(*args, **kw)`` with every tensor whole on every rank (the router:
    its slots are a prefix over all the tokens, and its top-k needs every
    expert)."""
    lay = _Layout(next(a for a in args if isinstance(a, DTensor)).device_mesh)
    ins = [lay.place(a, None) if isinstance(a, torch.Tensor) else None for a in args]
    out = [[Replicate()] * lay.mesh.ndim] * n_out
    return _call(lambda *a: fn(*a, **kw), lay, list(args), ins, ins, out)


def batched(fn: Callable, args: Sequence[Any], batch_args: int, **kw: Any) -> Any:
    """``fn(*args, **kw)`` with the first ``batch_args`` tensors split over
    the data axes on their leading (batch) dim, the others whole; one
    batch-first output (the augment kernel)."""
    lay = _Layout(args[0].device_mesh)
    ins = [lay.place(a, 0 if i < batch_args else None) for i, a in enumerate(args)]
    return _call(lambda *a: fn(*a, **kw), lay, list(args), ins, ins, [ins[0]])


def adamw_update(fn: Callable, p: Any, g: Any, m: Any, v: Any, scale: Any,
                       **kw: Any) -> None:
    """``fn(p, g, m, v, scale, **kw)`` in place on each rank's local shards
    (the AdamW update): g is first laid out as p (a pending sum reduced);
    m and v must have p's placements; the scale is a plain 0-d tensor, the
    same on every rank."""
    mesh, pl = p.device_mesh, tuple(p.placements)
    if not isinstance(g, DTensor):
        raise ValueError("adamw_update: a DTensor leaf takes a DTensor gradient")
    for name, t in (("m", m), ("v", v)):
        if not isinstance(t, DTensor) or tuple(t.placements) != pl:
            raise ValueError(f"adamw_update: {name} must be laid out as the leaf, {pl}; got "
                             f"{getattr(t, 'placements', 'a plain tensor')}")
    if tuple(g.placements) != pl:
        g = g.redistribute(mesh, pl)
    fn(p.to_local(), g.to_local(), m.to_local(), v.to_local(), scale, **kw)
