"""The plain reference's shared parts: weights made from the seed, norms,
the loss, AdamW and the three steps the reference takes.

Plain PyTorch in float32, with TF32 off: it imports nothing of the program
(``repro_torch``), of ``repro`` or of ``jax``, and takes nothing the program
made.  The benchmark makes the weights and the batches from the seed and hands
the same to both sides; the reference works out the rest again.  Each model
family's layers live in ``portbench/families/<family>.py``.

Weights.  Every parameter lives in one flat f32 buffer, drawn from the seed in
blocks of ``BLOCK`` values on the device (one ``normal_`` a block, each block
from its own generator), then shaped leaf by leaf by the family's
``init_rules``.  Any piece of the buffer can be drawn again alone, so the change of a
parameter since the start is read without a second copy of the weights.

The controls, each the reference in the program's place at a precision below
the one the configuration states.  ``precision="fp8"`` runs the same steps in
float8 e4m3 where the program computes in bf16: every matmul's operands and
product (and the gradients' products), and the activations the program keeps
in bf16 (the embedding's output, each layer's output, the SSD's y), rounded
to e4m3 with one scale a tensor.  ``precision="ssd_tf32"`` and
``"ssd_bf16"`` leave everything in f32 but the products of the SSD, which
the configuration states in f32: their operands, and the gradients that
reach them, rounded to TF32 or bf16 (``lowered_einsum``).

Faults, planted in the reference put in the program's place: "half_batch"
leaves half the batch out of the loss; "unchanged" is a step that leaves
the state as it was.
"""
from __future__ import annotations

import contextlib
import math
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence, Tuple

import torch
from torch.utils.checkpoint import checkpoint

BLOCK = 1 << 28  # values a generator call draws (1 GiB of f32)
LOSS_ROWS = 2048  # rows of the head and loss computed together


# ---------------------------------------------------------------------------
# weights from the seed
# ---------------------------------------------------------------------------
def block_seed(seed: int, i: int) -> int:
    return (int(seed) * 1_000_003 + 7_919 * i + 1) % (2 ** 63 - 1)


def raw_block(seed: int, i: int, n: int, device) -> torch.Tensor:
    """Block ``i`` of the seed's standard normals (``n`` values)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(block_seed(seed, i))
    return torch.empty(n, dtype=torch.float32, device=device).normal_(generator=gen)


class LeafTable:
    """Where each leaf lies in the flat buffer.  ``leaves`` is the family's
    ``leaf_shapes``: (path, shape, stacked); a stacked leaf has a leading
    layers dim, and each of its layers is a piece of its own."""

    def __init__(self, leaves: Sequence[Tuple[str, Tuple[int, ...], bool]]):
        self.entries: List[Tuple[str, Tuple[int, ...], bool, int, int]] = []
        off = 0
        for path, shape, stacked in leaves:
            n = math.prod(shape)
            self.entries.append((path, tuple(shape), stacked, off, n))
            off += n
        self.total = off

    def pieces(self) -> Iterator[Tuple[str, str, Tuple[int, ...], int, int]]:
        """(piece name, leaf path, piece shape, offset, numel): one piece a
        layer of a stacked leaf, else the leaf."""
        for path, shape, stacked, off, n in self.entries:
            if stacked:
                per = n // shape[0]
                for layer in range(shape[0]):
                    yield f"{path}[{layer}]", path, shape[1:], off + layer * per, per
            else:
                yield path, path, shape, off, n

    def shapes(self) -> Dict[str, Tuple[int, ...]]:
        return {path: shape for path, shape, *_ in self.entries}


def init_piece(rule: Tuple, shape: Tuple[int, ...], raw: torch.Tensor) -> torch.Tensor:
    """A piece's initial values from its raw standard normals, by ``rule``:
    ("normal", std); ("fan_in", c) (std c/sqrt of the second-last dim);
    ("ones",); ("zeros",); ("a_log", lo, hi) (log of A uniform in [lo, hi]);
    ("dt_bias", lo, hi) (the inverse softplus of dt, log-uniform in [lo,
    hi]).  A uniform draw is the normal CDF of the raw value."""
    kind = rule[0]
    if kind == "normal":
        return raw * rule[1]
    if kind == "fan_in":
        return raw * ((rule[1] if len(rule) > 1 else 1.0) / math.sqrt(shape[-2]))
    if kind == "ones":
        return torch.ones_like(raw)
    if kind == "zeros":
        return torch.zeros_like(raw)
    uniform = 0.5 * (1.0 + torch.erf(raw / math.sqrt(2.0)))
    if kind == "a_log":
        return torch.log(rule[1] + (rule[2] - rule[1]) * uniform)
    if kind == "dt_bias":
        dt = torch.exp(math.log(rule[1]) + (math.log(rule[2]) - math.log(rule[1])) * uniform)
        return dt + torch.log(-torch.expm1(-dt))
    raise ValueError(f"unknown init rule {rule!r}")


def leaf_rule(rules: Dict[str, Tuple], path: str) -> Tuple:
    return rules.get(path.rsplit("/", 1)[-1], ("fan_in",))


def make_flat(table: LeafTable, seed: int, device, rules: Dict[str, Tuple]) -> torch.Tensor:
    """The initial weights, in one flat f32 buffer on ``device``."""
    flat = torch.empty(table.total, dtype=torch.float32, device=device)
    for i, a in enumerate(range(0, table.total, BLOCK)):
        b = min(table.total, a + BLOCK)
        flat[a:b].copy_(raw_block(seed, i, b - a, device))
    for _, path, shape, off, n in table.pieces():
        view = flat[off:off + n]
        view.copy_(init_piece(leaf_rule(rules, path), shape, view))
    return flat


class InitialPieces:
    """The initial values of pieces drawn again from the seed, a block at a
    time (pieces asked for in buffer order draw each block once)."""

    def __init__(self, seed: int, device, rules: Dict[str, Tuple], total: int):
        self.seed, self.device, self.rules, self.total = seed, device, rules, total
        self._blocks: Dict[int, torch.Tensor] = {}

    def _block(self, i: int) -> torch.Tensor:
        if i not in self._blocks:
            self._blocks = {k: v for k, v in self._blocks.items() if k == i - 1}
            n = min(BLOCK, self.total - i * BLOCK)
            self._blocks[i] = raw_block(self.seed, i, n, self.device)
        return self._blocks[i]

    def get(self, path: str, shape: Tuple[int, ...], off: int, n: int) -> torch.Tensor:
        parts = []
        a = off
        while a < off + n:
            i = a // BLOCK
            b = min(off + n, (i + 1) * BLOCK)
            parts.append(self._block(i)[a - i * BLOCK:b - i * BLOCK])
            a = b
        raw = parts[0] if len(parts) == 1 else torch.cat(parts)
        return init_piece(leaf_rule(self.rules, path), shape, raw)


def tree_of(table: LeafTable, flat: torch.Tensor) -> Dict[str, Any]:
    """The nested tree of the program's layout: a path "group0/0/attn/wq"
    is ``tree["group0"][0]["attn"]["wq"]``; each leaf a view of ``flat``."""
    tree: Dict[str, Any] = {}
    for path, shape, _, off, n in table.entries:
        keys = path.split("/")
        node: Any = tree
        for key, nxt in zip(keys[:-1], keys[1:]):
            child = [] if nxt.isdigit() else {}
            if isinstance(node, list):
                idx = int(key)
                while len(node) <= idx:
                    node.append(None)
                if node[idx] is None:
                    node[idx] = child
                node = node[idx]
            else:
                node = node.setdefault(key, child)
        node[keys[-1]] = flat[off:off + n].view(shape)
    return tree


def tree_leaves(tree: Any, prefix: str = "") -> List[Tuple[str, Any]]:
    """(path, leaf) pairs of a nested dict/list tree, dict keys sorted."""
    if isinstance(tree, dict):
        return [pair for k in sorted(tree) for pair in tree_leaves(tree[k], f"{prefix}{k}/")]
    if isinstance(tree, (list, tuple)):
        return [pair for i, v in enumerate(tree) for pair in tree_leaves(v, f"{prefix}{i}/")]
    return [(prefix[:-1], tree)]


def piece_of(leaf: torch.Tensor, piece: str) -> torch.Tensor:
    """The piece ``path[l]`` of a stacked leaf is its layer l."""
    if piece.endswith("]"):
        return leaf[int(piece[piece.rindex("[") + 1:-1])]
    return leaf


def square_sum(t: torch.Tensor) -> float:
    """Sum of squares in f64, in slices of at most 2**26 values."""
    flat = t.reshape(-1)
    total = 0.0
    for a in range(0, flat.numel(), 1 << 26):
        total += float(flat[a:a + (1 << 26)].double().square().sum())
    return total


# ---------------------------------------------------------------------------
# layers shared by the families
# ---------------------------------------------------------------------------
def _q8(t: torch.Tensor) -> torch.Tensor:
    scale = t.detach().abs().amax().clamp(min=1e-30) / 448.0
    return (t / scale).clamp(-448.0, 448.0).to(torch.float8_e4m3fn).to(t.dtype) * scale


class _Q8MatMul(torch.autograd.Function):
    """a @ b in e4m3: both operands and the product rounded, as a program that
    computes and keeps its activations in e4m3 would; the gradient's products
    too (the activations' gradient rounded, the weights' kept in f32)."""

    @staticmethod
    def forward(ctx, a, b):
        aq, bq = _q8(a), _q8(b)
        ctx.save_for_backward(aq, bq)
        return _q8(aq @ bq)

    @staticmethod
    def backward(ctx, g):
        aq, bq = ctx.saved_tensors
        gq = _q8(g)
        ga = _q8(gq @ bq.transpose(-1, -2))
        gb = aq.reshape(-1, aq.shape[-1]).transpose(0, 1) @ gq.reshape(-1, gq.shape[-1])
        return ga, gb


class _Q8(torch.autograd.Function):
    """Rounds to e4m3 forward; the gradient passes as it is."""

    @staticmethod
    def forward(ctx, t):
        return _q8(t)

    @staticmethod
    def backward(ctx, g):
        return g


def mm(a: torch.Tensor, b: torch.Tensor, precision: str) -> torch.Tensor:
    """a (..., K) @ b (K, N) in f32, or in e4m3 for the control."""
    if precision == "fp8":
        return _Q8MatMul.apply(a, b)
    return a @ b


def rounded(t: torch.Tensor, precision: str) -> torch.Tensor:
    return _Q8.apply(t) if precision == "fp8" else t


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + eps) * w


def _round_tf32(t: torch.Tensor) -> torch.Tensor:
    """f32 to the nearest TF32 (10 bits of mantissa), kept as f32."""
    bits = t.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


ROUNDERS = {"tf32": _round_tf32,
            "bf16": lambda t: t.to(torch.bfloat16).to(t.dtype)}


class _RoundIn(torch.autograd.Function):
    """An operand rounded as a lower-precision matmul reads it."""

    @staticmethod
    def forward(ctx, t, mode):
        return ROUNDERS[mode](t)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _RoundGradOut(torch.autograd.Function):
    """A product as it is; the gradient reaching it rounded, as the
    lower-precision matmuls of the backward read it."""

    @staticmethod
    def forward(ctx, t, mode):
        ctx.mode = mode
        return t

    @staticmethod
    def backward(ctx, g):
        return ROUNDERS[ctx.mode](g), None


def lowered_einsum(eq: str, *ops: torch.Tensor, mode: Optional[str] = None) -> torch.Tensor:
    """``torch.einsum`` in f32, or with its operands and the gradients of its
    product rounded to ``mode`` ("tf32" or "bf16") and accumulated in f32."""
    if mode is None:
        return torch.einsum(eq, *ops)
    return _RoundGradOut.apply(torch.einsum(eq, *(_RoundIn.apply(o, mode) for o in ops)), mode)


def _loss_rows(x: torch.Tensor, head: torch.Tensor, labels: torch.Tensor, mask: torch.Tensor,
               z: float, precision: str) -> torch.Tensor:
    logits = mm(x, head, precision)
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[:, None])[:, 0]
    return (((lse - gold) + z * lse.square()) * mask).sum()


def lm_loss(x: torch.Tensor, head: torch.Tensor, labels: torch.Tensor, mask: torch.Tensor,
            z: float, precision: str) -> torch.Tensor:
    """Mean next-token loss with z-loss over the rows ``mask`` keeps; the
    head and the loss run ``LOSS_ROWS`` rows at a time, each recomputed in
    the backward."""
    d = x.shape[-1]
    x, labels, mask = x.reshape(-1, d), labels.reshape(-1).long(), mask.reshape(-1).float()
    total = x.new_zeros(())
    for a in range(0, x.shape[0], LOSS_ROWS):
        total = total + checkpoint(_loss_rows, x[a:a + LOSS_ROWS], head, labels[a:a + LOSS_ROWS],
                                   mask[a:a + LOSS_ROWS], z, precision, use_reentrant=False)
    return total / mask.sum().clamp(min=1.0)


def loss_mask(labels: torch.Tensor, fault: Optional[str]) -> torch.Tensor:
    """Labels other than the padding id 0 count; the fault "half_batch"
    leaves out half the batch (the last rows, or with one row the last half
    of its positions)."""
    mask = labels != 0
    if fault == "half_batch":
        mask = mask.clone()
        if labels.shape[0] > 1:
            mask[labels.shape[0] // 2:] = False
        else:
            mask[:, labels.shape[1] // 2:] = False
    return mask


# ---------------------------------------------------------------------------
# three steps of training
# ---------------------------------------------------------------------------
def lr_at(schedule: Dict[str, float], step: int) -> float:
    """Linear warmup to ``lr`` over ``warmup_steps``, then cosine decay to
    ``min_lr_ratio`` of it by ``decay_steps``."""
    lr, warm = schedule["lr"], schedule["warmup_steps"]
    if step < warm:
        return lr * step / max(1.0, warm)
    prog = min(1.0, max(0.0, (step - warm) / max(1.0, schedule["decay_steps"] - warm)))
    ratio = schedule["min_lr_ratio"]
    return lr * (ratio + (1 - ratio) * 0.5 * (1 + math.cos(math.pi * prog)))


def _graph_leaves(params: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor],
                  table: LeafTable) -> Dict[str, Any]:
    """Per path an autograd leaf sharing the parameter's storage, its .grad
    set to the gradient buffer; a stacked leaf as a list of one leaf a
    layer, so each layer's gradient lands in its rows of the buffer."""
    out: Dict[str, Any] = {}
    for path, shape, stacked, _, _ in table.entries:
        p, g = params[path], grads[path]

        def leaf(pv, gv):
            t = pv.detach().requires_grad_(True)
            t.grad = gv
            return t

        out[path] = [leaf(p[i], g[i]) for i in range(shape[0])] if stacked else leaf(p, g)
    return out


@contextlib.contextmanager
def tf32_off() -> Iterator[None]:
    """Matmuls and convolutions in full f32 while open."""
    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


def train_steps(family, model: Dict[str, Any], optimizer: Dict[str, float],
                schedule: Dict[str, float], seed: int, batches: Sequence[Dict[str, Any]],
                device, precision: str = "float32", fault: Optional[str] = None,
                ) -> Dict[str, Any]:
    """The reference's run of ``len(batches)`` AdamW steps from the seed's
    weights: {"losses", "grad1", "update"} - each step's loss, each piece's
    norm of the first gradient as AdamW takes it (after clipping), and each
    piece's norm of the parameters' change after the last step."""
    with tf32_off():
        return _train_steps(family, model, optimizer, schedule, seed, batches, device,
                            precision, fault)


def _train_steps(family, model, optimizer, schedule, seed, batches, device, precision, fault):
    table = LeafTable(family.leaf_shapes(model))
    flat = make_flat(table, seed, device, family.init_rules(model))
    gflat = torch.zeros_like(flat)
    mflat = torch.zeros_like(flat)
    vflat = torch.zeros_like(flat)

    def views(buf):
        return {path: buf[off:off + n].view(shape) for path, shape, _, off, n in table.entries}

    params, grads = views(flat), views(gflat)
    shapes = table.shapes()
    b1, b2, eps = optimizer["b1"], optimizer["b2"], optimizer["eps"]
    out: Dict[str, Any] = {"losses": [], "grad1": {}, "update": {}}
    for t, batch in enumerate(batches, start=1):
        gflat.zero_()
        tokens = torch.as_tensor(batch["tokens"], device=device).long()
        labels = torch.as_tensor(batch["labels"], device=device).long()
        loss = family.loss(_graph_leaves(params, grads, table), tokens, labels, model,
                           optimizer["z_loss"], precision, loss_mask(labels, fault))
        loss.backward()
        out["losses"].append(float(loss.detach()))
        del loss
        gnorm = math.sqrt(sum(square_sum(g) for g in grads.values()))
        scale = min(1.0, optimizer["grad_clip"] / max(gnorm, 1e-12))
        lr = lr_at(schedule, t)
        c1, c2 = 1.0 - b1 ** t, 1.0 - b2 ** t
        for _, path, _, off, n in ([] if fault == "unchanged" else table.pieces()):
            # a layer at a time: small temporaries
            p, g, m, v = (buf[off:off + n] for buf in (flat, gflat, mflat, vflat))
            m.mul_(b1).add_(g, alpha=(1 - b1) * scale)
            v.mul_(b2).addcmul_(g, g, value=(1 - b2) * scale * scale)
            delta = (m / c1) / ((v / c2).sqrt_().add_(eps))
            if len(shapes[path]) >= 2:  # decoupled decay on leaves of 2 or more dims
                delta.add_(p, alpha=optimizer["weight_decay"])
            p.sub_(delta, alpha=lr)
            del delta
        if t == 1:  # as the program's is read: AdamW's first moment over 1 - b1
            for piece, _, _, off, n in table.pieces():
                out["grad1"][piece] = math.sqrt(square_sum(mflat[off:off + n])) / (1 - b1)
    init = InitialPieces(seed, device, family.init_rules(model), table.total)
    for piece, path, shape, off, n in table.pieces():
        out["update"][piece] = math.sqrt(square_sum(flat[off:off + n] - init.get(path, shape,
                                                                                 off, n)))
    return out


def layer_checkpoint(fn: Callable, x: torch.Tensor, *args: Any) -> torch.Tensor:
    return checkpoint(fn, x, *args, use_reentrant=False)
