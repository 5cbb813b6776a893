"""Decoder-only language model: dense, MoE, SSM (mamba2), hybrid (jamba) and
VLM-backbone (qwen2-vl) families (twin of the JAX package's
``repro/models/lm.py``).

Layers are organised into *groups* (sub-pattern, repeats) exactly as in the
JAX model, and the parameters keep that layout: ``params["group<i>"]`` is a
list over the sub-pattern of per-layer dicts, and a group with repeats > 1
stores every leaf with a leading repeats dim.  A Python loop over the repeats
takes the place of ``lax.scan``.  With ``cfg.remat == "block"`` and grad
mode on, each repeat of a repeated group runs under
``torch.utils.checkpoint`` (non-reentrant), the twin of ``jax.checkpoint`` on
the scanned body: its activations are recomputed in the backward.  Serving
(no grad) is unaffected.

Forward signature is batch-dict based: ``{"tokens": (B, S) integer}``, with
optional ``"positions"`` (B, S).  A VLM batch may hold ``"embeds"`` (B, S,
d_model) in place of tokens, with (B, S, 3) M-RoPE ``"positions"``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Iterator, List, Optional, Tuple, Union

import torch
from torch.utils.checkpoint import checkpoint

from .. import resolve_device
from ..dist.context import CACHE_HEADS, shard_activations, unsplit_repeats
from . import layers as L
from .config import ModelConfig

LayerSpec = Tuple[str, str]  # (mixer: attn|ssm, ffn: dense|moe|none)

# Leaves that the JAX model casts to the compute dtype at every use
# (``w.astype(x.dtype)``).  Everything else stays as it is: norm scales are
# read in f32, and the mamba2 leaves conv_w, conv_b, A_log, D, dt_bias and
# norm_w are used uncast, so with f32 params the conv promotes the SSM's x,
# B and C to f32 in both frameworks.  The projections' biases (``use_bias``,
# the port's own) are cast at every use as their weights are; a LayerNorm's
# shift is read in f32 as its scale.
MATMUL_LEAVES = ("embed", "lm_head", "wq", "wk", "wv", "wo", "w1", "w2", "w3",
                 "router", "in_proj", "out_proj", "bq", "bk", "bv", "bo", "b1", "b2")

# ---------------------------------------------------------------------------
# Layer grouping
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class LayerGroup:
    subpattern: Tuple[LayerSpec, ...]
    repeats: int


def layer_pattern(cfg: ModelConfig) -> List[LayerSpec]:
    def ffn_kind(i: int) -> str:
        if cfg.is_moe_layer(i):
            return "moe"
        return "dense" if cfg.d_ff > 0 else "none"  # mamba2 blocks: mixer only

    return [
        ("attn" if cfg.is_attn_layer(i) else "ssm", ffn_kind(i))
        for i in range(cfg.num_layers)
    ]


def compute_groups(cfg: ModelConfig) -> List[LayerGroup]:
    pattern = layer_pattern(cfg)
    groups: List[LayerGroup] = []
    i = 0
    if cfg.first_dense_layers:
        groups.append(LayerGroup(tuple(pattern[: cfg.first_dense_layers]), repeats=1))
        i = cfg.first_dense_layers
    body = pattern[i:]
    if not body:
        return groups
    period = 1
    if cfg.family == "hybrid" and cfg.attn_period:
        period = cfg.attn_period
    elif cfg.num_experts and cfg.moe_every > 1:
        period = cfg.moe_every
    assert len(body) % period == 0, (len(body), period)
    sub = tuple(body[:period])
    for r in range(len(body) // period):
        assert tuple(body[r * period : (r + 1) * period]) == sub
    groups.append(LayerGroup(sub, repeats=len(body) // period))
    return groups


# ---------------------------------------------------------------------------
# Block apply (one layer)
# ---------------------------------------------------------------------------
def block_apply(
    cfg: ModelConfig, spec: LayerSpec, p: Dict[str, Any], x: torch.Tensor,
    positions: torch.Tensor,
) -> torch.Tensor:
    mixer, ffn = spec
    B, S, d = x.shape
    h = L.block_norm(x, p, "ln1", cfg)
    if mixer == "attn":
        h = L.attention(p["attn"], h, cfg, positions, causal=True)
    else:
        h = L.mamba2_mixer(p["ssm"], h, cfg)
    x = shard_activations(x + h, "bsd")
    if ffn == "none":
        return x
    h2 = L.block_norm(x, p, "ln2", cfg)
    if ffn == "moe":
        h2 = L.moe_ffn(p["moe"], h2.reshape(B * S, d), cfg).reshape(B, S, d)
    else:
        h2 = L.mlp(p["mlp"], h2, cfg.mlp_act)
    return shard_activations(x + h2, "bsd")


def block_decode(
    cfg: ModelConfig, spec: LayerSpec, p: Dict[str, Any], c: Dict[str, torch.Tensor],
    x_t: torch.Tensor, pos: int,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    mixer, ffn = spec
    B = x_t.shape[0]
    h = L.block_norm(x_t, p, "ln1", cfg)
    if mixer == "attn":
        h, c = L.attention_decode(p["attn"], h, c, pos, cfg)
    else:
        h, c = L.mamba2_decode(p["ssm"], h, c, cfg)
    x_t = x_t + h
    if ffn == "none":
        return x_t, c
    h2 = L.block_norm(x_t, p, "ln2", cfg)
    if ffn == "moe":
        # serving is dropless: capacity-dropping a decode token corrupts its
        # output (as in the JAX block_decode)
        h2 = L.moe_ffn(p["moe"], h2.reshape(B, -1), cfg, dropless=True).reshape(B, 1, -1)
    else:
        h2 = L.mlp(p["mlp"], h2, cfg.mlp_act)
    return x_t + h2, c


def _index(tree: Any, r: int) -> Any:
    if isinstance(tree, dict):
        return {k: _index(v, r) for k, v in tree.items()}
    return tree[r]


def _map_leaves(tree: Any, fn, key: str = "") -> Any:
    if isinstance(tree, dict):
        return {k: _map_leaves(v, fn, k) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map_leaves(v, fn, key) for v in tree]
    return fn(key, tree)


def cast_for_compute(cfg: ModelConfig, params: Dict[str, Any]) -> Dict[str, Any]:
    """The same tree with every matmul weight cast once to the compute
    dtype.  Gives the numbers of the JAX model's per-use ``.astype``; norm
    scales keep their dtype (the JAX norms read them in f32)."""
    dt = L.cdt(cfg)
    return _map_leaves(params, lambda k, t: t.to(dt) if k in MATMUL_LEAVES else t)


class MetaGenerator:
    """Stands in for a generator on the ``meta`` device, where none exists:
    ``layers._init`` gives shape-only leaves for it and draws nothing."""

    device = torch.device("meta")


def init_generator(generator: Union[torch.Generator, int], device) -> Tuple[torch.Generator,
                                                                             torch.device]:
    """(generator, device) of a model's ``init``: ``device`` resolved (CUDA
    unless the caller asks for "cpu"), an int seeding a generator there.  On
    ``meta`` the generator is a ``MetaGenerator`` whatever was passed."""
    dev = resolve_device(device)
    if dev.type == "meta":
        return MetaGenerator(), dev
    if isinstance(generator, int):
        generator = torch.Generator(device=dev).manual_seed(generator)
    if generator.device.type != dev.type:
        raise ValueError(f"generator on {generator.device}, parameters on {dev}")
    return generator, dev


class LanguageModel:
    def __init__(self, cfg: ModelConfig):
        self.cfg = cfg
        self.groups = compute_groups(cfg)
        # top-level leaves stacked over repeats, and their repeat counts
        self.repeats = {f"group{gi}": g.repeats for gi, g in enumerate(self.groups)}

    # -- params ---------------------------------------------------------
    def init(
        self, generator: Union[torch.Generator, int] = 0, device=None
    ) -> Dict[str, Any]:
        """Random parameters in ``cfg.param_dtype``, drawn from ``generator``
        (or a generator seeded with that int) on ``device`` (CUDA unless the
        caller asks for ``"cpu"``).  The JAX model draws other numbers from
        its keys; tests carry JAX's weights across with ``bridge``."""
        cfg = self.cfg
        generator, dev = init_generator(generator, device)
        pd = L.pdt(cfg)
        params: Dict[str, Any] = {
            "embed": L._init(generator, (cfg.vocab_size, cfg.d_model), 0.02, pd),
            "final_norm": torch.ones((cfg.d_model,), dtype=pd, device=dev),
        }
        if cfg.norm_type == "layer":
            params["final_norm_bias"] = torch.zeros((cfg.d_model,), dtype=pd, device=dev)
        if not cfg.tie_embeddings:
            params["lm_head"] = L._init(generator, (cfg.d_model, cfg.vocab_size), 0.02, pd)
        for gi, g in enumerate(self.groups):
            # a repeated group is stacked with a leading repeats dim
            lead = () if g.repeats == 1 else (g.repeats,)
            params[f"group{gi}"] = [
                self._init_block(generator, spec, lead) for spec in g.subpattern
            ]
        return params

    def _init_block(self, gen: torch.Generator, spec: LayerSpec, lead: Tuple[int, ...]):
        cfg = self.cfg
        mixer, ffn = spec
        p: Dict[str, Any] = {
            "ln1": torch.ones(lead + (cfg.d_model,), dtype=L.pdt(cfg), device=gen.device)}
        if cfg.norm_type == "layer":  # a LayerNorm's shift
            p["ln1_bias"] = torch.zeros_like(p["ln1"])
        if ffn != "none":  # a mamba2 block has no separate FFN and no ln2
            p["ln2"] = p["ln1"].clone()
            if cfg.norm_type == "layer":
                p["ln2_bias"] = torch.zeros_like(p["ln1"])
        if mixer == "attn":
            p["attn"] = L.init_attention(gen, cfg, lead)
        else:
            p["ssm"] = L.init_mamba2(gen, cfg, lead)
        if ffn == "moe":
            p["moe"] = L.init_moe(gen, cfg, lead)
        elif ffn == "dense":
            p["mlp"] = L.init_mlp(gen, cfg, lead)
        return p

    def cast_for_compute(self, params: Dict[str, Any]) -> Dict[str, Any]:
        return cast_for_compute(self.cfg, params)

    def _layers(self, params: Dict[str, Any]) -> Iterator[Tuple[int, int, int, LayerSpec, Any]]:
        for gi, g in enumerate(self.groups):
            gp = params[f"group{gi}"]
            for r in range(g.repeats):
                for j, spec in enumerate(g.subpattern):
                    yield gi, r, j, spec, (gp[j] if g.repeats == 1 else _index(gp[j], r))

    def _repeat_apply(self, g: LayerGroup, rp: List[Any], x: torch.Tensor,
                      positions: torch.Tensor) -> torch.Tensor:
        """One repeat of group ``g``: its sub-pattern's layers in order."""
        for spec, p in zip(g.subpattern, rp):
            x = block_apply(self.cfg, spec, p, x, positions)
        return x

    # -- forward (train / prefill) -----------------------------------------
    def forward(
        self, params: Dict[str, Any], batch: Dict[str, Any], last_token_only: bool = False,
    ) -> torch.Tensor:
        cfg = self.cfg
        if cfg.family == "vlm" and "embeds" in batch:
            # the vision stub: precomputed patch and text embeddings
            x = batch["embeds"].to(L.cdt(cfg))
            B, S, _ = x.shape
        else:
            tokens = batch["tokens"]
            B, S = tokens.shape
            x = L.embed_lookup(params["embed"], tokens, L.cdt(cfg))
        x = shard_activations(x, "bsd")
        positions = batch.get("positions")
        if positions is None:
            positions = torch.arange(S, device=x.device)[None].expand(B, S)
        remat = cfg.remat == "block" and torch.is_grad_enabled()
        for gi, g in enumerate(self.groups):
            gp = params[f"group{gi}"]
            for r in range(g.repeats):
                rp = gp if g.repeats == 1 else [_index(p, r) for p in gp]
                if remat and g.repeats > 1:
                    x = checkpoint(self._repeat_apply, g, rp, x, positions,
                                   use_reentrant=False, preserve_rng_state=False)
                else:
                    x = self._repeat_apply(g, rp, x, positions)
        x = L.block_norm(x, params, "final_norm", cfg)
        if last_token_only:  # prefill: only the last position feeds sampling
            x = x[:, -1:, :]
        head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
        logits = L.linear(x, head)
        if cfg.logits_fp32:
            logits = logits.float()
        return logits

    # -- decode -------------------------------------------------------------
    def init_cache(
        self, batch_size: int, max_seq: int, dtype: Optional[torch.dtype] = None, device=None,
    ) -> Dict[str, Any]:
        """Zeroed cache on ``device`` (CUDA unless the caller asks for
        ``"cpu"``), laid out like the parameters: per group a list over the
        sub-pattern, with a leading repeats dim when the group repeats.  An
        attention layer holds {"k", "v"} (B, max_seq, Hkv, D); a mamba2 layer
        {"h": (B, H, N, P) f32, "conv": (B, 3, conv channels)}, the SSM state
        and the last three conv inputs.  ``"pos"`` is a host int."""
        cfg = self.cfg
        dev = resolve_device(device)
        dt = dtype or L.cdt(cfg)

        def one(spec: LayerSpec, lead: Tuple[int, ...]) -> Dict[str, torch.Tensor]:
            if spec[0] == "attn":
                shape = (batch_size, max_seq, cfg.num_kv_heads, cfg.head_dim)
                return {name: torch.zeros(lead + shape, dtype=dt, device=dev)
                        for name in ("k", "v")}
            conv_ch = cfg.ssm_d_inner + 2 * cfg.ssm_groups * cfg.ssm_state
            h = (batch_size, cfg.ssm_heads, cfg.ssm_state, cfg.ssm_head_dim)
            return {"h": torch.zeros(lead + h, dtype=torch.float32, device=dev),
                    "conv": torch.zeros(lead + (batch_size, 3, conv_ch), dtype=dt, device=dev)}

        cache: Dict[str, Any] = {"pos": 0}
        for gi, g in enumerate(self.groups):
            lead = () if g.repeats == 1 else (g.repeats,)
            cache[f"group{gi}"] = [one(spec, lead) for spec in g.subpattern]
        return cache

    def decode_step(
        self, params: Dict[str, Any], cache: Dict[str, Any], tokens: torch.Tensor,
    ) -> Tuple[torch.Tensor, Dict[str, Any]]:
        """One token per sequence (``tokens`` (B,)) against the cache.  The
        cache is updated IN PLACE (k, v at ``pos``, the SSM state and conv
        window, then ``pos + 1``) and returned; the JAX model returns a new
        cache instead.  A repeated group's layer gets views ``t[r]`` of its
        stacked cache, which the layers write with ``copy_``."""
        cfg = self.cfg
        pos = cache["pos"]
        for gi, g in enumerate(self.groups):
            if g.repeats > 1:  # on a mesh: each repeat's rows must be a view
                cache[f"group{gi}"] = [{n: unsplit_repeats(t, CACHE_HEADS.get(n))
                                        for n, t in c.items()} for c in cache[f"group{gi}"]]
        x = L.embed_lookup(params["embed"], tokens, L.cdt(cfg))[:, None, :]  # (B,1,d)
        for gi, r, j, spec, p in self._layers(params):
            c = cache[f"group{gi}"][j]
            if self.groups[gi].repeats > 1:
                c = {name: t[r] for name, t in c.items()}
            x, _ = block_decode(cfg, spec, p, c, x, pos)
        cache["pos"] = pos + 1
        x = L.block_norm(x, params, "final_norm", cfg)
        head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
        logits = (x @ head.to(x.dtype))[:, 0]
        return logits.float(), cache
