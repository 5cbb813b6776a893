"""Encoder-decoder transformer, the whisper-large-v3 backbone (twin of the
JAX package's ``repro/models/encdec.py``).

The conv/mel frontend is a stub, as in JAX: the model takes precomputed
frame embeddings ``enc_embeds`` (B, encoder_seq, d_model).  Encoder layers
are bidirectional self-attention without rope; decoder layers are causal
self-attention, cross-attention over the encoder output, and an MLP.  The
head is tied to ``embed``.

Parameters keep JAX's tree: ``embed``, ``enc`` and ``dec`` (dicts whose
every leaf has a leading layers dim: ``ln1``, ``ln2``, ``attn``, ``mlp``,
and in ``dec`` also ``ln_x`` and ``xattn``), ``enc_norm`` and
``final_norm``; ``bridge.params_from_jax`` carries JAX's across unchanged.
A Python loop over the layers takes the place of ``lax.scan``; with
``cfg.remat == "block"`` and grad mode on, each layer runs under
``torch.utils.checkpoint``, the twin of ``jax.checkpoint`` on the body.

Decode keeps a self-attention KV cache and the cross K/V, computed once per
sequence by ``init_cache``.  Its self-attention is ``attention_decode``,
which applies rope, as JAX's ``decode_step`` does through
``L.attention_decode``, while the teacher-forced ``forward`` runs without
rope: in both packages the decode logits are not the forward's.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple, Union

import torch
from torch.utils.checkpoint import checkpoint

from ..dist.context import CACHE_HEADS, like_mesh, shard_activations, unsplit_repeats
from . import layers as L
from .config import ModelConfig
from .lm import _index, cast_for_compute, init_generator


def _div(d: int, device) -> torch.Tensor:
    """(d/2,) f32 frequencies exp(-2i ln(10000) / d): the exponent in f32 as
    in JAX, its exp in f64 rounded to f32, so the CPU and the card get the
    same frequencies (f32 exps may differ by an ulp, which a position of
    1499 turns into about 1.2e-4 of the sinusoid)."""
    x = torch.arange(0, d, 2, dtype=torch.float32, device=device) * (-math.log(10000.0) / d)
    return torch.exp(x.double()).float()


def _sinusoid(seq: int, d: int, device=None) -> torch.Tensor:
    """(seq, d) f32 sinusoidal positions: sin on even channels, cos on odd."""
    angle = torch.arange(seq, dtype=torch.float32, device=device)[:, None] * _div(d, device)
    pe = torch.zeros((seq, d), dtype=torch.float32, device=device)
    pe[:, 0::2] = torch.sin(angle)
    pe[:, 1::2] = torch.cos(angle)
    return pe


def _sinusoid_at(pos: int, d: int, device=None) -> torch.Tensor:
    """The (d,) f32 positional row of position ``pos``."""
    angle = float(pos) * _div(d, device)
    pe = torch.zeros((d,), dtype=torch.float32, device=device)
    pe[0::2] = torch.sin(angle)
    pe[1::2] = torch.cos(angle)
    return pe


class EncDecModel:
    def __init__(self, cfg: ModelConfig):
        if cfg.family != "encdec":
            raise ValueError(f"EncDecModel takes the encdec family; {cfg.name} is {cfg.family}")
        self.cfg = cfg
        # top-level leaves stacked over layers, and their layer counts
        self.repeats = {"enc": cfg.encoder_layers, "dec": cfg.num_layers}

    # -- params ---------------------------------------------------------
    def init(
        self, generator: Union[torch.Generator, int] = 0, device=None
    ) -> Dict[str, Any]:
        """Random parameters in ``cfg.param_dtype``, drawn from ``generator``
        (or a generator seeded with that int) on ``device`` (CUDA unless the
        caller asks for ``"cpu"``)."""
        cfg = self.cfg
        generator, dev = init_generator(generator, device)
        pd = L.pdt(cfg)

        def ones(lead):
            return torch.ones(lead + (cfg.d_model,), dtype=pd, device=dev)

        le, ld = (cfg.encoder_layers,), (cfg.num_layers,)
        params: Dict[str, Any] = {
            "embed": L._init(generator, (cfg.vocab_size, cfg.d_model), 0.02, pd)}
        params["enc"] = {"ln1": ones(le), "ln2": ones(le),
                         "attn": L.init_attention(generator, cfg, le),
                         "mlp": L.init_mlp(generator, cfg, le)}
        params["dec"] = {"ln1": ones(ld), "ln_x": ones(ld), "ln2": ones(ld),
                         "attn": L.init_attention(generator, cfg, ld),
                         "xattn": L.init_attention(generator, cfg, ld),
                         "mlp": L.init_mlp(generator, cfg, ld)}
        params["enc_norm"] = ones(())
        params["final_norm"] = ones(())
        return params

    def cast_for_compute(self, params: Dict[str, Any]) -> Dict[str, Any]:
        return cast_for_compute(self.cfg, params)

    def _run(self, body, stacked: Any, n: int, x: torch.Tensor, *args) -> torch.Tensor:
        remat = self.cfg.remat == "block" and torch.is_grad_enabled()
        for i in range(n):
            p = _index(stacked, i)
            if remat:
                x = checkpoint(body, p, x, *args, use_reentrant=False, preserve_rng_state=False)
            else:
                x = body(p, x, *args)
        return x

    # -- encoder -----------------------------------------------------------
    def _enc_layer(self, p, h: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        h = h + L.attention(p["attn"], L.rms_norm(h, p["ln1"]), cfg, positions,
                            causal=False, use_rope=False)
        return shard_activations(h + L.mlp(p["mlp"], L.rms_norm(h, p["ln2"]), cfg.mlp_act), "bsd")

    def encode(self, params: Dict[str, Any], enc_embeds: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        B, S, d = enc_embeds.shape
        dt = L.cdt(cfg)
        pe = like_mesh(_sinusoid(S, d, enc_embeds.device).to(dt)[None], enc_embeds)
        x = shard_activations(enc_embeds.to(dt) + pe, "bsd")
        positions = torch.arange(S, device=x.device)[None].expand(B, S)
        x = self._run(self._enc_layer, params["enc"], cfg.encoder_layers, x, positions)
        return L.rms_norm(x, params["enc_norm"])

    # -- decoder (teacher-forced training / prefill) -------------------------
    def _dec_layer(self, p, h: torch.Tensor, enc_out: torch.Tensor,
                   positions: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        h = h + L.attention(p["attn"], L.rms_norm(h, p["ln1"]), cfg, positions,
                            causal=True, use_rope=False)
        h = h + L.attention(p["xattn"], L.rms_norm(h, p["ln_x"]), cfg, positions,
                            causal=False, kv_x=enc_out, use_rope=False)
        return shard_activations(h + L.mlp(p["mlp"], L.rms_norm(h, p["ln2"]), cfg.mlp_act), "bsd")

    def forward(
        self, params: Dict[str, Any], batch: Dict[str, Any], last_token_only: bool = False,
    ) -> torch.Tensor:
        """Teacher-forced logits of ``batch["tokens"]`` (B, S) given
        ``batch["enc_embeds"]`` (B, encoder_seq, d_model)."""
        cfg = self.cfg
        enc_out = self.encode(params, batch["enc_embeds"])
        tokens = batch["tokens"]
        B, S = tokens.shape
        x = L.embed_lookup(params["embed"], tokens, L.cdt(cfg))
        pe = like_mesh(_sinusoid(S, cfg.d_model, x.device).to(x.dtype)[None], x)
        x = shard_activations(x + pe, "bsd")
        positions = torch.arange(S, device=x.device)[None].expand(B, S)
        x = self._run(self._dec_layer, params["dec"], cfg.num_layers, x, enc_out, positions)
        x = L.rms_norm(x, params["final_norm"])
        if last_token_only:
            x = x[:, -1:, :]
        logits = L.linear(x, params["embed"].T)  # whisper ties embeddings
        return logits.float() if cfg.logits_fp32 else logits

    # -- decode -------------------------------------------------------------
    def init_cache(
        self, params: Dict[str, Any], batch_size: int, max_seq: int,
        enc_embeds: Optional[torch.Tensor] = None,
    ) -> Dict[str, Any]:
        """Self-attention KV cache {"k", "v"} (num_layers, B, max_seq, Hkv,
        D), zeroed, and the cross K/V {"xk", "xv"} (num_layers, B,
        encoder_seq, Hkv, D) of the encoder output (zeros when no
        ``enc_embeds`` is given, as in JAX), on the parameters' device, in
        the compute dtype.  ``"pos"`` is a host int."""
        cfg = self.cfg
        dt = L.cdt(cfg)
        dev = params["embed"].device
        Ld, Hkv, D = cfg.num_layers, cfg.num_kv_heads, cfg.head_dim
        if enc_embeds is None:
            enc_out = torch.zeros((batch_size, cfg.encoder_seq, cfg.d_model), dtype=dt,
                                  device=dev)
        else:
            enc_out = self.encode(params, enc_embeds)
        S = enc_out.shape[1]
        xattn = params["dec"]["xattn"]
        # contiguous: each layer's slab goes to the decode kernel as it is
        xk, xv = (L.split_heads(torch.einsum("bsd,ldk->lbsk", enc_out, xattn[w].to(dt)), Hkv)
                  .contiguous() for w in ("wk", "wv"))
        shape = (Ld, batch_size, max_seq, Hkv, D)
        return {"pos": 0, "k": torch.zeros(shape, dtype=dt, device=dev),
                "v": torch.zeros(shape, dtype=dt, device=dev), "xk": xk, "xv": xv}

    def decode_step(
        self, params: Dict[str, Any], cache: Dict[str, Any], tokens: torch.Tensor,
    ) -> Tuple[torch.Tensor, Dict[str, Any]]:
        """One token per sequence (``tokens`` (B,)) against the cache, which
        is updated IN PLACE (k, v at ``pos``, then ``pos + 1``) and returned;
        the JAX model returns a new cache instead."""
        cfg = self.cfg
        pos = cache["pos"]
        for name in ("k", "v", "xk", "xv"):  # on a mesh: each layer's rows must be a view
            cache[name] = unsplit_repeats(cache[name], CACHE_HEADS[name])
        x = L.embed_lookup(params["embed"], tokens, L.cdt(cfg))[:, None, :]
        x = x + like_mesh(_sinusoid_at(pos, cfg.d_model, x.device).to(x.dtype)[None, None, :], x)
        for i in range(cfg.num_layers):
            p = _index(params["dec"], i)
            c = {"k": cache["k"][i], "v": cache["v"][i]}
            a, _ = L.attention_decode(p["attn"], L.rms_norm(x, p["ln1"]), c, pos, cfg)
            x = x + a
            x = x + L.cross_attention_decode(p["xattn"], L.rms_norm(x, p["ln_x"]),
                                             cache["xk"][i], cache["xv"][i], cfg)
            x = x + L.mlp(p["mlp"], L.rms_norm(x, p["ln2"]), cfg.mlp_act)
        cache["pos"] = pos + 1
        x = L.rms_norm(x, params["final_norm"])
        logits = (x @ params["embed"].T.to(x.dtype))[:, 0]
        return logits.float(), cache
