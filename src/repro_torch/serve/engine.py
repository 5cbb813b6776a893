"""Serving layer: batched KV-cache decoding (twin of the JAX package's
``repro/serve/engine.py``).

``make_serve_step(model)`` builds the one-token step: (params, cache,
tokens (B,)) -> (greedy next tokens, cache).  ``ServeEngine`` is the small
batched engine: static slots, prompts teacher-forced token by token through
the decode step, then greedy decoding - the same algorithm as the JAX engine.
The port's cache is updated in place, so the step returns the cache it was
given.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate

from .. import DeviceLike, resolve_device
from ..models import Model


def _summed(logits: Any) -> Any:
    """``DTensor`` logits whose pending sums (``Partial``: a batch too small
    to split over the data axes leaves the head's contraction split there)
    are reduced and whose vocabulary is gathered, so that the argmax is a
    local one: an argmax over partial sums would be wrong, and DTensor's
    own over a split vocabulary fails then.  One token's (B, V) a step."""
    if not isinstance(logits, DTensor) or not any(isinstance(p, Partial)
                                                  for p in logits.placements):
        return logits
    return logits.redistribute(logits.device_mesh, [Replicate()] * logits.device_mesh.ndim)


def make_serve_step(model: Model) -> Callable:
    """Decode step: (params, cache, tokens (B,)) -> (next_tokens int32, cache)."""

    def step(params: Any, cache: Dict[str, Any], tokens: torch.Tensor):
        logits, cache = model.decode_step(params, cache, tokens)
        return torch.argmax(_summed(logits), dim=-1).to(torch.int32), cache

    return step


@dataclass
class Request:
    prompt: List[int]
    max_new_tokens: int = 16
    generated: List[int] = field(default_factory=list)
    done: bool = False


class ServeEngine:
    """Minimal batched decoder with static slots, for decoder-only models
    (an enc-dec model raises, as in JAX).

    ``params`` must lie on ``device`` (CUDA unless the caller passes
    ``device="cpu"``); the engine keeps a copy with the matmul weights cast
    once to the compute dtype (``LanguageModel.cast_for_compute``).
    """

    def __init__(self, model: Model, params: Any, batch_size: int, max_seq: int,
                 device: DeviceLike = None):
        if model.cfg.family == "encdec":
            raise NotImplementedError("ServeEngine drives decoder-only models")
        self.device = resolve_device(device)
        if params["embed"].device != self.device:
            raise ValueError(f"params on {params['embed'].device}, engine on {self.device}")
        self.model = model
        self.params = model.cast_for_compute(params)
        self.B = batch_size
        self.max_seq = max_seq
        self.cache = model.init_cache(batch_size, max_seq, device=self.device)
        self._step = make_serve_step(model)
        self.slots: List[Optional[Request]] = [None] * batch_size

    def admit(self, req: Request) -> bool:
        for i, s in enumerate(self.slots):
            if s is None:
                self.slots[i] = req
                return True
        return False

    def run(self, requests: List[Request]) -> List[Request]:
        """Prefill via repeated decode (token-at-a-time) then generate."""
        pending = list(requests)
        for r in pending:
            if not self.admit(r):
                raise RuntimeError("batch full")
        max_prompt = max(len(r.prompt) for r in pending)
        steps = max_prompt + max(r.max_new_tokens for r in pending)
        if steps > self.max_seq:
            raise ValueError(f"{steps} decode steps exceed max_seq={self.max_seq}")
        for t in range(steps):
            feed = []
            for r in self.slots:
                if r is None:
                    feed.append(0)
                elif t < len(r.prompt):
                    feed.append(r.prompt[t])
                elif not r.done:
                    feed.append(r.generated[-1] if r.generated else r.prompt[-1])
                else:
                    feed.append(0)
            nxt, self.cache = self._step(
                self.params, self.cache,
                torch.tensor(feed, dtype=torch.int32, device=self.device),
            )
            nxt_host = nxt.tolist()
            for i, r in enumerate(self.slots):
                if r is None or r.done:
                    continue
                if t >= len(r.prompt) - 1:
                    r.generated.append(int(nxt_host[i]))
                    if len(r.generated) >= r.max_new_tokens:
                        r.done = True
            if all(r is None or r.done for r in self.slots):
                break
        return pending
