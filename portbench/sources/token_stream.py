"""Rows of token ids drawn from a Zipf law: the source the feed reads.

Each id is drawn on its own from the ranks 1..``vocab``-1 with probability
proportional to ``rank ** -zipf_a`` (the law truncated to the tokenizer's
ids; the padding id 0 is never drawn), and id = rank.  A batch is ``batch``
rows of ``seq + 1`` ids as {"tokens": row[:-1], "labels": row[1:]} (int64).
Batch i of a seed is always the same, whatever the rate it is read at.

No documents are cut: the training step this source feeds takes no
document boundaries (no segment ids, no state reset), so where they fall
changes no work.

``TokenStream`` has the duck type ``DeviceFeeder`` takes from the data
service's distributed dataset: ``.session(**overrides)`` gives a session
that iterates numpy batches on the reader's thread and has ``close()``.
"""
from __future__ import annotations

from typing import Any, Dict, Iterator, List

import numpy as np


def seed_rng(seed: int) -> np.random.Generator:
    return np.random.default_rng(int(seed) % (2 ** 63))


def zipf_cdf(vocab: int, a: float) -> np.ndarray:
    """Cumulative probabilities of the ranks 1..vocab-1."""
    w = np.arange(1, vocab, dtype=np.float64) ** -float(a)
    cdf = np.cumsum(w)
    return cdf / cdf[-1]


def next_batch(rng: np.random.Generator, cdf: np.ndarray, traffic: Dict[str, Any]
               ) -> Dict[str, np.ndarray]:
    u = rng.random((traffic["batch"], traffic["seq"] + 1))
    ids = np.minimum(np.searchsorted(cdf, u, side="right"), len(cdf) - 1) + 1
    arr = ids.astype(np.int64)
    return {"tokens": arr[:, :-1], "labels": arr[:, 1:]}


def batches(traffic: Dict[str, Any], vocab: int, seed: int, count: int
            ) -> List[Dict[str, np.ndarray]]:
    """The first ``count`` batches of ``seed``."""
    rng, cdf = seed_rng(seed), zipf_cdf(vocab, traffic["zipf_a"])
    return [next_batch(rng, cdf, traffic) for _ in range(count)]


class TokenStream:
    def __init__(self, traffic: Dict[str, Any], vocab: int, seed: int):
        self.traffic, self.seed = traffic, seed
        self.cdf = zipf_cdf(vocab, traffic["zipf_a"])

    def session(self, **overrides: Any) -> "_Session":
        return _Session(self)


class _Session:
    def __init__(self, src: TokenStream):
        self.src = src
        self.closed = False

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        rng = seed_rng(self.src.seed)
        while not self.closed:
            yield next_batch(rng, self.src.cdf, self.src.traffic)

    def close(self) -> None:
        self.closed = True


def make(traffic: Dict[str, Any], vocab: int, seed: int) -> TokenStream:
    return TokenStream(traffic, vocab, seed)
