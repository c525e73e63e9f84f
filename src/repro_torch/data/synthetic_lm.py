"""Synthetic LM token pipeline (for arch smoke tests / federated LM demos).

Markov-chain token streams with per-node transition skew so that federated
nodes genuinely hold non-identical distributions (the FL premise), plus
simple batch iterators. Deterministic per (seed, node).
"""
from __future__ import annotations

from typing import Dict, Iterator, Optional

import numpy as np


def markov_tokens(num: int, seq_len: int, vocab: int, seed: int = 0,
                  node: int = 0, order_bias: float = 0.8) -> np.ndarray:
    """(num, seq_len) int32. Sparse per-node transition structure."""
    rng = np.random.default_rng(seed * 7919 + node)
    fanout = max(2, vocab // 16)
    nxt = rng.integers(0, vocab, size=(vocab, fanout))
    out = np.empty((num, seq_len), dtype=np.int32)
    state = rng.integers(0, vocab, size=num)
    for t in range(seq_len):
        out[:, t] = state
        follow = rng.random(num) < order_bias
        choice = nxt[state, rng.integers(0, fanout, size=num)]
        rand = rng.integers(0, vocab, size=num)
        state = np.where(follow, choice, rand)
    return out


def lm_batches(batch: int, seq_len: int, vocab: int, seed: int = 0,
               node: int = 0) -> Iterator[Dict[str, np.ndarray]]:
    step = 0
    while True:
        yield {"tokens": markov_tokens(batch, seq_len, vocab,
                                       seed=seed + step, node=node)}
        step += 1


def fed_lm_round_batch(k: int, l: int, m: int, seq_len: int, vocab: int,
                       seed: int = 0) -> Dict[str, np.ndarray]:
    """(K, L, M, S) token stack for one CD-BFL round over LM nodes."""
    toks = np.stack([
        np.stack([
            markov_tokens(m, seq_len, vocab, seed=seed + li, node=ki)
            for li in range(l)
        ])
        for ki in range(k)
    ])
    return {"tokens": toks}
