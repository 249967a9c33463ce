"""Synthetic LM episodes: the port of ``repro.data.synthetic``'s token
half (``markov_tokens``, ``lm_episode``, ``augment_lm_support``).

Host-side numpy, copied as it is so that the same seed gives the same
arrays in both packages; arrays become tensors at the task boundary
(``core.session.Task``).  The vision and encoder-decoder samplers arrive
with their slices.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np


@dataclasses.dataclass
class Episode:
    support: Dict[str, np.ndarray]
    query: Dict[str, np.ndarray]
    n_way: int
    domain: str


def markov_tokens(
    rng: np.random.Generator, vocab: int, batch: int, seq: int,
    order_seed: int = 0,
) -> np.ndarray:
    """Token batch from a fixed sparse bigram chain (the train_4k data)."""
    chain_rng = np.random.default_rng(order_seed)
    k = 8  # successors per token
    succ = chain_rng.integers(0, vocab, size=(min(vocab, 4096), k))
    toks = np.empty((batch, seq), np.int32)
    cur = rng.integers(0, vocab, size=batch)
    for t in range(seq):
        toks[:, t] = cur
        pick = rng.integers(0, k, size=batch)
        cur = succ[cur % succ.shape[0], pick]
    return toks


def lm_episode(
    rng: np.random.Generator,
    vocab: int,
    seq: int,
    *,
    max_way: int = 8,
    min_way: int = 4,
    shots: int = 8,
    query_per_class: int = 8,
    support_pad: Optional[int] = None,
    query_pad: Optional[int] = None,
) -> Episode:
    """Few-shot episodes over synthetic 'languages' (distinct bigram chains).

    The LM analog of the paper's CDFSL setting: the backbone must adapt to a
    new family of token distributions from a handful of sequences.
    """
    way = int(rng.integers(min_way, max_way + 1))
    seeds = rng.integers(0, 2**31 - 1, size=way)

    def gen(seed, n):
        return markov_tokens(rng, vocab, n, seq, order_seed=int(seed))

    s_toks = np.concatenate([gen(s, shots) for s in seeds])
    s_lbl = np.repeat(np.arange(way, dtype=np.int32), shots)
    q_toks = np.concatenate([gen(s, query_per_class) for s in seeds])
    q_lbl = np.repeat(np.arange(way, dtype=np.int32), query_per_class)

    def pack(toks, lbl, pad):
        if pad is not None and len(lbl) < pad:
            extra = pad - len(lbl)
            toks = np.concatenate([toks, np.zeros((extra, seq), np.int32)])
            lbl = np.concatenate([lbl, -np.ones(extra, np.int32)])
        return {"tokens": toks, "episode_labels": lbl}

    return Episode(pack(s_toks, s_lbl, support_pad),
                   pack(q_toks, q_lbl, query_pad), way, "lm")


def augment_lm_support(
    rng: np.random.Generator, support: Dict[str, np.ndarray]
) -> Dict[str, np.ndarray]:
    """Token-level augmentation: random spans re-rolled (LM pseudo-query)."""
    toks = support["tokens"].copy()
    b, s = toks.shape
    for i in range(b):
        n_cut = rng.integers(1, max(2, s // 16))
        pos = rng.integers(0, s, size=n_cut)
        toks[i, pos] = rng.integers(0, toks.max() + 1, size=n_cut)
    return {"tokens": toks, "episode_labels": support["episode_labels"].copy()}
