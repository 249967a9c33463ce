"""The one traffic generator: adaptation episodes from a mix's parameters
(``traffic/<mix>.json``) and the run's seed.

Every seed draws the same sizes: an episode's way, shots, rows and
length are the mix's.  The seed draws the tokens (and an episode's
classes).  So two seeds give the same work on other data.  Imports
nothing of the port.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np

CHAIN_ROWS = 4096  # states of an episode class's bigram chain


def rng_for(seed: int, *stream: int) -> np.random.Generator:
    """A generator for one stream of the run (seeds past 2**32 are fine)."""
    return np.random.default_rng([int(seed) & (2 ** 63 - 1), *stream])


# ---------------------------------------------------------------------------
# Adaptation episodes
# ---------------------------------------------------------------------------


def _chain_rows(rng: np.random.Generator, vocab: int, n: int, seq: int,
                successors: int) -> np.ndarray:
    """n rows of one class: a random sparse bigram chain over the vocab
    (each state has ``successors`` next tokens), one walk a row."""
    succ = rng.integers(0, vocab, size=(min(vocab, CHAIN_ROWS), successors))
    toks = np.empty((n, seq), np.int32)
    cur = rng.integers(0, vocab, size=n)
    for t in range(seq):
        toks[:, t] = cur
        cur = succ[cur % succ.shape[0], rng.integers(0, successors, size=n)]
    return toks


def _pad(toks: np.ndarray, labels: np.ndarray, rows: int):
    extra = rows - len(labels)
    if extra < 0:
        raise ValueError(f"{len(labels)} rows do not fit a pad of {rows}")
    return {"tokens": np.concatenate(
                [toks, np.zeros((extra, toks.shape[1]), np.int32)]),
            "episode_labels": np.concatenate(
                [labels, -np.ones(extra, np.int32)]).astype(np.int32)}


@dataclasses.dataclass
class Episode:
    """One user's few-shot task: the support set, a query set of the same
    shape, and the pseudo-query (the support with re-rolled spans) that
    the fine-tune back-propagates through."""

    support: Dict[str, np.ndarray]
    query: Dict[str, np.ndarray]
    pseudo_query: Dict[str, np.ndarray]

    @property
    def n_support(self) -> int:
        return int(np.sum(self.support["episode_labels"] >= 0))


def episode(mix: dict, vocab: int, seed: int, index: int) -> Episode:
    """Task ``index`` of the run: ``way`` classes of ``shots`` rows each
    (support and query), padded to ``pad`` rows with label -1."""
    rng = rng_for(seed, 1, index)
    way, shots, seq = mix["way"], mix["shots"], mix["seq"]
    sup, qry = [], []
    for _ in range(way):
        rows = _chain_rows(rng, vocab, 2 * shots, seq, mix["successors"])
        sup.append(rows[:shots])
        qry.append(rows[shots:])
    labels = np.repeat(np.arange(way, dtype=np.int32), shots)
    support = _pad(np.concatenate(sup), labels, mix["pad"])
    query = _pad(np.concatenate(qry), labels, mix["pad"])
    toks = support["tokens"].copy()
    n_valid = way * shots
    for i in range(n_valid):  # re-roll 1 to seq/16 - 1 positions a row
        n_cut = int(rng.integers(1, max(2, seq // 16)))
        pos = rng.integers(0, seq, size=n_cut)
        toks[i, pos] = rng.integers(0, vocab, size=n_cut)
    pseudo = {"tokens": toks,
              "episode_labels": support["episode_labels"].copy()}
    return Episode(support, query, pseudo)
