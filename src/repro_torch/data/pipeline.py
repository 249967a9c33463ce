"""Deterministic, resumable, shardable host data pipeline: the port of
``repro.data.pipeline``, host-side numpy copied as it is.

Every loader carries an explicit integer cursor; ``state_dict()`` /
``load_state_dict()`` round-trip it as a plain dict, so a restarted job
resumes on the exact next batch.  Sharding is by
(host_id, n_hosts): each host draws only its slice of the global batch, so
the pipeline scales to multi-pod topologies without coordination.
"""
from __future__ import annotations

from typing import Dict

import numpy as np

from . import synthetic


class TokenLoader:
    """Sharded LM token batches with next-token labels."""

    def __init__(
        self,
        vocab: int,
        global_batch: int,
        seq: int,
        *,
        seed: int = 0,
        host_id: int = 0,
        n_hosts: int = 1,
    ):
        assert global_batch % n_hosts == 0
        self.vocab = vocab
        self.global_batch = global_batch
        self.local_batch = global_batch // n_hosts
        self.seq = seq
        self.seed = seed
        self.host_id = host_id
        self.n_hosts = n_hosts
        self.step = 0

    def next(self) -> Dict[str, np.ndarray]:
        # independent stream per (seed, step, host): restart-safe
        rng = np.random.default_rng(
            (self.seed, self.step, self.host_id)
        )
        toks = synthetic.markov_tokens(
            rng, self.vocab, self.local_batch, self.seq + 1, order_seed=self.seed
        )
        self.step += 1
        return {
            "tokens": toks[:, :-1].astype(np.int32),
            "labels": toks[:, 1:].astype(np.int32),
        }

    def state_dict(self) -> Dict[str, int]:
        return {"step": self.step, "seed": self.seed}

    def load_state_dict(self, s: Dict[str, int]) -> None:
        self.step = int(s["step"])
        self.seed = int(s["seed"])


class EpisodeStream:
    """Resumable stream of CDFSL episodes for one target domain."""

    def __init__(
        self,
        domain: str,
        *,
        seed: int = 0,
        res: int = 32,
        max_way: int = 10,
        support_pad: int = 128,
        query_pad: int = 128,
        kind: str = "image",
        vocab: int = 0,
        seq: int = 0,
    ):
        self.domain = domain
        self.seed = seed
        self.kind = kind
        self.res = res
        self.max_way = max_way
        self.support_pad = support_pad
        self.query_pad = query_pad
        self.vocab = vocab
        self.seq = seq
        self.cursor = 0

    def next(self) -> synthetic.Episode:
        rng = np.random.default_rng((self.seed, self.cursor, hash(self.domain) & 0xFFFF))
        self.cursor += 1
        if self.kind == "image":
            return synthetic.sample_episode(
                rng, self.domain, res=self.res, max_way=self.max_way,
                support_pad=self.support_pad, query_pad=self.query_pad,
            )
        return synthetic.lm_episode(
            rng, self.vocab, self.seq, max_way=self.max_way,
            support_pad=self.support_pad, query_pad=self.query_pad,
        )

    def state_dict(self) -> Dict[str, int]:
        return {"cursor": self.cursor, "seed": self.seed}

    def load_state_dict(self, s: Dict[str, int]) -> None:
        self.cursor = int(s["cursor"])
        self.seed = int(s["seed"])
