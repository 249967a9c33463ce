"""Synthetic episodes: the port of ``repro.data.synthetic``'s vision half
(nine procedural image domains, the Meta-Dataset B.1 various-way
various-shot sampler ``sample_episode`` and the pseudo-query augmentation
``augment_support``), its token half (``markov_tokens``,
``lm_episode``, ``augment_lm_support``) and its conditioned-decoder half
(``encdec_episode``, ``augment_encdec_support``: token episodes whose
rows carry whisper frames or SigLIP patch embeddings).

Host-side numpy, copied as it is so that the same seed gives the same
arrays in both packages; images stay NHWC float32 here and become tensors
at the task boundary (``core.session.Task``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np


@dataclasses.dataclass
class Episode:
    support: Dict[str, np.ndarray]
    query: Dict[str, np.ndarray]
    n_way: int
    domain: str


DOMAINS = (
    "gratings", "blobs", "glyphs", "checkers", "stripes",
    "spots", "waves", "mosaic", "rings",
)


# ---------------------------------------------------------------------------
# Domain generators (class latent -> prototype; prototype -> noisy samples)
# ---------------------------------------------------------------------------


def _grid(res: int) -> Tuple[np.ndarray, np.ndarray]:
    y, x = np.mgrid[0:res, 0:res].astype(np.float32) / res
    return x, y


def _proto(domain: str, rng: np.random.Generator, res: int) -> np.ndarray:
    x, y = _grid(res)
    if domain == "gratings":
        fx, fy = rng.uniform(2, 12, 2)
        ph = rng.uniform(0, 2 * np.pi, 3)
        img = np.stack([np.sin(2 * np.pi * (fx * x + fy * y) + p) for p in ph], -1)
    elif domain == "blobs":
        img = np.zeros((res, res, 3), np.float32)
        for _ in range(rng.integers(2, 6)):
            cx, cy = rng.uniform(0.15, 0.85, 2)
            s = rng.uniform(0.05, 0.2)
            col = rng.uniform(-1, 1, 3)
            g = np.exp(-((x - cx) ** 2 + (y - cy) ** 2) / (2 * s * s))
            img += g[..., None] * col
    elif domain == "glyphs":
        img = np.zeros((res, res), np.float32)
        px, py = res // 2, res // 2
        for _ in range(rng.integers(6, 14)):
            dx, dy = rng.integers(-res // 4, res // 4 + 1, 2)
            steps = max(abs(dx), abs(dy), 1)
            for t in np.linspace(0, 1, steps * 2):
                ix = int(np.clip(px + t * dx, 0, res - 1))
                iy = int(np.clip(py + t * dy, 0, res - 1))
                img[iy, max(ix - 1, 0) : ix + 2] = 1.0
            px, py = int(np.clip(px + dx, 2, res - 3)), int(np.clip(py + dy, 2, res - 3))
        img = np.stack([img] * 3, -1) * 2 - 1
    elif domain == "checkers":
        p = rng.integers(3, 10)
        off = rng.uniform(0, 1, 2)
        c = ((np.floor(x * p + off[0]) + np.floor(y * p + off[1])) % 2)
        cols = rng.uniform(-1, 1, (2, 3))
        img = cols[c.astype(int)]
    elif domain == "stripes":
        ang = rng.uniform(0, np.pi)
        f = rng.uniform(3, 14)
        u = x * np.cos(ang) + y * np.sin(ang)
        duty = rng.uniform(0.3, 0.7)
        s = ((u * f) % 1.0 < duty).astype(np.float32)
        cols = rng.uniform(-1, 1, (2, 3))
        img = cols[s.astype(int)]
    elif domain == "spots":
        p = rng.uniform(4, 12)
        r0 = rng.uniform(0.15, 0.45)
        u = (x * p) % 1.0 - 0.5
        v = (y * p) % 1.0 - 0.5
        s = (u * u + v * v < r0 * r0 * 0.25).astype(np.float32)
        col = rng.uniform(-1, 1, 3)
        img = s[..., None] * col
    elif domain == "waves":
        f1, f2 = rng.uniform(2, 10, 2)
        a = rng.uniform(0.05, 0.3)
        img = np.stack([
            np.sin(2 * np.pi * f1 * (x + a * np.sin(2 * np.pi * f2 * y)) + k)
            for k in rng.uniform(0, 2 * np.pi, 3)
        ], -1)
    elif domain == "mosaic":
        k = rng.integers(4, 9)
        cx = rng.uniform(0, 1, k)
        cy = rng.uniform(0, 1, k)
        cols = rng.uniform(-1, 1, (k, 3))
        d = (x[..., None] - cx) ** 2 + (y[..., None] - cy) ** 2
        img = cols[np.argmin(d, -1)]
    elif domain == "rings":
        cx, cy = rng.uniform(0.3, 0.7, 2)
        f = rng.uniform(4, 16)
        r = np.sqrt((x - cx) ** 2 + (y - cy) ** 2)
        img = np.stack([np.sin(2 * np.pi * f * r + p)
                        for p in rng.uniform(0, 2 * np.pi, 3)], -1)
    else:
        raise ValueError(domain)
    return img.astype(np.float32)


def _render(proto: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    """One noisy sample from a class prototype (shift + gain + noise)."""
    res = proto.shape[0]
    sx, sy = rng.integers(-res // 8, res // 8 + 1, 2)
    img = np.roll(np.roll(proto, sx, axis=1), sy, axis=0)
    if rng.random() < 0.5:
        img = img[:, ::-1]
    gain = rng.uniform(0.7, 1.3)
    img = img * gain + rng.normal(0, 0.15, img.shape)
    return img.astype(np.float32)


# ---------------------------------------------------------------------------
# Meta-Dataset B.1 episodic sampler
# ---------------------------------------------------------------------------


def sample_episode(
    rng: np.random.Generator,
    domain: str,
    *,
    res: int = 32,
    max_way: int = 10,
    min_way: int = 5,
    max_support_total: int = 100,
    max_support_per_class: int = 25,
    query_per_class: int = 10,
    support_pad: Optional[int] = None,
    query_pad: Optional[int] = None,
) -> Episode:
    """Various-way-various-shot episode with imbalanced support (B.1)."""
    way = int(rng.integers(min_way, max_way + 1))
    protos = [_proto(domain, rng, res) for _ in range(way)]

    # imbalanced shots: dirichlet split of the support budget
    w = rng.dirichlet(np.ones(way) * 2.0)
    shots = np.maximum(1, np.minimum(
        (w * max_support_total).astype(int), max_support_per_class))

    s_imgs, s_lbl, q_imgs, q_lbl = [], [], [], []
    for k in range(way):
        for _ in range(int(shots[k])):
            s_imgs.append(_render(protos[k], rng))
            s_lbl.append(k)
        for _ in range(query_per_class):
            q_imgs.append(_render(protos[k], rng))
            q_lbl.append(k)

    def pack(imgs, lbl, pad):
        imgs = np.stack(imgs)
        lbl = np.asarray(lbl, np.int32)
        if pad is not None and len(lbl) < pad:
            extra = pad - len(lbl)
            imgs = np.concatenate([imgs, np.zeros((extra,) + imgs.shape[1:], np.float32)])
            lbl = np.concatenate([lbl, -np.ones(extra, np.int32)])
        return {"images": imgs, "episode_labels": lbl}

    return Episode(
        support=pack(s_imgs, s_lbl, support_pad),
        query=pack(q_imgs, q_lbl, query_pad),
        n_way=way,
        domain=domain,
    )


def augment_support(
    rng: np.random.Generator, support: Dict[str, np.ndarray]
) -> Dict[str, np.ndarray]:
    """Pseudo-query set via augmentation (Hu et al. 2022, Appendix C)."""
    imgs = support["images"]
    out = np.empty_like(imgs)
    for i in range(imgs.shape[0]):
        im = imgs[i]
        if rng.random() < 0.5:
            im = im[:, ::-1]
        sx, sy = rng.integers(-3, 4, 2)
        im = np.roll(np.roll(im, sx, axis=1), sy, axis=0)
        im = im + rng.normal(0, 0.1, im.shape).astype(np.float32)
        out[i] = im
    return {"images": out, "episode_labels": support["episode_labels"].copy()}


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


# ---------------------------------------------------------------------------
# Encoder-decoder / multimodal synthetic data
# ---------------------------------------------------------------------------


def encdec_episode(
    rng: np.random.Generator,
    vocab: int,
    seq: int,
    *,
    feat_key: str,
    feat_shape: Tuple[int, int],
    max_way: int = 8,
    min_way: int = 4,
    shots: int = 8,
    query_per_class: int = 8,
    support_pad: Optional[int] = None,
    query_pad: Optional[int] = None,
) -> Episode:
    """Few-shot episodes for conditioned decoders (whisper / paligemma).

    Each class is a distinct (token distribution, conditioning prototype)
    pair: tokens come from a per-class bigram chain (as in
    :func:`lm_episode`) and every sample additionally carries a noisy copy
    of the class's conditioning features — ``"frames"`` of shape
    ``(enc_len, d_model)`` for whisper-style encoders, ``"image_embeds"``
    of shape ``(n_img_tokens, img_embed_dim)`` for SigLIP-style prefixes
    (``feat_key``/``feat_shape`` per ``ArchConfig.enc_feats_shape``).
    Padding rows (label -1) carry all-zero features.
    """
    if feat_key not in ("frames", "image_embeds"):
        raise ValueError(
            f"feat_key must be 'frames' or 'image_embeds', got {feat_key!r}")
    way = int(rng.integers(min(min_way, max_way), max_way + 1))
    seeds = rng.integers(0, 2**31 - 1, size=way)
    protos = rng.normal(0, 1.0, (way,) + tuple(feat_shape)).astype(np.float32)

    def gen(k, n):
        toks = markov_tokens(rng, vocab, n, seq, order_seed=int(seeds[k]))
        feats = protos[k][None] + 0.1 * rng.normal(
            0, 1.0, (n,) + tuple(feat_shape)).astype(np.float32)
        return toks, feats

    def batch(n_per):
        toks, feats = zip(*(gen(k, n_per) for k in range(way)))
        return (np.concatenate(toks), np.concatenate(feats),
                np.repeat(np.arange(way, dtype=np.int32), n_per))

    def pack(toks, feats, lbl, pad):
        if pad is not None and len(lbl) < pad:
            extra = pad - len(lbl)
            toks = np.concatenate([toks, np.zeros((extra, seq), np.int32)])
            feats = np.concatenate([
                feats, np.zeros((extra,) + tuple(feat_shape), np.float32)])
            lbl = np.concatenate([lbl, -np.ones(extra, np.int32)])
        return {"tokens": toks, feat_key: feats, "episode_labels": lbl}

    return Episode(pack(*batch(shots), support_pad),
                   pack(*batch(query_per_class), query_pad), way,
                   f"encdec:{feat_key}")


def augment_encdec_support(
    rng: np.random.Generator, support: Dict[str, np.ndarray]
) -> Dict[str, np.ndarray]:
    """Pseudo-queries for conditioned decoders: token spans re-rolled as in
    :func:`augment_lm_support` plus Gaussian jitter on the conditioning
    features (the class prototype survives; the sample noise is re-drawn)."""
    out = augment_lm_support(rng, {
        "tokens": support["tokens"],
        "episode_labels": support["episode_labels"],
    })
    for key in ("frames", "image_embeds"):
        if key in support:
            feats = support[key]
            out[key] = (feats + 0.05 * rng.normal(
                0, 1.0, feats.shape)).astype(feats.dtype)
    return out
