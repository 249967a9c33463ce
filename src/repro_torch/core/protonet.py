"""ProtoNet with cosine distance (paper Sec. 2.1, Eq. 1): the port of
``repro.core.protonet``, the online loss and accuracy and the offline
meta-training step.

Prototypes come from whatever support labels are present, padded to
``max_way`` classes, so episodes of any (way, shot) share one shape.  Rows
labelled -1 (bucket padding) belong to no class: they add nothing to a
prototype, to the loss or to the accuracy.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Tuple

import torch

TEMPERATURE = 10.0  # cosine-similarity scaling (Hu et al. 2022)


def _l2n(x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    # rsqrt(ss + eps) keeps the gradient finite at exactly-zero vectors
    # (padded class prototypes), unlike norm() + eps
    return x * torch.rsqrt(torch.sum(x * x, dim=-1, keepdim=True) + eps)


def prototypes(feats: torch.Tensor, labels: torch.Tensor,
               max_way: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Class centroids: (protos (max_way, F), valid (max_way,)).  Labels
    outside [0, max_way) are ignored (padding)."""
    classes = torch.arange(max_way, device=labels.device)
    onehot = (labels[:, None] == classes[None, :]).to(feats.dtype)  # (N, K)
    counts = onehot.sum(dim=0)
    protos = (onehot.T @ feats) / torch.clamp(counts[:, None], min=1.0)
    return protos, counts > 0


def proto_logits(query_feats: torch.Tensor, protos: torch.Tensor,
                 valid: torch.Tensor) -> torch.Tensor:
    """Cosine-similarity logits (Eq. 1 with d = cosine distance), in
    float32, or in float64 for float64 features."""
    dt = torch.promote_types(query_feats.dtype, torch.float32)
    sim = _l2n(query_feats.to(dt)) @ _l2n(protos.to(dt)).T  # (Nq, K)
    return torch.where(valid[None, :], TEMPERATURE * sim,
                       torch.full_like(sim, -1e30))


def _logits(feature_fn: Callable[..., torch.Tensor], params: Any,
            support: Dict[str, torch.Tensor], query: Dict[str, torch.Tensor],
            max_way: int, **fkw) -> torch.Tensor:
    fs = feature_fn(params, support, **fkw)
    fq = feature_fn(params, query, **fkw)
    protos, valid = prototypes(fs, support["episode_labels"], max_way)
    return proto_logits(fq, protos, valid)


def episode_loss(feature_fn: Callable[..., torch.Tensor], params: Any,
                 support: Dict[str, torch.Tensor],
                 query: Dict[str, torch.Tensor], max_way: int,
                 **fkw) -> torch.Tensor:
    """Cross-entropy of query points against support prototypes."""
    logits = _logits(feature_fn, params, support, query, max_way, **fkw)
    return _cross_entropy(logits, query["episode_labels"])


def feature_loss(fs: torch.Tensor, support_labels: torch.Tensor,
                 fq: torch.Tensor, query_labels: torch.Tensor,
                 max_way: int) -> torch.Tensor:
    """:func:`episode_loss` from features already computed: support
    features ``fs`` with their labels, query features ``fq`` with theirs."""
    protos, valid = prototypes(fs, support_labels, max_way)
    return _cross_entropy(proto_logits(fq, protos, valid), query_labels)


def _cross_entropy(logits: torch.Tensor,
                   labels: torch.Tensor) -> torch.Tensor:
    """Mean cross-entropy over the rows whose label is >= 0."""
    labels = labels.long()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, 1, labels.clamp(min=0)[:, None])[:, 0]
    mask = (labels >= 0).float()
    return ((logz - gold) * mask).sum() / torch.clamp(mask.sum(), min=1.0)


def episode_accuracy(feature_fn: Callable[..., torch.Tensor], params: Any,
                     support: Dict[str, torch.Tensor],
                     query: Dict[str, torch.Tensor], max_way: int,
                     **fkw) -> torch.Tensor:
    logits = _logits(feature_fn, params, support, query, max_way, **fkw)
    labels = query["episode_labels"].long()
    mask = (labels >= 0).float()
    hit = (logits.argmax(dim=-1) == labels).float()
    return (hit * mask).sum() / torch.clamp(mask.sum(), min=1.0)


def make_meta_train_step(feature_fn: Callable[..., torch.Tensor], optimizer,
                         max_way: int):
    """Offline meta-training: one episodic update of the whole backbone
    (Sec. 2.1).  ``step(params, opt_state, support, query) -> (params,
    opt_state, loss)``, out of place: the params passed in are untouched."""
    from ..optim import apply_updates
    from .sparse import _value_and_grad

    def step(params, opt_state, support, query):
        loss, grads = _value_and_grad(
            lambda p: episode_loss(feature_fn, p, support, query, max_way),
            params)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        return apply_updates(params, updates), opt_state, loss

    return step
