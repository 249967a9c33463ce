"""TinyTrain's online stage in plain float32: the ProtoNet episode loss
(cosine prototypes, temperature 10), the Fisher probe of Eq. 2 through
per-layer taps, the top-K channel choice it implies, and the sparse
fine-tune of the selected heads' deltas under Adam.

The fine-tune follows the program's policy (its units and their heads):
layer selection is the program's budgeted choice, and the probe and the
channel choice are judged on their own (``fisher_gap``, ``regret``)."""
from __future__ import annotations

from typing import Any, Dict, List, Sequence, Tuple

import torch

from . import ssm_lm as R

TEMPERATURE = 10.0


def _l2n(x: torch.Tensor) -> torch.Tensor:
    return x * torch.rsqrt((x * x).sum(-1, keepdim=True) + 1e-6)


def episode_loss(fs: torch.Tensor, ls: torch.Tensor, fq: torch.Tensor,
                 lq: torch.Tensor, max_way: int) -> torch.Tensor:
    """Cross-entropy of the query rows against the support prototypes;
    rows labelled -1 count nowhere."""
    onehot = (ls[:, None] == torch.arange(max_way, device=ls.device)).float()
    counts = onehot.sum(0)
    protos = onehot.T @ fs / counts.clamp_min(1.0)[:, None]
    sim = TEMPERATURE * (_l2n(fq) @ _l2n(protos).T)
    sim = sim.masked_fill(~(counts > 0)[None, :], -1e30)
    valid = lq >= 0
    nll = torch.logsumexp(sim, -1) - sim.gather(
        1, lq.clamp_min(0).long()[:, None])[:, 0]
    return (nll * valid).sum() / valid.sum().clamp_min(1)


def _features(params, sz, tokens, **kw) -> torch.Tensor:
    return R.forward(params, sz, tokens, **kw).mean(dim=1)


def _loss(params, sz, ep: Dict[str, torch.Tensor], max_way: int,
          **kw) -> torch.Tensor:
    """Support and pseudo-query rows go through the model together; the
    taps (one row each) apply to both."""
    rows = torch.cat([ep["s_tokens"], ep["q_tokens"]])
    taps = kw.pop("taps", None)
    if taps is not None:
        kw["taps"] = [torch.cat([t, t]) for t in taps]
    f = _features(params, sz, rows, **kw)
    n = ep["s_tokens"].shape[0]
    return episode_loss(f[:n], ep["s_labels"], f[n:], ep["q_labels"],
                        max_way)


def fisher(params, sz, ep, max_way: int, prec=R.F32) -> torch.Tensor:
    """Eq. 2 per layer and channel: (L, C), Δ = Σ_n (∂L/∂tap_n)² / (2N)
    over the support's valid rows."""
    b = ep["s_tokens"].shape[0]
    dev = ep["s_tokens"].device
    taps = [torch.ones(b, sz.n_ssm_heads, device=dev, requires_grad=True)
            for _ in range(sz.n_layers)]
    loss = _loss(params, sz, ep, max_way, taps=taps, prec=prec, remat=True)
    grads = torch.autograd.grad(loss, taps)
    mask = (ep["s_labels"] >= 0).float()[:, None]
    n = mask.sum()
    return torch.stack([(g.double() ** 2 * mask).sum(0) / (2 * n)
                        for g in grads]).float()


def regret(scores: torch.Tensor, units: Sequence[Tuple[int, Sequence[int]]]
           ) -> float:
    """The worst selected unit's share of Fisher information lost by its
    heads against the top-K of ``scores`` (L, C): 0 when the program's
    heads are the best K."""
    worst = 0.0
    for layer, heads in units:
        row = scores[layer].double()
        best = torch.topk(row, len(heads)).values.sum()
        got = row[torch.as_tensor(list(heads), device=row.device)].sum()
        if best > 0:
            worst = max(worst, float(1.0 - got / best))
    return worst


def topk_units(scores: torch.Tensor,
               units: Sequence[Tuple[int, Sequence[int]]]
               ) -> List[Tuple[int, List[int]]]:
    """The same layers and K, with the heads ``scores`` ranks first."""
    return [(layer, sorted(torch.topk(scores[layer], len(heads)).indices
                           .tolist())) for layer, heads in units]


def finetune(params, sz, ep, max_way: int,
             units: Sequence[Tuple[int, Sequence[int]]], *, steps: int,
             lr: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
             prec=R.F32, drop_half: bool = False):
    """``steps`` Adam steps on zero deltas of the units' heads.  Returns
    (losses, first gradients, deltas), the trees keyed "L{layer}.{w}".
    ``drop_half`` is a planted fault: the loss over half the query rows."""
    dev = ep["s_tokens"].device
    d, hd = sz.d_model, sz.ssm_head_dim
    leaves: Dict[str, torch.Tensor] = {}
    deltas = {}
    for layer, heads in units:
        k = len(heads) * hd
        pack = {"w_z": torch.zeros(d, k, device=dev, requires_grad=True),
                "w_x": torch.zeros(d, k, device=dev, requires_grad=True),
                "w_out": torch.zeros(k, d, device=dev, requires_grad=True)}
        deltas[layer] = (pack, torch.as_tensor(list(heads), device=dev))
        for w, t in pack.items():
            leaves[f"L{layer}.{w}"] = t
    horizon = min(layer for layer, _ in units)
    m = {k: torch.zeros_like(t) for k, t in leaves.items()}
    v = {k: torch.zeros_like(t) for k, t in leaves.items()}
    e = dict(ep)
    if drop_half:
        q = ep["q_labels"].clone()
        q[q.shape[0] // 2:] = -1
        e["q_labels"] = q
    losses, first = [], None
    for t in range(1, steps + 1):
        loss = _loss(params, sz, e, max_way, deltas=deltas, horizon=horizon,
                     prec=prec, remat=True)
        grads = torch.autograd.grad(loss, list(leaves.values()))
        losses.append(float(loss.detach()))
        g = dict(zip(leaves, grads))
        if first is None:
            first = {k: x.detach().clone() for k, x in g.items()}
        with torch.no_grad():
            for k, p in leaves.items():
                m[k].mul_(b1).add_(g[k], alpha=1 - b1)
                v[k].mul_(b2).addcmul_(g[k], g[k], value=1 - b2)
                mh = m[k] / (1 - b1 ** t)
                vh = v[k] / (1 - b2 ** t)
                p.sub_(lr * mh / (vh.sqrt() + eps))
    return losses, first, {k: t.detach() for k, t in leaves.items()}
