"""The numbers that decide ``correct``, each a gap between what the
program produced and what the reference works out.  Norms are taken leaf
by leaf: the gap between the two norms of a leaf, over the larger of the
reference's norm of that leaf and of the median leaf (some gradients are
all but zero), and the worst leaf counts."""
from __future__ import annotations

from typing import Dict, Iterable, List, Optional

import torch

NOUGHT = 1e-3  # leaves below this share of the median gradient norm


def norms(tree: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(v.double().norm()) for k, v in tree.items()}


def median(xs: Iterable[float]) -> float:
    xs = sorted(xs)
    n = len(xs)
    return 0.0 if not n else (xs[n // 2] if n % 2
                              else 0.5 * (xs[n // 2 - 1] + xs[n // 2]))


def counted_leaves(ref_grads: Dict[str, torch.Tensor]) -> List[str]:
    """Leaves whose reference gradient is not nought to rounding: at least
    a thousandth of the median leaf's norm (the rule, not a list of
    names)."""
    n = norms(ref_grads)
    med = median(n.values())
    return [k for k, v in n.items() if v >= NOUGHT * med]


def norm_gap(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
             keep: Optional[List[str]] = None) -> float:
    keep = list(ref) if keep is None else keep
    np_, nr = norms({k: prog[k] for k in keep}), norms({k: ref[k]
                                                       for k in keep})
    floor = median(nr.values())
    return max((abs(np_[k] - nr[k]) / max(nr[k], floor, 1e-30)
                for k in keep), default=float("nan"))


def rows(t: torch.Tensor) -> Dict[str, torch.Tensor]:
    """An (L, C) table as one leaf a row."""
    return {f"L{i}": t[i] for i in range(t.shape[0])}


def loss_gap(prog: List[float], ref: List[float]) -> float:
    """The worst step's gap of losses over the larger of the reference's
    loss at that step and at the first: the fine-tune drives the loss
    towards 0 within a few steps, and a gap relative to a vanishing loss
    measures nothing but rounding."""
    scale = abs(ref[0])
    return max(abs(p - r) / max(abs(r), scale, 1e-30)
               for p, r in zip(prog, ref))
