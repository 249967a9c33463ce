"""Shared harness of the paper-table benches on the port: the twin of
``benchmarks/common.py``.

The pipeline mirrors the paper end to end: (1) offline ProtoNet
meta-training of an edge-CNN backbone on *source* domains, from the
port's own seeded init (a ``torch.Generator``); (2) online adaptation on
held-out *target* domains with each on-device training method through
the port's ``api`` façade; (3) query-set accuracy averaged over episodes.
Meta-trained weights are cached under ``results/cache/`` (``.gitignore``
lists ``results/``), so every table reuses one offline stage.  Runs on
the card unless the caller passes ``device="cpu"``.  Imports nothing of
JAX or of the JAX package.
"""
from __future__ import annotations

import os
import sys
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if os.path.join(ROOT, "src") not in sys.path:
    sys.path.insert(0, os.path.join(ROOT, "src"))

import torch  # noqa: E402

from repro_torch import api  # noqa: E402
from repro_torch.core.protonet import make_meta_train_step  # noqa: E402
from repro_torch.data import sample_episode  # noqa: E402
from repro_torch.optim import adam  # noqa: E402
from repro_torch.utils import resolve_device, tree_leaves  # noqa: E402

RES = 48
MAX_WAY = 8
SUPPORT_PAD = 64
QUERY_PAD = 80
SOURCE_DOMAINS = ("gratings", "checkers", "rings", "mosaic")
TARGET_DOMAINS = ("glyphs", "stripes", "blobs", "spots", "waves")
CACHE_DIR = os.path.join(ROOT, "results", "cache")


def small_cnn_backbone(name: str = "tiny"):
    key = "tiny-cnn" if name == "tiny" else name
    return api.backbone(key, in_res=RES, batch_size=SUPPORT_PAD)


def sample_task(rng, domain, **kw):
    return api.sample_task(rng, domain, res=RES, max_way=MAX_WAY,
                           support_pad=SUPPORT_PAD, query_pad=QUERY_PAD, **kw)


def meta_train(
    arch: str = "tiny",
    episodes: int = 150,
    lr: float = 1e-3,
    seed: int = 0,
    cache: bool = True,
    device: str = "cuda",
    cache_dir: Optional[str] = None,
) -> Tuple[object, list]:
    """Offline stage: ProtoNet meta-training on the source domains, from
    the port's init seeded with ``seed``; cached per (arch, episodes, seed,
    device type)."""
    dev = resolve_device(device)
    bb = small_cnn_backbone(arch)
    params = bb.init(torch.Generator(device=dev).manual_seed(seed))
    path = os.path.join(cache_dir or CACHE_DIR,
                        f"meta_torch_{arch}_{episodes}_{seed}_{dev.type}.pt")
    if cache and os.path.exists(path):
        leaves = torch.load(path, map_location=dev)
        it = iter(leaves)
        return bb, [{k: next(it) for k in p} for p in params]
    opt = adam(lr)
    step = make_meta_train_step(bb.features, opt, MAX_WAY)
    opt_state = opt.init(params)
    rng = np.random.default_rng(seed)
    for i in range(episodes):
        dom = SOURCE_DOMAINS[i % len(SOURCE_DOMAINS)]
        ep = sample_episode(rng, dom, res=RES, max_way=MAX_WAY,
                            support_pad=SUPPORT_PAD, query_pad=QUERY_PAD)
        sup = {k: torch.as_tensor(v, device=dev) for k, v in ep.support.items()}
        qry = {k: torch.as_tensor(v, device=dev) for k, v in ep.query.items()}
        params, opt_state, _ = step(params, opt_state, sup, qry)
    if cache:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        torch.save([t.detach() for t in tree_leaves(params)], path)
    return bb, params


# paper budgets: "around 1 MB" backward memory (Sec 2.2): the Pi Zero
# preset carries exactly that envelope
DEFAULT_PROFILE = api.RPI_ZERO
DEFAULT_BUDGET = DEFAULT_PROFILE.budget()
FEWSHOT = dict(max_support_total=40, max_support_per_class=8)


def make_session(bb, params, lr: float) -> api.TinyTrainSession:
    return api.TinyTrainSession(bb, params, lr=lr, baseline_lr=1e-3,
                                max_way=MAX_WAY)


def run_method(
    bb,
    params,
    method: str,
    domains: Sequence[str] = TARGET_DOMAINS,
    episodes_per_domain: int = 2,
    iters: int = 40,  # paper: 40 iterations
    profile: api.DeviceProfile = DEFAULT_PROFILE,
    lr: float = 1e-3,
    seed: int = 0,
    criterion: str = "tinytrain",
    channel_mode: str = "dynamic",
    session: Optional[api.TinyTrainSession] = None,
) -> Dict[str, object]:
    """Adapt and evaluate one method over target-domain episodes: per-domain
    accuracies and times.  ``method`` is any ``TinyTrainSession.baseline``
    name: none, fulltrain, lastlayer, tinytl, adapterdrop<k>, sparseupdate,
    tinytrain."""
    rng = np.random.default_rng(seed + 1000)
    if method in ("tinytrain", "sparseupdate", "lastlayer"):
        lr = 3e-3  # delta params start at zero; tuned per method
    if session is None:
        session = make_session(bb, params, lr)
    # the ES baseline prepares its static policy offline on a PROXY source
    # domain (it cannot see target data), as in the paper
    proxy_task = None
    if method == "sparseupdate":
        proxy_task = sample_task(np.random.default_rng(seed),
                                 SOURCE_DOMAINS[0])
    crit = criterion
    if method == "tinytrain" and channel_mode != "dynamic":
        crit = channel_mode  # the "random" | "l2norm" registered criteria

    accs: Dict[str, List[float]] = {d: [] for d in domains}
    fisher_times, train_times, steps_rates, transfers = [], [], [], []
    for dom in domains:
        for _ in range(episodes_per_domain):
            task = sample_task(rng, dom, **FEWSHOT)
            if method == "none":
                acc = session.evaluate(task)
            else:
                a = (session.adapt(task, profile, criterion=crit, iters=iters,
                                   seed=seed) if method == "tinytrain" else
                     session.baseline(method, task, profile, iters=iters,
                                      proxy_task=proxy_task, seed=seed))
                if a.fisher_seconds:
                    fisher_times.append(a.fisher_seconds)
                if a.train_seconds:
                    train_times.append(a.train_seconds)
                    steps_rates.append(a.steps_per_sec)
                    transfers.append(a.host_transfers)
                acc = a.accuracy()
            accs[dom].append(float(acc))

    per_domain = {d: float(np.mean(v)) for d, v in accs.items()}

    def mean(xs):
        return float(np.mean(xs)) if xs else 0.0

    return {
        "method": method,
        "per_domain": per_domain,
        "avg": float(np.mean(list(per_domain.values()))),
        "fisher_s": mean(fisher_times),
        "train_s": mean(train_times),
        "steps_per_sec": mean(steps_rates),
        "host_transfers": mean(transfers),
    }
