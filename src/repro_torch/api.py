"""Public façade of the port: device profile -> adapt -> evaluate -> deploy.

    import numpy as np
    from repro_torch import api

    bb = api.backbone("qwen2-1.5b", preset="full", batch_size=48, seq=64)
    session = api.TinyTrainSession(bb, max_way=8, seed=0)   # on the card
    rng = np.random.default_rng(0)
    task = api.sample_lm_task(rng, bb.cfg.vocab, seq=64, max_way=5,
                              support_pad=48, query_pad=48)
    profile = api.DeviceProfile(name="edge-lm", mem_kb=4000,
                                compute_frac=0.5).scaled(mem=500, compute=1.6)
    adaptation = session.adapt(task, profile, iters=10)
    eng = api.ServeEngine(bb.cfg, session.params, slots=4, max_len=96)
    adaptation.fold_into(eng)
    eng.run([api.Request(uid=0, prompt=prompt, max_new=12)])

Online personalisation serves many users from one copy of the weights and
refreshes each user's deltas from their own finished streams:

    eng = api.ServeEngine(bb.cfg, session.params, personalise=adaptation.policy)
    pers = api.Personaliser(session, eng, adaptation.policy, profile=profile)
    pers.run_online(requests)

Backbones are a string-keyed registry of the LM configurations (dense
family; the edge CNNs arrive with their slice).  Entry points run on the
card unless the caller passes ``device="cpu"``.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import numpy as np

from . import configs
from .core.backbones import Backbone, lm_backbone
from .core.criterion import Budget  # noqa: F401  (escape hatch)
from .core.fisher import fisher_probe
from .core.policy import SparseUpdatePolicy
from .core.selection import select_policy
from .core.session import (  # noqa: F401  (façade re-exports)
    Adaptation, DeviceProfile, JETSON_NANO, PROFILES, RPI_ZERO, STM32F746,
    Task, TinyTrainSession, criteria, device_profile, register_profile,
)
from .models.api import ArchConfig
from .serving import (  # noqa: F401
    DeltaSet, Personaliser, Request, ServeEngine, SubmitResult,
)

__all__ = [
    "Adaptation", "DeviceProfile", "Task", "TinyTrainSession",
    "device_profile", "register_profile", "PROFILES",
    "STM32F746", "RPI_ZERO", "JETSON_NANO", "criteria",
    "ArchConfig", "Backbone", "backbone", "backbones", "register_backbone",
    "sample_lm_task", "plan_sparse_update",
    "Request", "ServeEngine", "SubmitResult", "DeltaSet", "Personaliser",
    "Budget", "configs",
]

_BACKBONES: Dict[str, Callable[..., Backbone]] = {}


def register_backbone(name: str, factory: Callable[..., Backbone]) -> None:
    """Register ``factory(**kwargs) -> Backbone`` under a string key."""
    _BACKBONES[name] = factory


def backbone(name: str, **kwargs: Any) -> Backbone:
    """Build a registered backbone: LM archs (``qwen2-1.5b``, ...) accept
    ``preset`` (smoke|100m|full), ``batch_size`` and ``seq``; the generic
    ``lm`` key an explicit ``cfg=ArchConfig``."""
    try:
        factory = _BACKBONES[name]
    except KeyError:
        raise KeyError(
            f"unknown backbone {name!r}; known: {backbones()}") from None
    return factory(**kwargs)


def backbones() -> List[str]:
    return sorted(_BACKBONES)


def _lm_from_cfg(cfg: ArchConfig, batch_size: int = 8, seq: int = 128,
                 tokens_per_batch: Optional[int] = None) -> Backbone:
    return lm_backbone(cfg, tokens_per_batch=tokens_per_batch
                       or batch_size * seq, batch_size=batch_size)


def _lm_factory(arch: str) -> Callable[..., Backbone]:
    def make(preset: str = "smoke", **kw: Any) -> Backbone:
        return _lm_from_cfg(configs.preset_config(arch, preset), **kw)

    return make


for _arch in configs.lm_arch_ids():
    register_backbone(_arch, _lm_factory(_arch))
register_backbone("lm", _lm_from_cfg)


def sample_lm_task(
    rng: np.random.Generator,
    vocab: int,
    seq: int = 64,
    *,
    max_way: int = 5,
    support_pad: int = 48,
    query_pad: int = 48,
) -> Task:
    """Sample a synthetic token-distribution episode for LM backbones."""
    from .data import lm_episode

    ep = lm_episode(rng, vocab, seq, max_way=max_way,
                    support_pad=support_pad, query_pad=query_pad)
    return Task.from_episode(ep, rng, max_way, name="lm-task")


def plan_sparse_update(
    bb: Backbone,
    params: Any,
    batch: Dict[str, Any],
    profile: Union[DeviceProfile, Budget, str],
    *,
    n_samples: int,
    criterion: str = "tinytrain",
    shard_channels: int = 1,
) -> Tuple[SparseUpdatePolicy, float]:
    """Fisher probe on one token batch -> budgeted policy (Algorithm 1
    lines 1-4), driven by the backbone's own LM loss.  ``batch`` holds
    ``tokens`` and ``labels`` tensors on the params' device.  Returns
    (policy, fisher_seconds)."""
    from .core.session import _as_budget, _resolve_criterion

    mode, channel_mode = _resolve_criterion(criterion)
    if channel_mode != "dynamic":
        raise ValueError(
            f"criterion {criterion!r} uses a static channel mode "
            f"({channel_mode}); batch planning supports dynamic-channel "
            "criteria only")
    potentials, chans, dt = fisher_probe(
        bb, params, lambda p, b, taps=None: bb.loss(p, b, taps=taps), batch,
        n_samples=n_samples)
    policy = select_policy(bb.unit_costs, potentials, chans,
                           _as_budget(profile), criterion=mode,
                           shard_channels=shard_channels)
    return policy, dt
