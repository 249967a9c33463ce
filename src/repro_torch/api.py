"""Public façade of the port: device profile -> adapt -> evaluate -> deploy.

    import numpy as np
    from repro_torch import api

    bb = api.backbone("mcunet", batch_size=64)             # in_res 84
    session = api.TinyTrainSession(bb, max_way=8, seed=0)   # on the card
    task = api.sample_task(np.random.default_rng(0), "glyphs", res=84)
    adaptation = session.adapt(task, api.STM32F746.scaled(mem=1.6))
    print(adaptation.policy.describe(), adaptation.accuracy())
    served = adaptation.fold_into(session.params)           # base cost

The LM backbones adapt the same way and fold into the serving engine:

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

The paper's baselines and criteria share the session:

    for name in ("none", "fulltrain", "lastlayer", "tinytl",
                 "adapterdrop50", "sparseupdate"):
        a = session.baseline(name, task, profile, proxy_task=proxy)
    a = session.adapt(task, profile, criterion="l2norm")  # or "random", ...
    fleet = session.adapt_many(tasks, profile)  # one policy per task

``register_criterion(name, score_mode, channel_mode)`` adds a criterion
under a name ``adapt(criterion=...)`` and ``baseline`` take.

Online personalisation serves many users from one copy of the weights and
refreshes each user's deltas from their own finished streams:

    eng = api.ServeEngine(bb.cfg, session.params, personalise=adaptation.policy)
    pers = api.Personaliser(session, eng, adaptation.policy, profile=profile)
    pers.run_online(requests)

Many users are served from R engine replicas behind one router (sticky
placement, least-loaded routing, a replica's failure re-routed), and the
Personaliser ships each refresh to it as int8 payload bytes:

    fleet = api.FleetRouter(bb.cfg, session.params, replicas=2,
                            personalise=adaptation.policy)
    api.Personaliser(session, fleet, adaptation.policy).run_online(requests)

A token batch is scored on the serving block-prefill path, and a fleet of
tasks adapts split over a mesh's data positions:

    nll = session.score_stream(tokens, block=32)     # (N,) mean NLL
    from repro_torch.launch.mesh import make_debug_mesh
    fleet = session.adapt_many(tasks, profile, mesh=make_debug_mesh(2))

The encoder-decoder and VLM families take episodes whose rows carry their
conditioning (whisper's frames, paligemma's patch embeddings) and serve
requests that carry it as ``enc_feats``:

    bb = api.backbone("whisper-base", preset="full", batch_size=48, seq=64)
    task = api.sample_encdec_task(rng, bb.cfg, seq=64, max_way=5)
    adaptation = session.adapt(task, profile, iters=10)
    eng.run([api.Request(uid=0, prompt=prompt, max_new=12,
                         enc_feats=frames)])              # (1500, 512)

Backbones are a string-keyed registry: the paper's edge CNNs (``mcunet``,
``mobilenetv2``, ``proxylessnas``) and the ``tiny-cnn`` demo, and the LM
configurations (dense, moe, ssm, hybrid, vlm and audio families).  Entry
points run on the card unless the caller passes ``device="cpu"``.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import numpy as np

from . import configs
from .core.backbones import Backbone, cnn_backbone, lm_backbone
from .core.criterion import Budget  # noqa: F401  (escape hatch)
from .core.fisher import fisher_probe
from .core.policy import SparseUpdatePolicy
from .core.selection import select_policy
from .core.session import (  # noqa: F401  (façade re-exports)
    Adaptation, DeviceProfile, JETSON_NANO, PROFILES, RPI_ZERO, STM32F746,
    Task, TinyTrainSession, criteria, device_profile, register_criterion,
    register_profile,
)
from .models import edge_cnn as _edge_cnn
from .models.api import ArchConfig
from .serving import (  # noqa: F401
    DeltaSet, FaultConfig, FleetRouter, Personaliser, Request, ServeEngine,
    SubmitResult, decode_delta_payload, encode_delta_payload,
)

__all__ = [
    "Adaptation", "DeviceProfile", "Task", "TinyTrainSession",
    "device_profile", "register_profile", "PROFILES",
    "STM32F746", "RPI_ZERO", "JETSON_NANO", "criteria", "register_criterion",
    "ArchConfig", "Backbone", "backbone", "backbones", "register_backbone",
    "sample_task", "sample_lm_task", "sample_encdec_task",
    "plan_sparse_update",
    "Request", "ServeEngine", "SubmitResult", "FaultConfig", "DeltaSet",
    "Personaliser", "FleetRouter", "encode_delta_payload",
    "decode_delta_payload", "Budget", "configs",
]

_BACKBONES: Dict[str, Callable[..., Backbone]] = {}


def register_backbone(name: str, factory: Callable[..., Backbone]) -> None:
    """Register ``factory(**kwargs) -> Backbone`` under a string key."""
    _BACKBONES[name] = factory


def backbone(name: str, **kwargs: Any) -> Backbone:
    """Build a registered backbone: edge CNNs (``mcunet``, ``tiny-cnn``,
    ...) accept ``in_res`` and ``batch_size``; LM archs (``qwen2-1.5b``,
    ...) ``preset`` (smoke|100m|full), ``batch_size`` and ``seq``; the
    generic ``lm`` key an explicit ``cfg=ArchConfig``."""
    try:
        factory = _BACKBONES[name]
    except KeyError:
        raise KeyError(
            f"unknown backbone {name!r}; known: {backbones()}") from None
    return factory(**kwargs)


def backbones() -> List[str]:
    return sorted(_BACKBONES)


def _cnn_factory(builder: Callable[..., Any]) -> Callable[..., Backbone]:
    def make(in_res: Optional[int] = None, batch_size: int = 64) -> Backbone:
        cfg = builder() if in_res is None else builder(in_res=in_res)
        return cnn_backbone(cfg, batch_size=batch_size)

    return make


def _lm_from_cfg(cfg: ArchConfig, batch_size: int = 8, seq: int = 128,
                 tokens_per_batch: Optional[int] = None) -> Backbone:
    return lm_backbone(cfg, tokens_per_batch=tokens_per_batch
                       or batch_size * seq, batch_size=batch_size)


def _lm_factory(arch: str) -> Callable[..., Backbone]:
    def make(preset: str = "smoke", **kw: Any) -> Backbone:
        return _lm_from_cfg(configs.preset_config(arch, preset), **kw)

    return make


for _name, _builder in _edge_cnn.EDGE_CNNS.items():
    register_backbone(_name, _cnn_factory(_builder))
register_backbone("tiny-cnn", _cnn_factory(_edge_cnn.tiny_cnn))
for _arch in configs.lm_arch_ids():
    register_backbone(_arch, _lm_factory(_arch))
register_backbone("lm", _lm_from_cfg)


def sample_task(
    rng: np.random.Generator,
    domain: str,
    *,
    res: int = 48,
    max_way: int = 8,
    support_pad: int = 64,
    query_pad: int = 80,
    **episode_kw: Any,
) -> Task:
    """Sample a cross-domain vision episode and package it as a Task."""
    from .data import sample_episode

    ep = sample_episode(rng, domain, res=res, max_way=max_way,
                        support_pad=support_pad, query_pad=query_pad,
                        **episode_kw)
    return Task.from_episode(ep, rng, max_way, name=domain)


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


def sample_encdec_task(
    rng: np.random.Generator,
    cfg: ArchConfig,
    seq: int = 32,
    *,
    max_way: int = 5,
    support_pad: int = 48,
    query_pad: int = 48,
    **episode_kw: Any,
) -> Task:
    """Sample a conditioned-decoder episode for whisper/paligemma backbones.

    The conditioning key and feature shape come from the config
    (``"frames"``/``(enc_len, d_model)`` for encoder-decoders,
    ``"image_embeds"``/``(n_img_tokens, img_embed_dim)`` for VLM
    prefixes), so the batches flow through the same ``build_inputs`` path
    the serving engine uses."""
    from .data import encdec_episode

    shape = cfg.enc_feats_shape
    if shape is None:
        raise ValueError(
            f"{cfg.name!r} takes no encoder conditioning; use sample_lm_task")
    key = "frames" if cfg.is_encoder_decoder else "image_embeds"
    ep = encdec_episode(rng, cfg.vocab, seq, feat_key=key, feat_shape=shape,
                        max_way=max_way, support_pad=support_pad,
                        query_pad=query_pad, **episode_kw)
    return Task.from_episode(ep, rng, max_way, name=f"encdec-{cfg.name}")


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
