"""Architecture registry: ``--arch <id>`` for every assigned config.

Each module exposes ``config()`` (exact published dims) and ``reduced()``
(same family, CPU-smoke scale).  A copy of ``repro.configs``: the port
imports nothing of the JAX package.  The edge-CNN lookup (``get_cnn``)
arrives with the CNN slice.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import List

from ..models.api import ArchConfig

_LM_ARCHS = {
    "zamba2-1.2b": "zamba2_1p2b",
    "paligemma-3b": "paligemma_3b",
    "deepseek-v3-671b": "deepseek_v3_671b",
    "mixtral-8x7b": "mixtral_8x7b",
    "gemma-2b": "gemma_2b",
    "starcoder2-3b": "starcoder2_3b",
    "stablelm-12b": "stablelm_12b",
    "qwen2-1.5b": "qwen2_1p5b",
    "mamba2-1.3b": "mamba2_1p3b",
    "whisper-base": "whisper_base",
}


def lm_arch_ids() -> List[str]:
    return list(_LM_ARCHS)


def get_config(arch: str) -> ArchConfig:
    mod = importlib.import_module(f".{_LM_ARCHS[arch]}", __name__)
    return mod.config()


def get_reduced(arch: str) -> ArchConfig:
    mod = importlib.import_module(f".{_LM_ARCHS[arch]}", __name__)
    return mod.reduced()


def preset_config(arch: str, preset: str = "smoke") -> ArchConfig:
    """Resolve an LM arch at one of three scales: smoke | 100m | full."""
    if preset == "full":
        return get_config(arch)
    cfg = get_reduced(arch)
    if preset == "100m":
        # ~100M-param variant of the same family
        cfg = dataclasses.replace(
            cfg, name=cfg.name.replace("smoke", "100m"),
            n_layers=max(8, cfg.n_layers), d_model=768, d_ff=2048,
            n_heads=12 if cfg.n_heads else 0,
            n_kv_heads=min(12, max(cfg.n_kv_heads, 1)) if cfg.n_heads else 0,
            head_dim=64 if cfg.n_heads else 0, vocab=32000,
        )
    return cfg
