"""Public façade of the port: the deploy surface of this slice.

    import torch
    from repro_torch import api
    from repro_torch.models import transformer as T

    cfg = api.configs.get_config("qwen2-1.5b")
    params = T.init_params(cfg, torch.Generator("cuda").manual_seed(0))
    eng = api.ServeEngine(cfg, params, slots=8, max_len=512)
    eng.run([api.Request(uid=0, prompt=prompt, max_new=16)])

The adaptation half of ``repro.api`` (backbones, sessions, tasks) arrives
with later slices.
"""
from __future__ import annotations

from . import configs  # noqa: F401
from .models.api import ArchConfig  # noqa: F401
from .serving import Request, ServeEngine, SubmitResult  # noqa: F401

__all__ = ["ArchConfig", "Request", "ServeEngine", "SubmitResult", "configs"]
