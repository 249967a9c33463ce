"""What any driver needs: the port's configuration from the sizes, the
device's clock and memory, and the record's common keys."""
from __future__ import annotations

import gc
import time

import numpy as np
import torch


def arch_config(sizes):
    from repro_torch.models.api import ArchConfig

    return ArchConfig(**sizes.arch).validate()


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def now(device) -> float:
    """Host clock after the device has finished everything queued."""
    sync(device)
    return time.perf_counter()


def peak_bytes(device) -> int:
    return (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)


def device_kind(device) -> str:
    """The name the card gives, as the result's line reports it."""
    return (torch.cuda.get_device_name(device) if device.type == "cuda"
            else device.type)


def release(device) -> None:
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def on(tree, device):
    return {k: torch.as_tensor(np.asarray(v), device=device)
            for k, v in tree.items()}


def profile_of(api, p: dict):
    """The mix's device profile: a named envelope scaled as the mix says."""
    base = api.DeviceProfile(name=p["name"], mem_kb=p["mem_kb"],
                             compute_frac=p["compute_frac"],
                             channel_ratio=p["channel_ratio"])
    return base.scaled(mem=p["scale_mem"], compute=p["scale_compute"])


def task_of(api, ep, way: int, name: str):
    return api.Task(name=name, support=ep.support, query=ep.query,
                    pseudo_query=ep.pseudo_query, max_way=way)
