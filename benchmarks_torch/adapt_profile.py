#!/usr/bin/env python3
"""Where the adaptation time goes on the card, and how the device profile
shapes it: the adapt phase of ``chip_smoke.py`` (qwen2-1.5b at full width,
bf16, random weights from seed 0; a 5-way LM episode of 48-row support and
pseudo-query sets of 64 tokens from seed 0; 10 fused fine-tune steps).

1. The same task adapted under several device profiles, each from zero
   deltas: the units selected, ``fisher_seconds``, ``train_seconds``, the
   loss trajectory, query accuracy and peak device memory.  The first
   profile is the one ``chip_smoke.py`` uses.
2. ``torch.profiler`` over one more adapt under that profile: device time
   by kernel, the Fisher kernel's share, and the device's busy share.

    python3 benchmarks_torch/adapt_profile.py

Needs one NVIDIA card.
"""
from __future__ import annotations

import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("adapt_profile: needs an NVIDIA card", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch import api

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip())
    bb = api.backbone("qwen2-1.5b", preset="full", batch_size=48, seq=64)
    session = api.TinyTrainSession(bb, max_way=8, seed=0)
    task = api.sample_lm_task(np.random.default_rng(0), bb.cfg.vocab, seq=64,
                              max_way=5, support_pad=48, query_pad=48)
    edge_lm = api.DeviceProfile(name="edge-lm", mem_kb=4000, compute_frac=0.5)
    profiles = [
        edge_lm.scaled(mem=500, compute=1.6),  # chip_smoke.py's
        api.JETSON_NANO.scaled(mem=750),
        api.JETSON_NANO.scaled(mem=200),
        api.RPI_ZERO.scaled(mem=1000),
        api.DeviceProfile(name="half-channels-1.5GB", mem_kb=1.5e6,
                          compute_frac=0.8, channel_ratio=0.25),
    ]
    for prof in profiles:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        a = session.adapt(task, prof, iters=10)
        kinds = [u.kind for u in a.policy.units]
        print(f"[profile] {prof.name} ({prof.mem_kb * 1e3:.0f} B, compute "
              f"{prof.compute_frac}, channels {prof.channel_ratio}): "
              f"{kinds.count('attn')} attn + {kinds.count('mlp')} mlp units, "
              f"horizon {a.policy.horizon}; fisher_seconds "
              f"{a.fisher_seconds:.4f}, train_seconds {a.train_seconds:.4f}, "
              f"peak {torch.cuda.max_memory_allocated()} B, accuracy "
              f"{a.accuracy():.3f}; losses "
              f"{[round(x, 4) for x in a.losses]}", flush=True)

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        a = session.adapt(task, profiles[0], iters=10)
        torch.cuda.synchronize()
        pwall = time.perf_counter() - t0
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events() if e.device_type == DeviceType.CUDA)
    busy_us, hi = 0.0, float("-inf")
    for lo, end in spans:
        busy_us += max(0.0, end - max(lo, hi))
        hi = max(hi, end)
    fisher_us = sum(e.time_range.end - e.time_range.start
                    for e in prof.events()
                    if e.device_type == DeviceType.CUDA
                    and "fisher_rows_kernel" in e.name)
    launches = sum(1 for e in prof.events() if e.name == "cudaLaunchKernel")
    print(f"[trace] profiled adapt wall {pwall:.4f} s (fisher_seconds "
          f"{a.fisher_seconds:.4f}, train_seconds {a.train_seconds:.4f}); "
          f"device busy {busy_us / 1e6:.4f} s = "
          f"{100 * busy_us / 1e6 / pwall:.1f}% of the wall; Fisher kernel "
          f"{fisher_us:.1f} us on the device; {launches} cudaLaunchKernel "
          "calls", flush=True)
    print(prof.key_averages().table(sort_by="self_device_time_total",
                                    row_limit=15, max_name_column_width=60))
    return 0


if __name__ == "__main__":
    sys.exit(main())
