#!/usr/bin/env python3
"""Where the adaptation time goes on the card, and how the device profile
shapes it: the adapt phase of ``chip_smoke.py`` (``--arch`` at full width,
bf16, random weights from seed 0; a 5-way LM episode of 48-row support and
pseudo-query sets of 64 tokens from seed 0; 10 fused fine-tune steps):
qwen2-1.5b is phase 6, mamba2-1.3b phase 11.

1. The same task adapted under several device profiles, each from zero
   deltas: the units selected, ``fisher_seconds``, ``train_seconds``, the
   loss trajectory, query accuracy and peak device memory.  The first
   profile is the one ``chip_smoke.py`` uses.
2. ``torch.profiler`` over one more adapt under that profile: device time
   by kernel, the port's own kernels' shares (Fisher; SSD scan forward,
   backward and its group sums), and the device's busy share.

    python3 benchmarks_torch/adapt_profile.py [--arch mamba2-1.3b]

Needs one NVIDIA card.
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the port's kernels by their device function names
KERNELS = {"fisher": "fisher_rows_kernel", "ssd_scan": "ssd_fwd_kernel",
           "ssd_scan_bwd": "ssd_bwd_kernel", "ssd group sums": "reduce_groups"}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-1.5b",
                    choices=["qwen2-1.5b", "mamba2-1.3b"])
    args = ap.parse_args(argv)
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
    bb = api.backbone(args.arch, preset="full", batch_size=48, seq=64)
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
        count = " + ".join(f"{kinds.count(k)} {k}"
                           for k in sorted(set(kinds))) or "no"
        print(f"[profile] {args.arch} {prof.name} ({prof.mem_kb * 1e3:.0f} "
              f"B, compute {prof.compute_frac}, channels "
              f"{prof.channel_ratio}): {count} units, "
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
    own = {}
    for what, fn in KERNELS.items():
        spans_k = [e.time_range.end - e.time_range.start
                   for e in prof.events()
                   if e.device_type == DeviceType.CUDA and fn in e.name]
        if spans_k:
            own[what] = (len(spans_k), sum(spans_k))
    # cudaLaunchKernel, and cudaLaunchKernelExC for cluster launches
    launches = sum(1 for e in prof.events()
                   if e.name.startswith("cudaLaunchKernel"))
    print(f"[trace] {args.arch} profiled adapt wall {pwall:.4f} s "
          f"(fisher_seconds {a.fisher_seconds:.4f}, train_seconds "
          f"{a.train_seconds:.4f}); device busy {busy_us / 1e6:.4f} s = "
          f"{100 * busy_us / 1e6 / pwall:.1f}% of the wall; "
          + "; ".join(f"{what} {n} launches, {us:.1f} us on the device "
                      f"({100 * us / busy_us:.1f}% of busy)"
                      for what, (n, us) in own.items())
          + f"; {launches} cudaLaunchKernel calls", flush=True)
    print(prof.key_averages().table(sort_by="self_device_time_total",
                                    row_limit=15, max_name_column_width=60))
    return 0


if __name__ == "__main__":
    sys.exit(main())
