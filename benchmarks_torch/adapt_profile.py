#!/usr/bin/env python3
"""Where the adaptation time goes on the card, and how the device profile
shapes it: the adapt phase of ``chip_smoke.py`` (``--arch`` at full width,
random weights from seed 0).  An LM (bf16; a 5-way episode of 48-row
support and pseudo-query sets of 64 tokens from seed 0; 10 fused
fine-tune steps): qwen2-1.5b is phase 6, mamba2-1.3b phase 11.  An edge
CNN (f32 at ``--in-res``, 84 for the paper's backbones; a 'glyphs' task
of 64 support rows, 96 query rows and up to 8 ways from seed 0; 20 fused
fine-tune steps): mcunet, mobilenetv2 and proxylessnas are phase 14's
adapts, tiny-cnn at in_res 32 is phase 13's backbone.

1. The same task adapted under several device profiles, each from zero
   deltas: the units selected, ``fisher_seconds``, ``train_seconds``, the
   loss trajectory, query accuracy and peak device memory.  The first
   profile is the one ``chip_smoke.py`` uses.
2. An edge CNN only: how far the fine-tune carries a rounding
   difference, the phase-14 adapt on the card against the same adapt on
   the CPU, and the CPU at one thread against the CPU at all its threads
   (the same code, another reduction order): the loss gap step by step,
   the first step past 1e-4, the deltas' gap and the query accuracies.
3. ``torch.profiler`` over one more adapt under the first profile: device
   time by kernel, the port's own kernels' shares (Fisher; SSD scan
   forward, backward and its group sums), the device's busy share and the
   launches an adapt makes.

    python3 benchmarks_torch/adapt_profile.py [--arch mamba2-1.3b]
    python3 benchmarks_torch/adapt_profile.py --arch mcunet [--in-res 84]

Needs one NVIDIA card.
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CNNS = ("mcunet", "mobilenetv2", "proxylessnas", "tiny-cnn")
# the port's kernels by their device function names
KERNELS = {"fisher": "fisher_rows_kernel", "ssd_scan": "ssd_fwd_kernel",
           "ssd_scan_bwd": "ssd_bwd_kernel", "ssd group sums": "reduce_groups"}


def precision(api, session, task, profile, iters: int) -> None:
    """The fine-tune's sensitivity to rounding: card against CPU, and the
    CPU at one thread against the CPU at all its threads."""
    import torch

    from repro_torch.utils import tree_map

    cpu_params = tree_map(lambda t: t.cpu(), session.params)
    threads = torch.get_num_threads()
    runs = {"card": session.adapt(task, profile, iters=iters)}
    for n in (threads, 1):
        torch.set_num_threads(n)
        cpu = api.TinyTrainSession(session.backbone, cpu_params, max_way=8)
        runs[f"cpu{n}"] = cpu.adapt(task, profile, iters=iters)
    torch.set_num_threads(threads)
    for a_name, b_name in (("card", f"cpu{threads}"),
                           (f"cpu{threads}", "cpu1")):
        a, b = runs[a_name], runs[b_name]
        gaps = [abs(x - y) for x, y in zip(a.losses, b.losses)]
        past = next((i for i, g in enumerate(gaps) if g > 1e-4), None)
        dgap = max((x["conv"]["w"].cpu() - y["conv"]["w"].cpu()).abs()
                   .max().item()
                   for x, y in zip(a.deltas.values(), b.deltas.values()))
        print(f"[precision] {a_name} vs {b_name} ({iters} steps, policy "
              f"{'identical' if a.policy.units == b.policy.units else 'DIFFERENT'}"
              f"): loss gap by step {[f'{g:.2g}' for g in gaps]}, first "
              f"step past 1e-4: {past}, max delta gap {dgap:.3g}, accuracy "
              f"{a.accuracy():.4f} vs {b.accuracy():.4f}", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-1.5b",
                    choices=["qwen2-1.5b", "mamba2-1.3b", *CNNS])
    ap.add_argument("--in-res", type=int, default=None,
                    help="an edge CNN's input resolution (default: its "
                         "builder's, 84; tiny-cnn 32)")
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
    cnn = args.arch in CNNS
    if cnn:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        res = args.in_res or (32 if args.arch == "tiny-cnn" else 84)
        bb = api.backbone(args.arch, in_res=res, batch_size=64)
        task = api.sample_task(np.random.default_rng(0), "glyphs", res=res,
                               max_way=8, support_pad=64, query_pad=96,
                               max_support_total=64, max_support_per_class=16)
        iters = 20
        profiles = [api.STM32F746.scaled(mem=1.6),  # chip_smoke.py's
                    api.STM32F746, api.RPI_ZERO, api.JETSON_NANO]
    else:
        bb = api.backbone(args.arch, preset="full", batch_size=48, seq=64)
        task = api.sample_lm_task(np.random.default_rng(0), bb.cfg.vocab,
                                  seq=64, max_way=5, support_pad=48,
                                  query_pad=48)
        iters = 10
        edge_lm = api.DeviceProfile(name="edge-lm", mem_kb=4000,
                                    compute_frac=0.5)
        profiles = [
            edge_lm.scaled(mem=500, compute=1.6),  # chip_smoke.py's
            api.JETSON_NANO.scaled(mem=750),
            api.JETSON_NANO.scaled(mem=200),
            api.RPI_ZERO.scaled(mem=1000),
            api.DeviceProfile(name="half-channels-1.5GB", mem_kb=1.5e6,
                              compute_frac=0.8, channel_ratio=0.25),
        ]
    session = api.TinyTrainSession(bb, max_way=8, seed=0)
    if cnn:
        print(f"[setup] {args.arch} ({bb.cfg.name}, {bb.cfg.n_layers} conv "
              f"layers) at in_res {res}, {task.n_support} support rows of "
              f"{len(task.support['episode_labels'])}, {iters} steps, f32 "
              f"with TF32 off", flush=True)
    for prof in profiles:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        a = session.adapt(task, prof, iters=iters)
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

    if cnn:
        precision(api, session, task, profiles[0], iters)

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        a = session.adapt(task, profiles[0], iters=iters)
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
    # cudaLaunchKernel, cudaLaunchKernelExC for cluster launches, and the
    # driver's cuLaunchKernel(Ex) that cuDNN's runtime-compiled kernels use
    launches = sum(1 for e in prof.events()
                   if e.name.startswith(("cudaLaunchKernel",
                                         "cuLaunchKernel")))
    device_ops = sum(1 for e in prof.events()
                     if e.device_type == DeviceType.CUDA)
    print(f"[trace] {args.arch} profiled adapt wall {pwall:.4f} s "
          f"(fisher_seconds {a.fisher_seconds:.4f}, train_seconds "
          f"{a.train_seconds:.4f}); device busy {busy_us / 1e6:.4f} s = "
          f"{100 * busy_us / 1e6 / pwall:.1f}% of the wall; "
          + "; ".join(f"{what} {n} launches, {us:.1f} us on the device "
                      f"({100 * us / busy_us:.1f}% of busy)"
                      for what, (n, us) in own.items())
          + f"; {launches} kernel launch calls, {device_ops} device "
          f"operations", flush=True)
    print(prof.key_averages().table(sort_by="self_device_time_total",
                                    row_limit=15, max_name_column_width=60))
    return 0


if __name__ == "__main__":
    sys.exit(main())
