#!/usr/bin/env python3
"""Where the serving time goes on the card: the serve phase of
``chip_smoke.py`` (qwen2-1.5b at full width, bf16, 8 slots, max_len 512,
chunk 32, prefill_block 8, 8 requests of 32-256 prompt tokens and 16 new
tokens each, weights and prompts from seed 0), broken down three ways:

- wall time of the run, and host time blocked in the engine's per-tick
  flag reads and per-chunk event fetches (``core.adapt._fetch``);
- wall time per tick kind (block prefill vs single-token decode);
- ``torch.profiler``: device time by kernel, and the device's busy share of
  the profiled window.

    python3 benchmarks_torch/serve_profile.py [--trace DIR]
        [--paging] [--page-budget N] [--kv-int8]

``--paging`` serves the same requests from the paged KV cache (page size
16, the default budget of 256 pages unless ``--page-budget``; ``--kv-int8``
stores the pages in int8), phase 7 of ``chip_smoke.py``.  Needs one
NVIDIA card.  The profiled run is a second run of the same
requests; the unprofiled run gives the wall times.
"""
from __future__ import annotations

import argparse
import collections
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def requests(cfg, Request, np):
    rng = np.random.default_rng(0)
    return [Request(uid=i,
                    prompt=rng.integers(0, cfg.vocab, int(n)).astype(np.int32),
                    max_new=16)
            for i, n in enumerate(rng.integers(32, 257, 8))]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--trace", default=None,
                    help="directory for a chrome trace of the profiled run")
    ap.add_argument("--paging", action="store_true",
                    help="serve from the paged KV cache")
    ap.add_argument("--page-budget", type=int, default=None,
                    help="pages per layer arena (implies --paging; default: "
                         "the fixed-stripe capacity)")
    ap.add_argument("--kv-int8", action="store_true",
                    help="int8 pages with per-token scales (implies "
                         "--paging)")
    args = ap.parse_args()
    paged = args.paging or args.kv_int8 or args.page_budget is not None
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("serve_profile: needs an NVIDIA card", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch import configs
    from repro_torch.core import adapt
    from repro_torch.models import transformer as T
    from repro_torch.serving import Request, ServeEngine
    from repro_torch.serving import engine as E

    cfg = configs.get_config("qwen2-1.5b")
    params = T.init_params(cfg, torch.Generator("cuda").manual_seed(0))
    kw = (dict(kv_paging=True, page_budget=args.page_budget,
               kv_int8=args.kv_int8 or None) if paged else {})
    eng = ServeEngine(cfg, params, slots=8, max_len=512, chunk=32, **kw)
    eng.run([Request(uid=-1, prompt=np.arange(8, dtype=np.int32), max_new=2)])

    # host time blocked in reads, and wall time per tick kind
    fetch_s = [0.0]
    fetch = adapt._fetch

    def timed_fetch(tree):
        t0 = time.perf_counter()
        try:
            return fetch(tree)
        finally:
            fetch_s[0] += time.perf_counter() - t0

    tick_s = collections.defaultdict(list)
    advance = E.ServeEngine._advance

    def timed_advance(self, plan, block):
        t0 = time.perf_counter()
        out = advance(self, plan, block)
        torch.cuda.synchronize()
        tick_s["block" if block else "decode"].append(time.perf_counter() - t0)
        return out

    adapt._fetch = timed_fetch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.run(requests(cfg, Request, np))
    wall = time.perf_counter() - t0
    adapt._fetch = fetch
    rep = eng.last_run_report
    mem = rep["memory"]
    layout = (f"paged KV, {mem['n_pages']} pages of {mem['page_size']} rows"
              f"{', int8' if mem['kv_int8'] else ''}" if mem["kv_paging"]
              else "contiguous KV")
    print(f"[run] {layout}: wall {wall:.4f} s, {rep['ticks']} ticks, "
          f"{rep['new_tokens']} new tokens, {rep['host_syncs']} host syncs, "
          f"outcomes {rep['outcomes']}, host blocked in _fetch "
          f"{fetch_s[0]:.4f} s")

    E.ServeEngine._advance = timed_advance
    eng.run(requests(cfg, Request, np))
    E.ServeEngine._advance = advance
    for kind, ts in sorted(tick_s.items()):
        print(f"[ticks] {kind}: {len(ts)} ticks, median "
              f"{1e3 * float(np.median(ts)):.3f} ms, total {sum(ts):.4f} s "
              "(forward + advance, synchronised)")

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.run(requests(cfg, Request, np))
        torch.cuda.synchronize()
        pwall = time.perf_counter() - t0
    # device busy time: the union of the device-side events' intervals
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == DeviceType.CUDA)
    busy_us, hi = 0.0, float("-inf")
    for lo, end in spans:
        busy_us += max(0.0, end - max(lo, hi))
        hi = max(hi, end)
    launches = sum(1 for e in prof.events() if e.name == "cudaLaunchKernel")
    print(f"[profile] profiled wall {pwall:.4f} s; device busy "
          f"{busy_us / 1e6:.4f} s over {len(spans)} device events = "
          f"{100 * busy_us / 1e6 / pwall:.1f}% of the profiled wall and "
          f"{100 * busy_us / 1e6 / wall:.1f}% of the unprofiled wall; "
          f"{launches} cudaLaunchKernel calls = "
          f"{launches / rep['ticks']:.0f} per tick")
    events = prof.key_averages()
    print(events.table(sort_by="self_device_time_total", row_limit=15,
                       max_name_column_width=60))
    print(events.table(sort_by="self_cpu_time_total", row_limit=12,
                       max_name_column_width=60))
    if args.trace:
        os.makedirs(args.trace, exist_ok=True)
        prof.export_chrome_trace(os.path.join(args.trace, "serve.json"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
