#!/usr/bin/env python3
"""Where the serving time goes on the card: the serve phase of
``chip_smoke.py`` (qwen2-1.5b at full width, bf16, 8 slots, max_len 512,
chunk 32, prefill_block 8, 8 requests of 32-256 prompt tokens and 16 new
tokens each, weights and prompts from seed 0), broken down three ways:

- wall time of ``--repeats`` runs of the same requests, each with its
  ticks, ticks issued, chunks and host syncs, and host time blocked in the
  engine's per-chunk event fetches (``core.adapt._fetch``);
- wall time per tick kind (block prefill, single-token decode, and dead:
  issued after its chunk's exit), each tick synchronised;
- ``torch.profiler``: device time by kernel, the block flash kernels'
  share of it, launches per tick, and the device's busy share of the
  profiled window.

    python3 benchmarks_torch/serve_profile.py [--trace DIR]
        [--paging] [--page-budget N] [--kv-int8]
        [--arch mamba2-1.3b | zamba2-1.2b | mixtral-8x7b | deepseek-v3-671b
                | gemma-2b | whisper-base | paligemma-3b]
        [--repeats N] [--issue-masked] [--temperature T --top-k K]

``--paging`` serves the same requests from the paged KV cache (page size
16, the default budget of 256 pages unless ``--page-budget``; ``--kv-int8``
stores the pages in int8), phase 7 of ``chip_smoke.py``.  ``--arch
mamba2-1.3b`` serves phase 11's shape instead (4 slots, max_len 96, chunk
16, 10 requests of 4-15 prompt tokens and 12 new ones) from random
weights.  ``--arch zamba2-1.2b`` serves phase 5's traffic on zamba2 at
its published width and depth (``chip_smoke.py`` phase 19 (c)): the SSD
recurrence, and the shared block's kernel 2 (kernel 4 under
``--paging``) 6 times a block tick.  ``--arch mixtral-8x7b`` and ``--arch deepseek-v3-671b`` serve
phase 5's traffic on the moe family at its published widths with the
depth of ``chip_smoke.py`` phase 18 (16 of 32 layers, 4 of 61: what one
80 GB card holds in bf16); deepseek's paged serve pages its MLA latent
rows.  ``--arch gemma-2b`` serves phase 5's traffic on gemma-2b at its
published config (18 layers, 8 query heads of 256 over one kv head: the
block flash kernels at D 256).  ``--arch whisper-base`` and ``--arch
paligemma-3b`` serve phase 5's traffic with encoder inputs, as
``chip_smoke.py`` phase 20 does (whisper: each request's 1500 frames
encoded once at staging and cross-attended every tick; paligemma: a
256-token image prefix inside max_len 768); a paged pool then holds eight
residents' KV and encoder runs unless ``--page-budget``, and the run also
gives the encoder's share (each staging's encode, synchronised, against
the run's wall).  ``--issue-masked`` turns the engine's skip of work it knows to
be masked off (every tick of a chunk's budget and both forward programs
a tick: the predicated path alone).  ``--temperature T`` (with
``--top-k K``, seed 11) samples instead of the greedy pick, and the
profile then also gives the sampler's device time and launches alone
(``ServeEngine._pick`` over the serve's slots and vocabulary).  Needs one NVIDIA card.  The profiled run is a last run
of the same requests; the unprofiled runs give the wall times.  The
script runs against any checkout of the port: point it at another tree by
copying it into that tree's ``benchmarks_torch/``.
"""
from __future__ import annotations

import argparse
import collections
import os
import statistics
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
from chip_smoke import (  # noqa: E402  the moe family's depth cut, and
    ENC_MAX_LEN, MOE_LAYERS, enc_page_budget, enc_requests,  # phase 20's
)                                                            # traffic


def requests(cfg, Request, np):
    if cfg.enc_feats_shape is not None:  # chip_smoke.py phase 20's serve
        return enc_requests(cfg, Request, np)
    rng = np.random.default_rng(0)
    if cfg.family == "ssm":  # chip_smoke.py phase 11's folded serve
        return [Request(uid=i, prompt=rng.integers(
            0, cfg.vocab, size=int(rng.integers(4, 16))).astype(np.int32),
            max_new=12) for i in range(10)]
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
    ap.add_argument("--arch", default="qwen2-1.5b",
                    choices=("qwen2-1.5b", "mamba2-1.3b", "zamba2-1.2b",
                             *MOE_LAYERS, "gemma-2b", *ENC_MAX_LEN))
    ap.add_argument("--repeats", type=int, default=1,
                    help="unprofiled runs of the requests (walls)")
    ap.add_argument("--issue-masked", action="store_true",
                    help="issue every tick of a chunk's budget and both "
                         "forward programs a tick (no skip of masked work)")
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="sample at this temperature (0: greedy)")
    ap.add_argument("--top-k", type=int, default=0,
                    help="top-k filter of the sampled pick")
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

    cfg = configs.get_config(args.arch)
    if args.arch in MOE_LAYERS:
        import dataclasses

        cfg = dataclasses.replace(cfg, n_layers=MOE_LAYERS[args.arch])
    params = T.init_params(cfg, torch.Generator("cuda").manual_seed(0))
    kw = (dict(kv_paging=True, page_budget=args.page_budget,
               kv_int8=args.kv_int8 or None) if paged else {})
    kw.update(dict(slots=4, max_len=96, chunk=16) if cfg.family == "ssm"
              else dict(slots=8, max_len=ENC_MAX_LEN.get(args.arch, 512),
                        chunk=32))
    if paged and args.page_budget is None and args.arch in ENC_MAX_LEN:
        kw["page_budget"] = enc_page_budget(cfg, 8, kw["max_len"])
    if args.issue_masked:
        kw["skip_masked"] = False
    if args.temperature > 0:
        kw.update(temperature=args.temperature, top_k=args.top_k,
                  sample_seed=11)
    eng = ServeEngine(cfg, params, **kw)
    # warm: one short request (an encoder config's carries its inputs)
    eng.run(requests(cfg, Request, np)[:1]
            if cfg.enc_feats_shape is not None else
            [Request(uid=-1, prompt=np.arange(8, dtype=np.int32), max_new=2)])

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

    def timed_advance(self, plan, *rest):
        t0 = time.perf_counter()
        out = advance(self, plan, *rest)
        torch.cuda.synchronize()
        if rest and isinstance(rest[0], bool):
            # an engine that reads a flag per tick passes the tick kind in
            kind = "block" if rest[0] else "decode"
        else:  # read only after the synchronise above
            kind = ("dead" if not bool(plan.live)
                    else "block" if bool(plan.block) else "decode")
        tick_s[kind].append(time.perf_counter() - t0)
        return out

    walls = []
    for _ in range(max(1, args.repeats)):
        fetch_s[0] = 0.0
        adapt._fetch = timed_fetch
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.run(requests(cfg, Request, np))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        adapt._fetch = fetch
        walls.append(wall)
        rep = eng.last_run_report
        mem = rep["memory"]
        layout = (f"paged KV, {mem['n_pages']} pages of {mem['page_size']} "
                  f"rows{', int8' if mem['kv_int8'] else ''}"
                  if mem["kv_paging"] else
                  "recurrent state" if cfg.family == "ssm" else "contiguous KV")
        print(f"[run] {cfg.name} {layout}: wall {wall:.4f} s = "
              f"{rep['new_tokens'] / wall:.2f} tok/s, {rep['ticks']} ticks, "
              f"{rep.get('ticks_issued', rep['ticks_dispatched'])} ticks "
              f"and {rep.get('forwards_issued', '-')} forward programs "
              f"issued, {rep['chunks']} chunks, {rep['new_tokens']} new "
              f"tokens, {rep['host_syncs']} host syncs, outcomes "
              f"{rep['outcomes']}, host blocked in _fetch {fetch_s[0]:.4f} s",
              flush=True)
    wall = statistics.median(walls)
    print(f"[walls] {', '.join(f'{w:.4f}' for w in walls)} s; median "
          f"{wall:.4f} s")

    enc_s = []
    encode = E.ServeEngine._encode_cached

    def timed_encode(self, rid, req):
        # an encode at staging (a cache hit costs nothing), synchronised
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        hit = rid in self._enc_rows
        out = encode(self, rid, req)
        torch.cuda.synchronize()
        if not hit:
            enc_s.append(time.perf_counter() - t0)
        return out

    E.ServeEngine._advance = timed_advance
    E.ServeEngine._encode_cached = timed_encode
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.run(requests(cfg, Request, np))
    torch.cuda.synchronize()
    twall = time.perf_counter() - t0
    E.ServeEngine._advance = advance
    E.ServeEngine._encode_cached = encode
    for kind, ts in sorted(tick_s.items()):
        print(f"[ticks] {kind}: {len(ts)} ticks, median "
              f"{1e3 * float(np.median(ts)):.3f} ms, total {sum(ts):.4f} s "
              "(forward + advance, synchronised)")
    if enc_s:
        print(f"[encode] {len(enc_s)} encodes at staging, median "
              f"{1e3 * float(np.median(enc_s)):.3f} ms each, total "
              f"{sum(enc_s):.4f} s = {100 * sum(enc_s) / twall:.1f}% of that "
              f"run's wall {twall:.4f} s (synchronised)")

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
    # cudaLaunchKernel, and cudaLaunchKernelExC for the cluster launches of
    # the block flash kernels
    launches = sum(1 for e in prof.events()
                   if e.name.startswith("cudaLaunchKernel"))
    print(f"[profile] profiled wall {pwall:.4f} s; device busy "
          f"{busy_us / 1e6:.4f} s over {len(spans)} device events = "
          f"{100 * busy_us / 1e6 / pwall:.1f}% of the profiled wall and "
          f"{100 * busy_us / 1e6 / wall:.1f}% of the median unprofiled wall; "
          f"{launches} cudaLaunchKernel calls = "
          f"{launches / rep['ticks']:.0f} per live tick, "
          f"{launches / rep.get('ticks_issued', rep['ticks']):.0f} per "
          f"issued tick")
    # the block flash kernels' (kernels 2 and 4) share of device time
    attn = [e for e in prof.events()
            if e.device_type == DeviceType.CUDA and "flash_" in e.name]
    attn_us = sum(e.time_range.end - e.time_range.start for e in attn)
    print(f"[profile] attention kernels (flash_*): {attn_us / 1e6:.4f} s on "
          f"the device over {len(attn)} launches = "
          f"{100 * attn_us / max(busy_us, 1e-9):.1f}% of device busy time")
    if args.temperature > 0:
        # the sampler alone, at the serve's slots and vocabulary
        lg = torch.randn((eng.n_slots, cfg.vocab), device="cuda",
                         dtype=params["embed"].dtype)
        sid = torch.arange(eng.n_slots, dtype=torch.int32, device="cuda")
        idx = torch.full((eng.n_slots,), 5, dtype=torch.int32, device="cuda")
        for _ in range(3):
            eng._pick(lg, sid, idx)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as pp:
            for _ in range(10):
                eng._pick(lg, sid, idx)
            torch.cuda.synchronize()
        dev_us = sum(e.time_range.end - e.time_range.start
                     for e in pp.events()
                     if e.device_type == DeviceType.CUDA)
        n = sum(1 for e in pp.events()
                if e.name.startswith("cudaLaunchKernel"))
        print(f"[sampler] one pick over ({eng.n_slots}, {cfg.vocab}) "
              f"logits: {dev_us / 10 / 1e3:.4f} ms of device time in "
              f"{n / 10:.0f} kernel launches (torch.profiler, 10 picks); "
              f"the serve's {rep['ticks']} live ticks pick once each")
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
