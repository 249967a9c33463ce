"""Serving driver: batched requests through the continuous-batching engine.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-1.5b \
        --preset full --requests 8 --slots 8 --max-new 16 --max-len 512

With ``--adapt``, first runs TinyTrain through the façade on a synthetic
task (Fisher probe, Eq. 3 selection, sparse fine-tune) under the device
profile ``--profile`` and folds the deltas into the engine before serving,
as ``examples/serve_batched.py`` does.

Runs on the card unless ``--device cpu``.  Weights are random, from a
seeded ``torch.Generator``.  The flags of ``repro.launch.serve`` that
belong to later slices of the port are accepted by name and refused with
the ROADMAP item that brings them.  (There ``--device`` names the profile;
here it is the torch device, and ``--profile`` names the profile.)
"""
from __future__ import annotations

import argparse
import time
from typing import List, Optional

import numpy as np
import torch

from .. import api, configs
from ..models import transformer as T
from ..serving import Request, ServeEngine

# flag -> (takes a value, ROADMAP queue 1 item that brings it)
LATER_FLAGS = {
    "--temperature": (True, "11.1"), "--top-k": (True, "11.1"),
    "--eager": (False, "11.1"),
    "--paging": (False, "12"), "--page-size": (True, "12"),
    "--page-budget": (True, "12"), "--kv-int8": (False, "12"),
    "--reserve": (True, "12"), "--pressure": (True, "12"),
    "--inject": (True, "13"),
    "--personalise": (False, "15"), "--users": (True, "15"),
    "--refresh-cap": (True, "15"),
    "--fleet": (True, "16"),
}


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-1.5b")
    ap.add_argument("--preset", default="smoke",
                    choices=["smoke", "100m", "full"])
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--chunk", type=int, default=32,
                    help="engine ticks per chunk (one event fetch each)")
    ap.add_argument("--prefill-block", type=int, default=None,
                    help="prompt tokens ingested per prefilling slot per "
                         "tick (default: the arch's serve_prefill_block; "
                         "1 = token-by-token prefill)")
    ap.add_argument("--deadline-ticks", type=int, default=None,
                    help="per-request resident-tick budget; expired "
                         "requests end with outcome='expired'")
    ap.add_argument("--queue-limit", type=int, default=None,
                    help="admission backpressure: shed submissions beyond "
                         "this backlog with outcome='rejected'")
    ap.add_argument("--device", default="cuda",
                    help="torch device (cuda, or cpu for the plain path)")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the weights' generator and the prompts")
    ap.add_argument("--adapt", action="store_true",
                    help="TinyTrain-adapt to a synthetic task, fold, serve")
    ap.add_argument("--adapt-iters", type=int, default=10)
    ap.add_argument("--profile", default="jetson-nano",
                    help="device profile preset used with --adapt "
                         f"({', '.join(sorted(api.PROFILES))})")
    for flag, (takes_value, _) in LATER_FLAGS.items():
        kind = {} if takes_value else {"action": "store_const", "const": True}
        ap.add_argument(flag, default=None, help=argparse.SUPPRESS, **kind)
    args = ap.parse_args(argv)
    for flag, (_, item) in LATER_FLAGS.items():
        if getattr(args, flag[2:].replace("-", "_")) is not None:
            raise SystemExit(f"[serve] {flag} is not in the PyTorch port yet: "
                             f"it arrives with ROADMAP queue 1, item {item}")

    cfg = configs.preset_config(args.arch, args.preset)
    device = torch.device(args.device)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = T.init_params(cfg, gen, device=device)
    eng = ServeEngine(cfg, params, slots=args.slots, max_len=args.max_len,
                      chunk=args.chunk, prefill_block=args.prefill_block,
                      deadline_ticks=args.deadline_ticks,
                      queue_limit=args.queue_limit, device=device)
    rng = np.random.default_rng(args.seed)
    if args.adapt:
        bb = api.backbone(args.arch, preset=args.preset, batch_size=48,
                          seq=64)
        session = api.TinyTrainSession(bb, params, max_way=8)
        task = api.sample_lm_task(rng, cfg.vocab, seq=64, max_way=5)
        profile = api.device_profile(args.profile)
        adaptation = session.adapt(task, profile, iters=args.adapt_iters)
        if adaptation.policy.n_units == 0:
            print(f"[serve] WARNING: {profile.name} budget selected no "
                  "units; serving base weights unchanged")
        else:
            adaptation.fold_into(eng)
            print(f"[serve] adapted under {profile.name}: "
                  f"{adaptation.describe()}")
    reqs = [Request(uid=i,
                    prompt=rng.integers(0, cfg.vocab,
                                        size=int(rng.integers(4, 24))
                                        ).astype(np.int32),
                    max_new=args.max_new)
            for i in range(args.requests)]
    t0 = time.perf_counter()
    eng.run(reqs)
    dt = time.perf_counter() - t0
    rep = eng.last_run_report
    toks = sum(len(r.out) for r in reqs)
    prompt_toks = sum(len(r.prompt) for r in reqs)
    print(f"[serve] {args.requests} requests, {toks} new tokens "
          f"(+{prompt_toks} prompt tokens ingested) in {dt:.1f}s "
          f"({toks / dt:.1f} tok/s, {eng.ticks} engine ticks, "
          f"{args.slots} slots, chunk={args.chunk} "
          f"prefill_block={eng.prefill_block}, {rep['host_syncs']} host "
          f"syncs, device {device})")
    print("[serve] outcomes: " + ", ".join(
        f"{k}={v}" for k, v in sorted(rep["outcomes"].items())))
    lost = [r.uid for r in reqs if r.outcome is None]
    if lost:
        raise SystemExit(f"[serve] ENGINE ERROR: requests {lost} reached no "
                         "terminal outcome")
    mem = rep["memory"]
    print(f"[serve] fixed-stripe KV: {mem['kv_cache_bytes'] / 2**20:.2f} MiB "
          f"across {args.slots} slots "
          f"({mem['kv_bytes_per_stream'] / 2**10:.1f} KiB/stream), peak "
          f"{rep['peak_resident']} resident streams")
    if any(r.truncated for r in reqs):
        print(f"[serve] {sum(r.truncated for r in reqs)} requests truncated "
              f"at max_len={args.max_len}")


if __name__ == "__main__":
    main()
