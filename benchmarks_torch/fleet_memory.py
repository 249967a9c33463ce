#!/usr/bin/env python3
"""Peak device memory of ``adapt_many``'s criterion route against one
task's ``adapt``, on qwen2-1.5b at full width and depth (bf16, random
weights from seed 0, ``chip_smoke.py``'s phase 6 profile): two tasks of
phase 6's episode shape (48 support rows, bucket 64, 64 tokens, 5-way).

Prints, each from a reset peak and above the weights: ``adapt`` of one
task, the batched probe of the two (``probe_fisher_batch``, their rows
through one probe), and ``adapt_many`` of the two with no override (the
probe, then the fleet fine-tune under ``vmap``).  A run that does not fit
prints the peak it reached and the allocation that failed.

    python3 benchmarks_torch/fleet_memory.py [--iters 4]

Needs one NVIDIA card.  Imports nothing of JAX or of the JAX package.
"""
from __future__ import annotations

import argparse
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=4)
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import numpy as np
    import torch

    from repro_torch import api
    from repro_torch.core.session import _bucket_episode, _stack_trees

    if not torch.cuda.is_available():
        print("fleet_memory: needs an NVIDIA card", file=sys.stderr)
        return 2
    bb = api.backbone("qwen2-1.5b", preset="full", batch_size=48, seq=64)
    cfg = bb.cfg
    session = api.TinyTrainSession(bb, max_way=8, seed=0)
    profile = api.DeviceProfile(name="edge-lm", mem_kb=4000,
                                compute_frac=0.5).scaled(mem=500, compute=1.6)
    tasks = [api.sample_lm_task(np.random.default_rng(s), cfg.vocab, seq=64,
                                max_way=5, support_pad=48, query_pad=48)
             for s in (0, 1)]
    eps = [_bucket_episode(t) for t in tasks]
    sup = session._on(_stack_trees([e[0] for e in eps]))
    pq = session._on(_stack_trees([e[1] for e in eps]))
    ns = torch.tensor([float(t.n_support) for t in tasks],
                      device=session.device)
    rows = sup["episode_labels"].shape[1]
    base = torch.cuda.memory_allocated()
    print(f"[memory] {torch.cuda.get_device_name(0)}; qwen2-1.5b bf16, "
          f"{cfg.n_layers} layers, weights {base} B; two tasks of "
          f"{[t.n_support for t in tasks]} valid support rows (bucket "
          f"{rows})", flush=True)

    def peak(what, fn):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        try:
            fn()
            torch.cuda.synchronize()
            out = "fits"
        except torch.cuda.OutOfMemoryError as e:
            out = f"out of memory ({str(e).split('.')[0]})"
        print(f"[memory] {what}: peak {torch.cuda.max_memory_allocated() - base}"
              f" B above the weights, {out}", flush=True)

    peak("adapt of one task", lambda: session.adapt(
        tasks[0], profile, iters=args.iters))
    peak("the batched probe of two", lambda: session.step_cache
         .probe_fisher_batch()(session.params, sup, pq,
                               bb.make_taps(rows, session.device), ns))
    peak("adapt_many of two, no override", lambda: session.adapt_many(
        tasks, profile, iters=args.iters))
    return 0


if __name__ == "__main__":
    sys.exit(main())
