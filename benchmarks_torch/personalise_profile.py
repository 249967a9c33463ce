#!/usr/bin/env python3
"""Where the personalised serve's time goes on the card: phase 10 of
``chip_smoke.py`` (qwen2-1.5b at full width, bf16, weights from seed 0; the
policy of one probe adaptation under the scaled ``edge-lm`` profile, 2 MLP
and 28 attention units; 8 slots, max_len 128, chunk 16; 16 requests of
4-23 prompt tokens and 16 new tokens for 4 users), broken down four ways:

- the one-time cost the first fleet fine-tune pays (``torch.func``'s
  transforms import ``torch._dynamo`` on first use), then a cold and a
  warm ``adapt_many`` of the same four tasks;
- the serve alone: the same requests on an engine without personalisation
  and on the personalised one (every slot on the per-slot overlay), wall
  time and wall per tick kind;
- one ``Personaliser.run_online`` with each stage timed to a synchronise:
  serving chunks, ``adapt_many``, ``int8_compress``, ``int8_decompress``
  and ``swap_deltas``;
- ``torch.profiler`` over one personalised serve and one four-user refresh:
  device busy share, kernel launches, device time by kernel.

    python3 benchmarks_torch/personalise_profile.py

Needs one NVIDIA card.
"""
from __future__ import annotations

import collections
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
P = dict(slots=8, max_len=128, chunk=16, requests=16, users=4, max_new=16,
         iters=8, seq=32)


def busy_and_launches(prof):
    """(device busy seconds as the union of device events, launches)."""
    from torch.autograd import DeviceType

    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events() if e.device_type == DeviceType.CUDA)
    busy_us, hi = 0.0, float("-inf")
    for lo, end in spans:
        busy_us += max(0.0, end - max(lo, hi))
        hi = max(hi, end)
    # cudaLaunchKernel, and cudaLaunchKernelExC for cluster launches
    launches = sum(1 for e in prof.events()
                   if e.name.startswith("cudaLaunchKernel"))
    return busy_us / 1e6, launches


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("personalise_profile: needs an NVIDIA card", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import api, configs
    from repro_torch.kernels import build
    from repro_torch.optim import compress
    from repro_torch.serving import Personaliser, Request, ServeEngine
    from repro_torch.serving import engine as E

    build.build_all()  # nvcc at first use is set-up, not the path's time
    cfg = configs.get_config("qwen2-1.5b")
    bb = api.backbone("qwen2-1.5b", preset="full", batch_size=48, seq=64)
    session = api.TinyTrainSession(bb, max_way=8, seed=0)
    profile_ = api.DeviceProfile(name="edge-lm", mem_kb=4000,
                                 compute_frac=0.5).scaled(mem=500,
                                                          compute=1.6)
    task = api.sample_lm_task(np.random.default_rng(0), cfg.vocab, seq=64,
                              max_way=5, support_pad=48, query_pad=48)
    policy = session.adapt(task, profile_, iters=1).policy
    print(f"[policy] {len(policy.units)} units: "
          f"{sum(u.kind == 'mlp' for u in policy.units)} mlp, "
          f"{sum(u.kind == 'attn' for u in policy.units)} attn", flush=True)

    def requests():
        rng = np.random.default_rng(0)
        return [Request(uid=i % P["users"], prompt=rng.integers(
            0, cfg.vocab, size=int(rng.integers(4, 24))).astype(np.int32),
            max_new=P["max_new"]) for i in range(P["requests"])]

    # -- the fleet fine-tune: one-time cost, cold and warm -------------------
    def fleet_tasks(seed):
        pers = Personaliser(session, ServeEngine(
            cfg, session.params, slots=1, max_len=16, personalise=policy),
            policy, seq=P["seq"], seed=seed)
        rng = np.random.default_rng(seed)
        for u in range(P["users"]):
            pers._streams[u] = [rng.integers(0, cfg.vocab, 30).astype(
                np.int32) for _ in range(2)]
        from repro_torch.core.session import Task

        return [Task.from_episode(pers._episode(u), rng, 8)
                for u in range(P["users"])]

    t0 = time.perf_counter()
    import torch._dynamo  # noqa: F401  (what torch.func pulls in first)
    import_s = time.perf_counter() - t0
    fleet = []
    for k in range(3):
        ts = fleet_tasks(k)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        session.adapt_many(ts, profile_, iters=P["iters"],
                           policy_override=policy)
        torch.cuda.synchronize()
        fleet.append((time.perf_counter() - t0,
                      torch.cuda.max_memory_allocated()))
    print(f"[fleet] import torch._dynamo {import_s:.4f} s; adapt_many of "
          f"{P['users']} tasks x {P['iters']} steps: "
          + ", ".join(f"{s:.4f} s (peak {m} B)" for s, m in fleet),
          flush=True)

    # -- the serve alone: plain engine against the per-slot overlay ---------
    tick_s = collections.defaultdict(list)
    advance = E.ServeEngine._advance

    def timed_advance(self, plan, *args, **kw):
        t0 = time.perf_counter()
        out = advance(self, plan, *args, **kw)
        torch.cuda.synchronize()
        kind = ("pers " if self.personalise is not None else "plain ")
        # the tick's kind, read only after the synchronise above
        kind += ("dead" if not bool(plan.live)
                 else "block" if bool(plan.block) else "decode")
        tick_s[kind].append(time.perf_counter() - t0)
        return out

    engines = {}
    for what, kw in (("plain", {}), ("personalised",
                                    dict(personalise=policy))):
        eng = ServeEngine(cfg, session.params, slots=P["slots"],
                          max_len=P["max_len"], chunk=P["chunk"], **kw)
        eng.run([Request(uid=-1, prompt=np.arange(8, dtype=np.int32),
                         max_new=2)])
        engines[what] = eng
        walls = []
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            reqs = eng.run(requests())
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        rep = eng.last_run_report
        toks = sum(len(r.out) for r in reqs)
        print(f"[serve] {what}: {toks} new tokens, walls "
              + ", ".join(f"{w:.4f} s" for w in walls)
              + f" ({toks / min(walls):.2f} tok/s best), {rep['ticks']} "
              f"ticks, {rep['host_syncs']} host syncs", flush=True)
    E.ServeEngine._advance = timed_advance
    for eng in engines.values():
        eng.run(requests())
    E.ServeEngine._advance = advance
    for kind, ts in sorted(tick_s.items()):
        print(f"[ticks] {kind}: {len(ts)} ticks, median "
              f"{1e3 * float(np.median(ts)):.3f} ms, total {sum(ts):.4f} s "
              "(forward + advance, synchronised)", flush=True)

    # -- one online run, every stage timed to a synchronise ----------------
    stage = collections.defaultdict(float)

    def timed(name, fn):
        def wrapper(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            stage[name] += time.perf_counter() - t0
            return out
        return wrapper

    eng = engines["personalised"]
    pers = Personaliser(session, eng, policy, profile=profile_,
                        iters=P["iters"], seq=P["seq"])
    patches = [(session, "adapt_many"), (eng, "run"), (eng, "swap_deltas"),
               (compress, "int8_compress"), (compress, "int8_decompress")]
    saved = [(obj, name, getattr(obj, name)) for obj, name in patches]
    for obj, name, fn in saved:
        setattr(obj, name, timed(name, fn))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    online = pers.run_online(requests())
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    for obj, name, fn in saved:
        setattr(obj, name, fn)
    parts = ", ".join(f"{k} {v:.4f} s" for k, v in sorted(stage.items()))
    print(f"[online] wall {wall:.4f} s over {online['rounds']} rounds, "
          f"{len(online['refreshes'])} refreshes: {parts}; other "
          f"{wall - sum(stage.values()):.4f} s", flush=True)

    # -- profiles -----------------------------------------------------------
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.run(requests())
        torch.cuda.synchronize()
        pwall = time.perf_counter() - t0
    busy, launches = busy_and_launches(prof)
    ticks = eng.last_run_report["ticks"]
    print(f"[profile serve] personalised serve: profiled wall {pwall:.4f} s, "
          f"device busy {busy:.4f} s = {100 * busy / pwall:.1f}%, "
          f"{launches} launches = {launches / ticks:.0f} per tick over "
          f"{ticks} ticks", flush=True)
    print(prof.key_averages().table(sort_by="self_device_time_total",
                                    row_limit=12, max_name_column_width=60))
    ts = fleet_tasks(9)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        session.adapt_many(ts, profile_, iters=P["iters"],
                           policy_override=policy)
        torch.cuda.synchronize()
        pwall = time.perf_counter() - t0
    busy, launches = busy_and_launches(prof)
    print(f"[profile refresh] adapt_many of {P['users']} tasks: profiled "
          f"wall {pwall:.4f} s, device busy {busy:.4f} s = "
          f"{100 * busy / pwall:.1f}%, {launches} launches", flush=True)
    print(prof.key_averages().table(sort_by="self_device_time_total",
                                    row_limit=12, max_name_column_width=60))
    return 0


if __name__ == "__main__":
    sys.exit(main())
