"""Serving driver: batched requests through the continuous-batching engine.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-1.5b \
        --preset full --requests 8 --slots 8 --max-new 16 --max-len 512

With ``--paging`` the engine serves from a paged KV cache (page pool,
reserve-as-you-go growth, preemption and requeue); ``--pressure FRAC``
grants that fraction of the fixed-stripe page capacity, and ``--kv-int8``
stores the pages in int8 with per-token scales:

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-1.5b \
        --preset full --requests 8 --slots 8 --max-len 512 --paging \
        --pressure 0.5

With ``--adapt``, first runs TinyTrain through the façade on a synthetic
task (Fisher probe, Eq. 3 selection, sparse fine-tune) under the device
profile ``--profile`` and folds the deltas into the engine before serving,
as ``examples/serve_batched.py`` does.  The ssm and hybrid families
(mamba2, zamba2) run it through the SSD scan kernels, and take every
other flag too (their SSD state is never paged; zamba2's shared-block
caches are):

    PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-1.2b \
        --preset full --adapt --paging

The moe family (``--arch mixtral-8x7b | deepseek-v3-671b``) runs every
mode at the ``smoke`` and ``100m`` presets (its ``full`` presets do not
fit one card; ``chip_smoke.py`` phase 18 runs them at their published
widths with the depth cut); a ``--max-len`` above mixtral's window rolls
its cache:

    PYTHONPATH=src python -m repro_torch.launch.serve --arch mixtral-8x7b \
        --preset 100m --adapt --paging

The encoder-decoder and VLM families (``--arch whisper-base |
paligemma-3b``) take every flag but ``--personalise``: each request carries
random ``enc_feats`` (whisper's frames, paligemma's patch embeddings, drawn
per request as ``repro.launch.serve`` draws them), encoded once and pinned
as the slot's encoder run; ``--adapt`` samples a conditioned task
(``api.sample_encdec_task``).  paligemma's 256-token image prefix counts
in ``--max-len``:

    PYTHONPATH=src python -m repro_torch.launch.serve --arch paligemma-3b \
        --preset full --max-len 320 --adapt --paging

With ``--personalise``, one probe adaptation fixes the policy, the engine
keeps a per-slot delta arena, requests spread over ``--users`` users, and
between chunks every user with enough finished streams is adapted on them
(``adapt_many``), sent through the int8 error-feedback compressor and
hot-swapped into their resident slots (at most ``--refresh-cap`` users per
window):

    PYTHONPATH=src python -m repro_torch.launch.serve --preset smoke \
        --device cpu --personalise --users 4

``--temperature T --top-k K`` samples (the JAX engine's own draws, keyed
on request and token index), ``--eager`` runs the host-driven per-tick
loop instead of chunks, and ``--inject SPEC`` injects faults
(``serving.faults.parse_inject``):

    PYTHONPATH=src python -m repro_torch.launch.serve --preset smoke \
        --device cpu --temperature 0.8 --top-k 20 --inject nan:2:1

``--fleet R`` serves through R engine replicas behind one
``FleetRouter`` (least-loaded routing, sticky user placement, typed
shedding only when every replica is saturated), pinned round-robin over
the visible cards, or all on ``--device`` when it names one; ``--adapt``
folds into every replica, and ``--personalise`` ships each refresh to the
router as serialized int8 payload bytes:

    PYTHONPATH=src python -m repro_torch.launch.serve --preset smoke \
        --device cpu --fleet 2 --personalise --users 4

Runs on the card unless ``--device cpu``.  Weights are random, from a
seeded ``torch.Generator``.  (In ``repro.launch.serve`` ``--device`` names
the profile; here it is the torch device, and ``--profile`` names the
profile.)
"""
from __future__ import annotations

import argparse
import time
from typing import List, Optional

import numpy as np
import torch

from .. import api, configs
from ..models import transformer as T
from ..serving import FleetRouter, Request, ServeEngine
from ..serving.faults import parse_inject
from ..serving.fleet import params_on


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
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="sampling temperature (0 = greedy)")
    ap.add_argument("--top-k", type=int, default=0,
                    help="top-k filter for sampled decoding (0 = off)")
    ap.add_argument("--eager", action="store_true",
                    help="host-driven per-tick loop instead of chunks")
    ap.add_argument("--paging", action="store_true",
                    help="paged KV cache: pages from one pool instead of "
                         "fixed per-slot stripes")
    ap.add_argument("--page-size", type=int, default=None,
                    help="tokens per KV page (default: arch kv_page_size)")
    ap.add_argument("--page-budget", type=int, default=None,
                    help="total pages per layer arena (default: the "
                         "fixed-stripe capacity slots*ceil(max_len/page))")
    ap.add_argument("--kv-int8", action="store_true",
                    help="store KV pages in int8 with per-token scales")
    ap.add_argument("--reserve", default=None,
                    choices=["asyougo", "worstcase"],
                    help="page reservation discipline (default: the arch's "
                         "kv_reserve; asyougo grows page by page)")
    ap.add_argument("--pressure", type=float, default=None, metavar="FRAC",
                    help="oversubscribe the page pool to FRAC of the "
                         "fixed-stripe capacity (e.g. 0.5); implies --paging")
    ap.add_argument("--deadline-ticks", type=int, default=None,
                    help="per-request resident-tick budget; expired "
                         "requests end with outcome='expired'")
    ap.add_argument("--queue-limit", type=int, default=None,
                    help="admission backpressure: shed submissions beyond "
                         "this backlog with outcome='rejected'")
    ap.add_argument("--inject", default=None, metavar="SPEC",
                    help="fault injection, e.g. "
                         "'nan:3:2,pre:1:4,exhaust:10:20,qlimit:8' "
                         "(see repro_torch.serving.faults.parse_inject)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (cuda, or cpu for the plain path)")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the weights' generator and the prompts")
    ap.add_argument("--adapt", action="store_true",
                    help="TinyTrain-adapt to a synthetic task, fold, serve")
    ap.add_argument("--adapt-iters", type=int, default=10)
    ap.add_argument("--profile", default="jetson-nano",
                    help="device profile preset used with --adapt and "
                         f"--personalise ({', '.join(sorted(api.PROFILES))})")
    ap.add_argument("--personalise", action="store_true",
                    help="per-slot delta arena + online refresh: requests "
                         "are spread over --users users, finished streams "
                         "feed an adapt_many pass between chunks and the "
                         "refreshed delta sets hot-swap in without draining "
                         "(int8 error-feedback exchange)")
    ap.add_argument("--users", type=int, default=4,
                    help="distinct users sharing the engine with "
                         "--personalise (uid = request index mod users)")
    ap.add_argument("--refresh-cap", type=int, default=None,
                    help="with --personalise: most users refreshed per "
                         "between-chunks window, ranked by stale-delta age "
                         "x banked streams (default: every eligible user)")
    ap.add_argument("--fleet", type=int, default=None, metavar="R",
                    help="serve through R engine replicas behind one "
                         "FleetRouter (least-loaded routing, sticky user "
                         "placement, typed shedding only when every replica "
                         "is saturated), pinned round-robin over the "
                         "visible cards, or all on --device when it names "
                         "one")
    args = ap.parse_args(argv)
    if args.fleet is not None and args.fleet < 1:
        raise SystemExit("[serve] --fleet must be >= 1")
    if args.fleet and args.eager:
        raise SystemExit("[serve] --fleet requires the fused engine "
                         "(drop --eager)")

    cfg = configs.preset_config(args.arch, args.preset)
    enc = cfg.enc_feats_shape  # None on a decoder-only config
    if args.personalise and enc is not None:
        raise SystemExit(
            f"[serve] --personalise on {cfg.name}: the Personaliser builds "
            "token-only episodes, as the JAX package's does; serve per-slot "
            "deltas through ServeEngine(personalise=...).swap_deltas")
    faults = parse_inject(args.inject) if args.inject else None
    device = torch.device(args.device)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = T.init_params(cfg, gen, device=device)
    page_budget, paging = args.page_budget, args.paging
    if args.pressure is not None:
        paging = True
        ps = args.page_size or cfg.kv_page_size
        stripe = args.slots * (-(-args.max_len // ps))
        page_budget = max(1, int(stripe * args.pressure))
        print(f"[serve] pressure {args.pressure}x: {page_budget} pages "
              f"(fixed-stripe capacity {stripe})")
    rng = np.random.default_rng(args.seed)
    session = policy = None
    if args.personalise:
        # one probe adaptation fixes the shared delta structure: every
        # user's refresh runs under policy_override=policy, so arena rows
        # keep the template's shapes across hot swaps
        bb = api.backbone(args.arch, preset=args.preset, batch_size=48,
                          seq=64)
        session = api.TinyTrainSession(bb, params, max_way=8)
        profile = api.device_profile(args.profile)
        probe = session.adapt(api.sample_lm_task(rng, cfg.vocab, seq=64,
                                                 max_way=5),
                              profile, iters=1)
        if probe.policy.n_units == 0:
            print(f"[serve] WARNING: {profile.name} budget selected no "
                  "units; --personalise disabled, serving base weights")
        else:
            policy = probe.policy
            print(f"[serve] personalising {args.users} users under "
                  f"{profile.name}: {policy.describe()}")
    engine_kw = dict(slots=args.slots, max_len=args.max_len,
                     fused=not args.eager, chunk=args.chunk,
                     prefill_block=args.prefill_block,
                     temperature=args.temperature, top_k=args.top_k,
                     kv_paging=paging or None, kv_page_size=args.page_size,
                     kv_int8=args.kv_int8 or None, page_budget=page_budget,
                     reserve=args.reserve,
                     deadline_ticks=args.deadline_ticks,
                     queue_limit=args.queue_limit, faults=faults,
                     personalise=policy)
    if args.fleet:
        eng = FleetRouter(cfg, params, replicas=args.fleet,
                          devices=None if args.device == "cuda" else [device],
                          **engine_kw)
        print(f"[serve] fleet: {args.fleet} replicas over "
              f"{len(set(eng.devices))} device(s)")
    else:
        eng = ServeEngine(cfg, params, device=device, **engine_kw)
    engines = eng.engines if args.fleet else [eng]
    if args.adapt:
        bb = api.backbone(args.arch, preset=args.preset, batch_size=48,
                          seq=64)
        session = api.TinyTrainSession(bb, params, max_way=8)
        task = (api.sample_lm_task(rng, cfg.vocab, seq=64, max_way=5)
                if enc is None else
                api.sample_encdec_task(rng, cfg, seq=64, max_way=5))
        profile = api.device_profile(args.profile)
        adaptation = session.adapt(task, profile, iters=args.adapt_iters)
        if adaptation.policy.n_units == 0:
            print(f"[serve] WARNING: {profile.name} budget selected no "
                  "units; serving base weights unchanged")
        else:
            # one folded copy a device, shared by the replicas there
            folded = adaptation.fold_into(params)
            for e in engines:
                e.params = params_on(folded, e.device)
            print(f"[serve] adapted under {profile.name}: "
                  f"{adaptation.describe()}")
    def enc_feats() -> Optional[np.ndarray]:
        # the encoder-decoder and vlm families' precomputed frontend
        # embeddings (whisper frames, SigLIP patches), one draw a request
        return (None if enc is None
                else rng.standard_normal(enc).astype(np.float32))

    reqs = [Request(uid=i % args.users if policy is not None else i,
                    prompt=rng.integers(0, cfg.vocab,
                                        size=int(rng.integers(4, 24))
                                        ).astype(np.int32),
                    max_new=args.max_new, enc_feats=enc_feats())
            for i in range(args.requests)]
    t0 = time.perf_counter()
    if policy is not None:
        pers = api.Personaliser(session, eng, policy, profile=args.profile,
                                iters=args.adapt_iters,
                                refresh_cap=args.refresh_cap)
        online = pers.run_online(reqs)
        dt = time.perf_counter() - t0
        for ref in online["refreshes"]:
            deferred = (f", {len(ref['deferred_users'])} deferred"
                        if ref["deferred_users"] else "")
            wire = " (serialized)" if ref["wire_serialized"] else ""
            print(f"[serve] refresh {ref['round']}: users {ref['users']}"
                  f"{deferred}, {ref['resident_rows_swapped']} resident rows "
                  f"swapped, wire{wire} {ref['payload_bytes_wire']} B vs f32 "
                  f"{ref['payload_bytes_f32']} B "
                  f"({ref['payload_ratio']:.1f}x), adapt "
                  f"{ref['adapt_seconds']:.2f}s, swap "
                  f"{1000 * ref['swap_seconds']:.1f}ms")
    else:
        eng.run(reqs)
        dt = time.perf_counter() - t0
    rep = eng.last_run_report
    toks = sum(len(r.out) for r in reqs)
    prompt_toks = sum(len(r.prompt) for r in reqs)
    mode = ("eager" if args.eager else
            f"chunk={args.chunk} prefill_block={eng.prefill_block}")
    print(f"[serve] {args.requests} requests, {toks} new tokens "
          f"(+{prompt_toks} prompt tokens ingested) in {dt:.1f}s "
          f"({toks / dt:.1f} tok/s, {eng.ticks} engine ticks, "
          f"{args.slots} slots, {mode}, {rep['host_syncs']} host "
          f"syncs, device {device})")
    print("[serve] decoding: " + (
        f"sampled T={args.temperature} top-k {args.top_k}"
        if args.temperature > 0 else "greedy")
        + (f"; faults {args.inject}" if faults is not None else ""))
    print("[serve] outcomes: " + ", ".join(
        f"{k}={v}" for k, v in sorted(rep["outcomes"].items())))
    preempts = sum(r.preempts for r in reqs)
    if preempts:
        print(f"[serve] {preempts} preempt-and-requeue recompute swaps")
    lost = [r.uid for r in reqs if r.outcome is None]
    if lost:
        raise SystemExit(f"[serve] ENGINE ERROR: requests {lost} reached no "
                         "terminal outcome")
    mem, peak = rep["memory"], rep["peak_resident"]
    if args.fleet:
        print(f"[serve] fleet: {mem['alive']}/{mem['replicas']} replicas, "
              f"aggregate KV {mem['kv_cache_bytes'] / 2**20:.2f} MiB; "
              + ", ".join(f"r{r['replica']}: {r.get('ticks', 0)} ticks/"
                          f"{r.get('host_syncs', 0)} syncs"
                          for r in rep["replicas"]))
        mem = mem["per_replica"][0]  # one replica's layout below
    if mem["kv_paging"]:
        print(f"[serve] paged KV: {mem['kv_cache_bytes'] / 2**20:.2f} MiB "
              f"({'int8' if mem['kv_int8'] else cfg.dtype} pages, "
              f"{mem['page_size']} tok/page, {mem['n_pages']} pages/layer, "
              f"{mem['page_bytes']} B/page), peak {peak} resident streams, "
              f"worst-case {mem['kv_bytes_per_stream'] / 2**10:.1f} "
              "KiB/stream")
    elif cfg.family == "ssm":
        print(f"[serve] recurrent state (conv windows and SSD states): "
              f"{mem['kv_cache_bytes'] / 2**20:.2f} MiB across {args.slots} "
              f"slots ({mem['kv_bytes_per_stream'] / 2**10:.1f} KiB/stream), "
              f"peak {peak} resident streams")
    else:
        print(f"[serve] fixed-stripe KV: {mem['kv_cache_bytes'] / 2**20:.2f} "
              f"MiB across {args.slots} slots "
              f"({mem['kv_bytes_per_stream'] / 2**10:.1f} KiB/stream), peak "
              f"{peak} resident streams")
    if "enc_run_bytes" in mem:
        if mem["kv_paging"]:
            pages = mem["enc_pages_per_stream"]
            where = f"{pages} pages of the pool a run"
            run = pages * (mem["enc_arena_bytes"] // mem["n_pages"])
        else:
            where = "a fixed stripe a slot"
            run = mem["enc_arena_bytes"] // args.slots
        print(f"[serve] encoder runs: {mem['enc_tokens']} rows a request "
              f"({where}, {run} B a run, "
              f"{mem['enc_arena_bytes'] / 2**20:.2f} MiB arena)")
    ssm_b = engines[0].ssm_state_bytes_per_slot
    if ssm_b and (mem["kv_paging"] or cfg.family != "ssm"):
        print(f"[serve] SSD state (conv windows and states, never paged): "
              f"{ssm_b / 2**10:.1f} KiB a slot")
    if any(r.truncated for r in reqs):
        print(f"[serve] {sum(r.truncated for r in reqs)} requests truncated "
              f"at max_len={args.max_len}")


if __name__ == "__main__":
    main()
