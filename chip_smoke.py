#!/usr/bin/env python3
"""Smoke test of the PyTorch/H100 port (``src/repro_torch``) on one card.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with an NVIDIA Hopper card
and the CUDA toolkit.  Phases, one line each, and any failure exits
non-zero:

1. environment: torch, the card, ``nvidia-smi`` name and power limit;
2. build: every CUDA source of the port with ``nvcc`` for ``sm_90a``;
3. kernel parity: each kernel against its plain PyTorch version at the
   main path's shapes (f32 at 1e-4 with TF32 off, bf16 at 3e-2), then its
   median time beside its bound, the plain version's time and one
   PyTorch library call's time (a yardstick the port never calls);
4. small-input check: the serving engine on qwen2-smoke in f32 on the
   card must give the same greedy streams as the plain path on the CPU;
5. serve: qwen2-1.5b at its published width in bf16 (random weights from
   a seeded generator), 8 requests through ``ServeEngine``; every request
   must end ``done`` with 16 tokens, and the kernel launch count over the
   run must be a positive multiple of the layer count.

The last three lines are the card's ``nvidia-smi`` name and power limit,
the kernels' JSON record and ``{"ok": true, "device": {...}}``.  Imports
nothing of JAX or of the JAX package.
"""
from __future__ import annotations

import json
import math
import os
import re
import statistics
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory
PEAK_OPS = {"float32": 67e12, "bfloat16": 989e12}  # dense, non-TC f32 / TC bf16

# main-path shapes of the cached flash kernel: qwen2-1.5b block prefill with
# 8 slots, prefill_block 8 and max_len 512
MAIN = dict(B=8, Sq=8, Hq=12, Hkv=2, D=128, Sk=512)
# ragged cursors: an empty cache (kv_len 0), a block past its valid rows
# (q_offset + Sq > kv_len), and a block ending at the last cache row
Q_OFFSET = [0, 0, 37, 100, 255, 300, 504, 128]
KV_LEN = [0, 8, 40, 108, 263, 305, 512, 136]
TOL = {"float32": 1e-4, "bfloat16": 3e-2}


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def time_ms(fn, n_inner: int, trials: int = 5) -> float:
    """Median over ``trials`` of CUDA-event time per call of ``fn``."""
    import torch

    fn()
    torch.cuda.synchronize()
    per = []
    for _ in range(trials):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n_inner):
            fn()
        end.record()
        end.synchronize()
        per.append(start.elapsed_time(end) / n_inner)
    return statistics.median(per)


def flash_work(q_offset, kv_len, sq, hq, hkv, d, elt, window):
    """(bytes, operations) the cached attention needs for these cursors:
    q read and out written once, the K/V rows some query can see read
    once, two multiply-adds per (query, visible key, feature)."""
    kv_rows = keys = 0
    for qo, kl in zip(q_offset, kv_len):
        lo = max(0, qo - window + 1) if window else 0
        kv_rows += max(0, min(kl, qo + sq) - lo)
        for i in range(sq):
            qpos = qo + i
            first = max(0, qpos - window + 1) if window else 0
            keys += max(0, min(kl - 1, qpos) - first + 1)
    b = len(q_offset)
    nbytes = (2 * b * sq * hq * d * elt          # q in, out
              + 2 * kv_rows * hkv * d * elt      # k, v rows
              + 2 * b * 4)                       # q_offset, kv_len
    return nbytes, 4 * d * hq * keys


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA card", file=sys.stderr)
        return 2
    src = os.path.join(os.path.dirname(os.path.abspath(__file__)), "src")
    if not os.path.isdir(os.path.join(src, "repro_torch")):
        print(f"chip_smoke: no port package under {src}; run from a checkout "
              "of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, src)
    import numpy as np
    import torch.nn.functional as F

    from repro_torch import configs
    from repro_torch.kernels import build, flash_attention, ops
    from repro_torch.kernels.ref import flash_attention_cached_ref
    from repro_torch.models import transformer as T
    from repro_torch.serving import Request, ServeEngine
    from repro_torch.utils import tree_map

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    name = torch.cuda.get_device_name(0)
    smi = smi_line()
    print(f"[env] torch {torch.__version__} cuda {torch.version.cuda} | "
          f"{name} | nvidia-smi: {smi}", flush=True)

    # -- build ------------------------------------------------------------
    t0 = time.perf_counter()
    built = build.build_all()
    secs = time.perf_counter() - t0
    logs = " ".join(build.BUILD_LOG[n][1] for n in built)
    regs = [int(x) for x in re.findall(r"Used (\d+) registers", logs)]
    spills = sum(int(x) for x in re.findall(r"(\d+) bytes spill stores", logs))
    print(f"[build] {', '.join(build.SOURCES)} for sm_90a in {secs:.1f} s "
          f"(compiled {built or 'none: cached'}; max {max(regs, default=0)} "
          f"registers/thread, {spills} bytes of spill stores)", flush=True)

    # -- kernel parity and timing -------------------------------------------
    B, Sq, Hq, Hkv, D, Sk = (MAIN[k] for k in ("B", "Sq", "Hq", "Hkv", "D", "Sk"))
    gen = torch.Generator(device=dev).manual_seed(0)
    qo = torch.tensor(Q_OFFSET, dtype=torch.int32, device=dev)
    kl = torch.tensor(KV_LEN, dtype=torch.int32, device=dev)
    worst = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[-1]
        q = torch.randn((B, Sq, Hq, D), generator=gen, device=dev).to(dtype)
        k = torch.randn((B, Sk, Hkv, D), generator=gen, device=dev).to(dtype)
        v = torch.randn((B, Sk, Hkv, D), generator=gen, device=dev).to(dtype)
        for window in (0, 64):
            got = ops.flash_attention_cached(q, k, v, q_offset=qo, kv_len=kl,
                                             causal=True, window=window)
            want = flash_attention_cached_ref(q, k, v, q_offset=qo, kv_len=kl,
                                              causal=True, window=window)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            zero_row = got[0].float().abs().max().item()
            print(f"[parity] flash_cached {dname} window={window}: max abs "
                  f"err {err:.3g} (tol {TOL[dname]:g}); kv_len=0 row max "
                  f"{zero_row:g}", flush=True)
            if not math.isfinite(err) or err > TOL[dname]:
                fail(f"flash_cached {dname} window={window} error {err}")
            if zero_row != 0.0:
                fail("a kv_len = 0 row must give 0")
            worst = max(worst, err)

    # time at the main path's shapes in bf16, cycling through one K/V
    # buffer per layer (28 x 4 MiB > the 50 MB L2) as a prefill tick does
    cfg = configs.get_config("qwen2-1.5b")
    nl = cfg.n_layers
    q = torch.randn((B, Sq, Hq, D), generator=gen, device=dev).to(torch.bfloat16)
    ks = torch.randn((nl, B, Sk, Hkv, D), generator=gen, device=dev).to(torch.bfloat16)
    vs = torch.randn((nl, B, Sk, Hkv, D), generator=gen, device=dev).to(torch.bfloat16)
    it = {"i": 0}

    def layer():
        i = it["i"] = (it["i"] + 1) % nl
        return ks[i], vs[i]

    # the kernel is timed through its C entry so that the wrapper's Python
    # checks (host time, overlapped with the previous launch) stay out
    entry, out = flash_attention._entry(), torch.empty_like(q)
    stream = torch.cuda.current_stream().cuda_stream

    def run_kernel():
        k, v = layer()
        err = entry(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                    qo.data_ptr(), kl.data_ptr(), B, Sq, Sk, Hq, Hkv, D, 1, 0,
                    1, stream)
        if err:
            fail(f"flash_cached_fwd returned cudaError {err}")

    def run_plain():
        k, v = layer()
        flash_attention_cached_ref(q, k, v, q_offset=qo, kv_len=kl)

    pos = torch.arange(Sk, device=dev)
    qpos = qo[:, None].long() + torch.arange(Sq, device=dev)[None, :]
    mask = ((pos[None, None, :] < kl[:, None, None])
            & (pos[None, None, :] <= qpos[..., None]))[:, None]
    qt = q.transpose(1, 2)
    kts, vts = ks.transpose(2, 3), vs.transpose(2, 3)

    def run_library():
        i = it["i"] = (it["i"] + 1) % nl
        F.scaled_dot_product_attention(qt, kts[i], vts[i], attn_mask=mask,
                                       enable_gqa=True)

    ms = time_ms(run_kernel, 4 * nl)
    plain_ms = time_ms(run_plain, nl)
    library_ms = time_ms(run_library, 4 * nl)
    nbytes, nops = flash_work(Q_OFFSET, KV_LEN, Sq, Hq, Hkv, D, 2, 0)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, nops / PEAK_OPS["bfloat16"]
    bound_ms = 1e3 * max(t_bytes, t_ops)
    bound_by = "bytes" if t_bytes >= t_ops else "operations"
    print(f"[time] flash_cached bf16 B={B} Sq={Sq} Hq={Hq} Hkv={Hkv} D={D} "
          f"Sk={Sk}: kernel {ms:.4f} ms, bound {bound_ms:.5f} ms ({bound_by}: "
          f"{nbytes} B, {nops} ops), plain {plain_ms:.4f} ms, "
          f"sdpa {library_ms:.4f} ms", flush=True)

    # -- small-input check: kernel path on the card vs plain path on the CPU
    small = configs.get_reduced("qwen2-1.5b")
    sp_cpu = T.init_params(small, torch.Generator().manual_seed(0),
                           device="cpu")
    sp_gpu = tree_map(lambda t: t.to(dev), sp_cpu)  # the same weights
    streams = {}
    rng = np.random.default_rng(1)
    lens = [3, 5, 8, 9, 17, 20]
    prompts = [rng.integers(0, small.vocab, n).astype(np.int32) for n in lens]
    for where, params in (("cpu", sp_cpu), ("cuda", sp_gpu)):
        eng = ServeEngine(small, params, slots=3, max_len=48, chunk=4,
                          device=where)
        reqs = [Request(uid=i, prompt=p, max_new=6)
                for i, p in enumerate(prompts)]
        eng.run(reqs)
        streams[where] = [(r.out, r.outcome) for r in reqs]
    same = streams["cpu"] == streams["cuda"]
    print(f"[check] qwen2-smoke f32 greedy streams, card vs CPU plain path: "
          f"{'identical' if same else 'DIFFERENT'} over {len(lens)} requests",
          flush=True)
    if not same:
        fail(f"streams differ: cpu {streams['cpu']} cuda {streams['cuda']}")

    # -- serve: qwen2-1.5b at full width -----------------------------------
    params = T.init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    eng = ServeEngine(cfg, params, slots=8, max_len=512, chunk=32)
    eng.run([Request(uid=-1, prompt=np.arange(8, dtype=np.int32), max_new=2)])
    rng = np.random.default_rng(0)
    reqs = [Request(uid=i,
                    prompt=rng.integers(0, cfg.vocab, int(n)).astype(np.int32),
                    max_new=16)
            for i, n in enumerate(rng.integers(32, 257, 8))]
    torch.cuda.synchronize()
    ops.flash_attention_cached.launches = 0
    t0 = time.perf_counter()
    eng.run(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ops.flash_attention_cached.launches
    rep = eng.last_run_report
    new_tokens = sum(len(r.out) for r in reqs)
    print(f"[serve] qwen2-1.5b bf16 full width, 8 slots, max_len 512, chunk "
          f"32, prefill_block {eng.prefill_block}: {len(reqs)} requests "
          f"(prompts {sum(len(r.prompt) for r in reqs)} tokens), "
          f"{new_tokens} new tokens in {wall:.3f} s = "
          f"{new_tokens / wall:.2f} tok/s, {rep['ticks']} ticks, "
          f"{rep['host_syncs']} host syncs, kv_cache_bytes "
          f"{eng.memory_report()['kv_cache_bytes']}, flash_cached launches "
          f"{launches}", flush=True)
    bad = [(r.uid, r.outcome, len(r.out)) for r in reqs
           if r.outcome != "done" or len(r.out) != 16
           or not all(0 <= t < cfg.vocab for t in r.out)]
    if bad:
        fail(f"requests not done with 16 in-vocabulary tokens: {bad}")
    if launches <= 0 or launches % nl:
        fail(f"flash_cached launches {launches} is not a positive multiple "
             f"of n_layers = {nl}")

    print(smi)
    print(json.dumps({"kernels": [{
        "name": "flash_attention_cached",
        "route": "cuda",
        "source": "src/repro_torch/csrc/flash_cached.cu",
        "replaces": "src/repro/kernels/flash_attention.py:92",
        "launches": launches,
        "max_abs_err": worst,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": library_ms,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
