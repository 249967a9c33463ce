#!/usr/bin/env python3
"""Smoke test of the PyTorch/H100 port (``src/repro_torch``) on one card.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with an NVIDIA Hopper card
and the CUDA toolkit.  Phases, one line each or more, and any failure
exits non-zero:

1. environment: torch, the card, ``nvidia-smi`` name and power limit;
2. build: every CUDA source of the port with ``nvcc`` for ``sm_90a``, one
   process per source, all started together;
3. kernel parity: each kernel against its plain PyTorch version at the
   main paths' shapes (cached flash: f32 at 1e-4 with TF32 off, bf16 at
   3e-2; paged flash: the same tolerances at page sizes 1, 5 and 16, NaN
   in every page row no query can see, and exactly the cached kernel's
   output on the same rows laid out contiguously; Fisher: f32 at 1e-5,
   bf16 inputs at 2e-2, masked rows holding NaN; grad_quant: codes, scale
   and residual exactly equal, f32 and bf16 g, a ragged multi-block size,
   ties, zeros and a NaN, and the tree compressor with no host read), then
   its median time beside its bound, the plain version's time and one
   PyTorch library call's time where one computes the same function (a
   yardstick the port never calls);
4. small-input checks on qwen2-smoke in f32, card against the plain path
   on the CPU: the serving engine's greedy streams (contiguous, paged, and
   paged under half the page budget with at least one requeue), and
   TinyTrain's adaptation (the same policy, losses within 1e-4, the same
   streams from the engine with the deltas folded in), and two users'
   deltas served per slot through the personalisation arena (the same
   streams as on the CPU and as each user's folded engine on the card);
5. serve: qwen2-1.5b at its published width in bf16 (random weights from
   a seeded generator), 8 requests through ``ServeEngine``; every request
   must end ``done`` with 16 tokens, and the cached flash kernel's launch
   count over the run must be a positive multiple of the layer count;
7. paged serve, on phase 5's weights and requests: ``kv_paging=True``,
   page size 16, the default budget (256 pages); every request ``done``
   with 16 tokens, streams identical to phase 5's, the paged flash kernel
   launched a positive multiple of 28 times and the cached one never,
   and at least the fixed-stripe bytes in pages;
8. pressure: the same model at half the page budget (128 pages) and
   eight longer requests whose pages outgrow it; every request ``done``,
   at least one preemption with requeue, the paged kernel launched; the
   streams that equal an unpressured run of the same requests are
   counted, not gated (a recompute in bf16 may round otherwise);
9. int8 pages, phase 5's requests: every request ``done`` with 16 tokens
   and 59,637,760 bytes of pages and scales; block prefill gathers the
   int8 pages and runs the cached kernel;
6. adapt: the twin of ``examples/serve_batched.py`` at qwen2-1.5b's full
   width in bf16: ``TinyTrainSession.adapt`` (Fisher probe through the
   Fisher kernel, Eq. 3 selection, 10 fused fine-tune steps) under the
   example's own ``edge-lm`` profile scaled to this width (2 GB of
   backward memory, compute fraction 0.8, half of each unit's channels:
   whatever the order of the Fisher scores, it selects both attention
   and MLP units here), then
   ``fold_into`` a ``ServeEngine`` and 10 requests; finite losses that
   fall, two host transfers, two Fisher launches (one per tap group), the
   flash kernel launched, every request ``done``;
10. personalise, on phase 6's session, weights and policy: a
   ``ServeEngine(slots=8, max_len=128, chunk=16, personalise=policy)``
   serves 16 requests of 4-23 prompt tokens and 16 new tokens for 4 users
   (``uid = i % 4``) through ``Personaliser(iters=8, seq=32).run_online``:
   between chunks the users with two finished streams adapt together
   (``adapt_many``), their deltas go through the int8 error-feedback
   exchange (the grad_quant kernel) and hot-swap into their slots; every
   request ``done``, at least one refresh, grad_quant launched once per
   leaf of every refreshed delta set, a payload ratio above 3.9, the
   cached flash kernel launched a positive multiple of 28 times.

Phases 7 to 9 run right after phase 5, on its weights.  The kernel launch
counts are set to 0 just before each main path (phases 5 to 10) and read
just after.  The last three lines are the card's
``nvidia-smi`` name and power limit, the kernels' JSON record and
``{"ok": true, "device": {...}}``.  Imports nothing of JAX or of the JAX
package.
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
FISHER_TOL = {"float32": 1e-5, "bfloat16": 2e-2}
PAGE_SIZE = 16        # cfg.kv_page_size: the paged serve's page size
DEFAULT_PAGES = 256   # the default budget: 8 slots x ceil(512 / 16)
# phase 8: eight requests of 160-320 prompt tokens and 48 new tokens each
# need ceil((P + 48) / 16) = 13 to 23 pages at their ends, about 144 in
# all for this seed (145), against a pool of 128; admission prices only the
# prompts (10 to 20 pages each), so growth runs the pool dry mid-stream
PRESSURE = dict(pages=128, lo=160, hi=321, max_new=48, seed=3)
# the adaptation slice: examples/serve_batched.py at qwen2-1.5b's width
ADAPT = dict(batch_size=48, seq=64, max_way=8, task_way=5, pad=48, iters=10)
# phase 10: the personalised serve and its online refresh loop
PERSONALISE = dict(slots=8, max_len=128, chunk=16, requests=16, users=4,
                   max_new=16, iters=8, seq=32)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def max_err(got, want, tol: float, what: str) -> float:
    """Max abs error of ``got`` against ``want``; fails unless every
    element is finite and within ``tol + tol * |want|``."""
    import torch

    got, want = got.float(), want.float()
    err = (got - want).abs()
    worst = err.max().item()
    if not (torch.isfinite(got).all().item()
            and (err <= tol + tol * want.abs()).all().item()):
        fail(f"{what}: max abs error {worst} beyond {tol:g} (or non-finite)")
    return worst


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


def page_table(kv_len, ps, mp, n_pages, gen, device):
    """A (B, mp) int32 table over a randomly permuted arena of ``n_pages``
    pages: sample b maps ceil(kv_len[b] / ps) pages, the rest is -1."""
    import torch

    perm = torch.randperm(n_pages, generator=gen, device=device).tolist()
    table = torch.full((len(kv_len), mp), -1, dtype=torch.int32)
    nxt = 0
    for b, n in enumerate(kv_len):
        used = -(-int(n) // ps)
        table[b, :used] = torch.tensor(perm[nxt:nxt + used])
        nxt += used
    return table.to(device)


def fill_pages(arena, x, table, rows):
    """Copy sample b's logical rows [0, rows[b]) of contiguous ``x`` (B,
    S, Hkv, D) into its pages of ``arena`` (n_pages, ps, Hkv, D), in
    place; every other row of the arena keeps what it held."""
    ps = arena.shape[1]
    tab = table.tolist()
    for b, n in enumerate(rows):
        for j in range(-(-int(n) // ps)):
            m = min(ps, int(n) - j * ps)
            arena[tab[b][j], :m] = x[b, j * ps:j * ps + m]
    return arena


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

    from repro_torch import api, configs
    from repro_torch.kernels import build, flash_attention, flash_paged, ops
    from repro_torch.kernels import fisher as fisher_kernel
    from repro_torch.kernels import grad_quant as gq_kernel
    from repro_torch.kernels.ref import (
        fisher_ref, fisher_tapgrads_ref, flash_attention_cached_ref,
        flash_attention_paged_ref, grad_quant_ref,
    )
    from repro_torch.core.policy import SelectedUnit, SparseUpdatePolicy
    from repro_torch.models import transformer as T
    from repro_torch.models.overlay import fold_deltas
    from repro_torch.optim import compress
    from repro_torch.serving import (
        DeltaSet, Personaliser, Request, ServeEngine,
    )
    from repro_torch.utils import tree_leaves, tree_map

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
    flash = {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
             "bound_ms": bound_ms, "bound_by": bound_by, "max_abs_err": worst}

    # -- paged flash kernel: parity at the paged serve's shapes ---------------
    # the cached kernel's cursors and rows, laid out in pages of 1, 5 and 16
    # rows over a randomly permuted arena with unmapped tails
    p_worst = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[-1]
        q = torch.randn((B, Sq, Hq, D), generator=gen, device=dev).to(dtype)
        k = torch.randn((B, Sk, Hkv, D), generator=gen, device=dev).to(dtype)
        v = torch.randn((B, Sk, Hkv, D), generator=gen, device=dev).to(dtype)
        cached = ops.flash_attention_cached(q, k, v, q_offset=qo, kv_len=kl)
        for ps in (1, 5, PAGE_SIZE):
            mp = -(-Sk // ps)
            n_pages = sum(-(-n // ps) for n in KV_LEN) + 7
            table = page_table(KV_LEN, ps, mp, n_pages, gen, dev)
            shape = (n_pages, ps, Hkv, D)
            kp = fill_pages(torch.randn(shape, generator=gen, device=dev)
                            .to(dtype), k, table, KV_LEN)
            vp = fill_pages(torch.randn(shape, generator=gen, device=dev)
                            .to(dtype), v, table, KV_LEN)
            got = ops.flash_attention_paged(q, kp, vp, table, q_offset=qo,
                                            kv_len=kl)
            want = flash_attention_paged_ref(q, kp, vp, table, q_offset=qo,
                                             kv_len=kl)
            # NaN in every arena row, but the rows some query can see
            seen = [min(n, o + Sq) for o, n in zip(Q_OFFSET, KV_LEN)]
            nan = torch.full(shape, float("nan"), device=dev).to(dtype)
            pk = fill_pages(nan.clone(), k, table, seen)
            pv = fill_pages(nan, v, table, seen)
            poisoned = ops.flash_attention_paged(q, pk, pv, table,
                                                 q_offset=qo, kv_len=kl)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            vs_cached = (got.float() - cached.float()).abs().max().item()
            zero_row = got[0].float().abs().max().item()
            print(f"[parity] flash_paged {dname} page_size={ps} ({mp} table "
                  f"columns): max abs err {err:.3g} (tol {TOL[dname]:g}); "
                  f"max abs diff vs flash_cached on the same rows "
                  f"{vs_cached:g} (gate 0.0); kv_len=0 row max {zero_row:g}; "
                  f"NaN in unseen rows: "
                  f"{'output unchanged' if torch.equal(poisoned, got) else 'OUTPUT CHANGED'}",
                  flush=True)
            if not math.isfinite(err) or err > TOL[dname]:
                fail(f"flash_paged {dname} page_size={ps} error {err}")
            if not torch.equal(got, cached):
                fail(f"flash_paged {dname} page_size={ps} differs from "
                     f"flash_cached on the same rows by {vs_cached}")
            if zero_row != 0.0:
                fail("a kv_len = 0 row must give 0")
            if not torch.equal(poisoned, got):
                fail(f"flash_paged {dname} page_size={ps}: a NaN in a row no "
                     "query can see reached the output")
            p_worst = max(p_worst, err)

    # time at the paged serve's block-prefill shapes in bf16: page size 16,
    # 32 table columns over a permuted arena of the default 256 pages, one
    # arena per layer (28 x 4 MiB > the 50 MB L2) cycled as a tick does
    mp = Sk // PAGE_SIZE
    table = page_table(KV_LEN, PAGE_SIZE, mp, DEFAULT_PAGES, gen, dev)
    arena = (nl, DEFAULT_PAGES, PAGE_SIZE, Hkv, D)
    kps = torch.randn(arena, generator=gen, device=dev).to(torch.bfloat16)
    vps = torch.randn(arena, generator=gen, device=dev).to(torch.bfloat16)
    p_entry = flash_paged._entry()
    it["i"] = 0

    def pages():
        i = it["i"] = (it["i"] + 1) % nl
        return kps[i], vps[i]

    def run_paged():
        kp, vp = pages()
        err = p_entry(q.data_ptr(), kp.data_ptr(), vp.data_ptr(),
                      out.data_ptr(), table.data_ptr(), qo.data_ptr(),
                      kl.data_ptr(), B, Sq, Hq, Hkv, D, DEFAULT_PAGES,
                      PAGE_SIZE, mp, 1, stream)
        if err:
            fail(f"flash_paged_fwd returned cudaError {err}")

    def run_paged_plain():
        kp, vp = pages()
        flash_attention_paged_ref(q, kp, vp, table, q_offset=qo, kv_len=kl)

    rows_ok = (table >= 0).repeat_interleave(PAGE_SIZE, dim=1)  # (B, 512)
    gather_idx = table.long().clamp(min=0)

    def run_paged_library():
        # a gather of the pages into the logical view, then SDPA
        kp, vp = pages()
        kk = kp[gather_idx].reshape(B, Sk, Hkv, D).transpose(1, 2)
        vv = vp[gather_idx].reshape(B, Sk, Hkv, D).transpose(1, 2)
        F.scaled_dot_product_attention(qt, kk, vv,
                                       attn_mask=mask & rows_ok[:, None, None],
                                       enable_gqa=True)

    p_ms = time_ms(run_paged, 4 * nl)
    p_plain_ms = time_ms(run_paged_plain, nl)
    p_library_ms = time_ms(run_paged_library, 4 * nl)
    nbytes, nops = flash_work(Q_OFFSET, KV_LEN, Sq, Hq, Hkv, D, 2, 0)
    nbytes += table.numel() * 4
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, nops / PEAK_OPS["bfloat16"]
    p_bound_ms = 1e3 * max(t_bytes, t_ops)
    p_bound_by = "bytes" if t_bytes >= t_ops else "operations"
    print(f"[time] flash_paged bf16 B={B} Sq={Sq} Hq={Hq} Hkv={Hkv} D={D} "
          f"page_size={PAGE_SIZE} table {B}x{mp} over {DEFAULT_PAGES} pages: "
          f"kernel {p_ms:.4f} ms, bound {p_bound_ms:.5f} ms ({p_bound_by}: "
          f"{nbytes} B, {nops} ops), plain {p_plain_ms:.4f} ms, page gather "
          f"+ sdpa {p_library_ms:.4f} ms", flush=True)
    paged = {"ms": p_ms, "plain_ms": p_plain_ms, "library_ms": p_library_ms,
             "bound_ms": p_bound_ms, "bound_by": p_bound_by,
             "max_abs_err": p_worst}
    del kps, vps

    # -- Fisher kernel: parity at the adaptation path's shapes ---------------
    # the main path's tap-gradient groups: (layers, support rows, channels)
    # for the attention heads and the d_ff neurons of qwen2-1.5b, with the
    # padding rows of its episode masked (and filled with NaN here: a
    # masked row must never be read)
    task = api.sample_lm_task(np.random.default_rng(0), cfg.vocab,
                              seq=ADAPT["seq"], max_way=ADAPT["task_way"],
                              support_pad=ADAPT["pad"], query_pad=ADAPT["pad"])
    labels = torch.from_numpy(task.support["episode_labels"]).to(dev)
    n_rows, n_valid = labels.shape[0], task.n_support
    row_mask = (labels >= 0).float()
    tap_shapes = [(nl, n_rows, cfg.n_heads), (nl, n_rows, cfg.d_ff)]
    f_worst = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[-1]
        tol = FISHER_TOL[dname]
        for shape in tap_shapes:
            g = torch.randn(shape, generator=gen, device=dev).to(dtype)
            for m in (None, row_mask):
                gm = g.clone()
                if m is not None:
                    gm[:, m == 0] = float("nan")
                got = ops.fisher_tapgrads(gm, float(n_valid), m)
                want = fisher_tapgrads_ref(gm, float(n_valid), m)
                torch.cuda.synchronize()
                err = max_err(got, want, tol, f"fisher_tapgrads {dname} "
                              f"{shape} masked={m is not None}")
                f_worst = max(f_worst, err)
                print(f"[parity] fisher_tapgrads {dname} {shape} masked="
                      f"{m is not None}: max abs err {err:.3g} (tol {tol:g} "
                      f"rel+abs)", flush=True)
        for shape in ((4, 1024, 512), (6, 7, 77)):
            a = torch.randn(shape, generator=gen, device=dev).to(dtype)
            g = (0.1 * torch.randn(shape, generator=gen, device=dev)).to(dtype)
            m = (torch.arange(shape[0], device=dev) < shape[0] - 2).float()
            a[-2:], g[-2:] = float("nan"), float("nan")
            got = ops.fisher(a, g, mask=m)
            want = fisher_ref(a, g, m)
            torch.cuda.synchronize()
            err = max_err(got, want, tol, f"fisher {dname} {shape}")
            clean_a, clean_g = a[:-2].contiguous(), g[:-2].contiguous()
            got = ops.fisher(clean_a, clean_g)
            err2 = max_err(got, fisher_ref(clean_a, clean_g), tol,
                           f"fisher {dname} {shape} unmasked")
            f_worst = max(f_worst, err, err2)
            print(f"[parity] fisher {dname} {shape}: masked (NaN rows) max "
                  f"abs err {err:.3g}, unmasked {err2:.3g} (tol {tol:g} "
                  f"rel+abs)", flush=True)

    # time the ffn group's reduction, f32 tap gradients as the probe makes
    # them, cycling through 4 buffers (4 x 48 MB > the 50 MB L2) since the
    # probe's gradients are fresh; the kernel through its C entry
    shape = tap_shapes[1]
    gs = [torch.randn(shape, generator=gen, device=dev) for _ in range(4)]
    out = torch.empty(shape[::2], device=dev)
    f_entry = fisher_kernel._entry()
    scale = 1.0 / (2.0 * n_valid)
    it["i"] = 0

    def next_g():
        i = it["i"] = (it["i"] + 1) % len(gs)
        return gs[i]

    def run_fisher():
        err = f_entry(None, next_g().data_ptr(), row_mask.data_ptr(),
                      out.data_ptr(), shape[0], shape[1], 1, shape[2], scale,
                      0, 0, stream)
        if err:
            fail(f"fisher_fwd returned cudaError {err}")

    def run_fisher_plain():
        fisher_tapgrads_ref(next_g(), n_valid, row_mask)

    def run_fisher_library():
        g = next_g()
        torch.einsum("lbc,lbc,b->lc", g, g, row_mask).mul_(scale)

    f_ms = time_ms(run_fisher, 100)
    f_plain_ms = time_ms(run_fisher_plain, 20)
    f_library_ms = time_ms(run_fisher_library, 50)
    cells = shape[0] * shape[2]
    f_bytes = 4 * (n_valid * cells + n_rows + cells)  # valid rows, mask, out
    f_ops = 3 * n_valid * cells                         # square, weight, add
    t_bytes, t_ops = f_bytes / HBM_BYTES_PER_S, f_ops / PEAK_OPS["float32"]
    f_bound_ms = 1e3 * max(t_bytes, t_ops)
    f_bound_by = "bytes" if t_bytes >= t_ops else "operations"
    print(f"[time] fisher_tapgrads f32 {shape} ({n_valid} of {n_rows} rows "
          f"valid): kernel {f_ms:.4f} ms, bound {f_bound_ms:.5f} ms "
          f"({f_bound_by}: {f_bytes} B, {f_ops} ops), plain "
          f"{f_plain_ms:.4f} ms, einsum {f_library_ms:.4f} ms", flush=True)
    fisher = {"ms": f_ms, "plain_ms": f_plain_ms,
              "library_ms": f_library_ms, "bound_ms": f_bound_ms,
              "bound_by": f_bound_by, "max_abs_err": f_worst}
    del gs

    # -- grad_quant kernel: exact parity with its plain version ---------------
    # the kernel's largest leaf on phase 10's path: an MLP unit's w_gate
    # delta, d_model x half of d_ff (the scaled edge-lm profile keeps half
    # of each unit's channels; phase 10 checks it against its policy)
    GQ_LEAF = (cfg.d_model, cfg.d_ff // 2)
    # a ragged multi-block size, the main path's largest leaf, ties (absmax
    # 127 makes the scale exactly 1, so k + 0.5 rounds half to even), zeros
    # and a NaN; codes, scale and residual must be equal, not close
    def gq_case(n, dtype, kind):
        if kind == "ties":
            g = torch.tensor([127.0, 0.5, 1.5, 2.5, -0.5, -2.5, 126.5, 3.25],
                             device=dev)
            return g.to(dtype), torch.zeros(g.shape, device=dev)
        g = torch.randn(n, generator=gen, device=dev)
        err = 0.01 * torch.randn(n, generator=gen, device=dev)
        if kind == "zeros":
            g, err = torch.zeros_like(g), torch.zeros_like(err)
        if kind == "nan":
            g[n // 3] = float("nan")
        return g.to(dtype), err

    gq_cases = [(1, "normal"), (5000, "normal"), (6151, "normal"),
                (1_000_003, "normal"), (GQ_LEAF[0] * GQ_LEAF[1], "normal"),
                (8, "ties"), (4099, "zeros"), (4099, "nan")]
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[-1]
        for n, kind in gq_cases:
            g, err = gq_case(n, dtype, kind)
            got = ops.grad_quant(g, err)
            want = grad_quant_ref(g, err)
            torch.cuda.synchronize()
            same = all(a.dtype == b.dtype and a.shape == b.shape
                       and torch.equal(torch.nan_to_num(a.float(), nan=7.0),
                                       torch.nan_to_num(b.float(), nan=7.0))
                       and torch.equal(a.isnan(), b.isnan())
                       for a, b in zip(got, want))
            print(f"[parity] grad_quant {dname} n={n} {kind}: codes, scale "
                  f"and residual {'equal' if same else 'DIFFERENT'} (gate: "
                  f"equal); scale {got[1].item():.6g}", flush=True)
            if not same:
                fail(f"grad_quant {dname} n={n} {kind} differs from its "
                     "plain version")
            if kind == "ties" and got[0].tolist() != [127, 0, 2, 2, 0, -2,
                                                      126, 3]:
                fail(f"grad_quant ties rounded {got[0].tolist()}")
    # the tree compressor launches once per leaf and reads nothing back
    tree = {"L0": {"mlp": {
        "w_up": torch.randn(GQ_LEAF, generator=gen, device=dev).bfloat16(),
        "w_down": torch.randn(GQ_LEAF[::-1], generator=gen,
                              device=dev).bfloat16()}}}
    ef = compress.ef_state_init(tree)
    before = ops.grad_quant.launches
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        q_t, s_t, ef = compress.int8_compress(tree, ef)
        compress.int8_decompress(q_t, s_t, torch.bfloat16)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    print(f"[parity] int8_compress of a 2-leaf tree on the card: "
          f"{ops.grad_quant.launches - before} grad_quant launches, no "
          "synchronising call (sync debug mode 'error')", flush=True)
    if ops.grad_quant.launches - before != 2:
        fail("int8_compress did not launch grad_quant once per leaf")

    # time at the largest leaf: bf16 g and a float32 residual, cycling 4
    # buffers (4 x 41 MB > the 50 MB L2), the kernel through its C entry
    n_gq = GQ_LEAF[0] * GQ_LEAF[1]
    gbufs = [(torch.randn(n_gq, generator=gen, device=dev).bfloat16(),
              0.01 * torch.randn(n_gq, generator=gen, device=dev))
             for _ in range(4)]
    q_out = torch.empty(n_gq, dtype=torch.int8, device=dev)
    e_out = torch.empty(n_gq, device=dev)
    scratch = torch.empty(2, device=dev)
    gq_entry = gq_kernel._entry()
    it["i"] = 0

    def next_gq():
        i = it["i"] = (it["i"] + 1) % len(gbufs)
        return gbufs[i]

    def run_gq():
        g, e = next_gq()
        rc = gq_entry(g.data_ptr(), e.data_ptr(), q_out.data_ptr(),
                      e_out.data_ptr(), scratch.data_ptr(), n_gq, 1, stream)
        if rc:
            fail(f"grad_quant_fwd returned cudaError {rc}")

    def run_gq_plain():
        grad_quant_ref(*next_gq())

    gq_ms = time_ms(run_gq, 40)
    gq_plain_ms = time_ms(run_gq_plain, 10)
    # each input read once and each output written once: g (bf16), err,
    # q (int8), new_err and the scale; add, abs, max, divide, round,
    # clip, multiply, subtract per element
    gq_bytes = n_gq * (2 + 4 + 1 + 4) + 4
    gq_ops = 8 * n_gq
    t_bytes, t_ops = gq_bytes / HBM_BYTES_PER_S, gq_ops / PEAK_OPS["float32"]
    gq_bound_ms = 1e3 * max(t_bytes, t_ops)
    gq_bound_by = "bytes" if t_bytes >= t_ops else "operations"
    print(f"[time] grad_quant bf16 g, f32 err, {GQ_LEAF[0]}x{GQ_LEAF[1]} = "
          f"{n_gq} elements: kernel {gq_ms:.4f} ms, bound {gq_bound_ms:.5f} "
          f"ms ({gq_bound_by}: {gq_bytes} B, {gq_ops} ops), plain "
          f"{gq_plain_ms:.4f} ms, no single library call", flush=True)
    gquant = {"ms": gq_ms, "plain_ms": gq_plain_ms, "library_ms": None,
              "bound_ms": gq_bound_ms, "bound_by": gq_bound_by,
              "max_abs_err": 0.0}
    del gbufs, tree, ef, q_t, s_t

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
    # the paged engine: fp pages, then half the page budget (16 pages of 8
    # rows for 4 slots of 32; 8 short prompts that generate 16 tokens each
    # outgrow 8 pages, so streams are preempted and requeued)
    rng = np.random.default_rng(1)
    short = [rng.integers(0, small.vocab, int(rng.integers(3, 9)))
             .astype(np.int32) for _ in range(8)]
    paged_cases = {
        "paged": (dict(slots=3, max_len=48, chunk=4, kv_paging=True,
                       kv_page_size=8), prompts, 6),
        "paged, half the pages": (dict(slots=4, max_len=32, chunk=8,
                                       kv_paging=True, kv_page_size=8,
                                       page_budget=8), short, 16),
    }
    for what, (kw, ps_, max_new) in paged_cases.items():
        got, tally = {}, {}
        for where, params in (("cpu", sp_cpu), ("cuda", sp_gpu)):
            eng = ServeEngine(small, params, device=where, **kw)
            reqs = [Request(uid=i, prompt=p, max_new=max_new)
                    for i, p in enumerate(ps_)]
            eng.run(reqs)
            got[where] = [(r.out, r.outcome) for r in reqs]
            tally[where] = eng.last_run_report["outcomes"]
        same = got["cpu"] == got["cuda"]
        print(f"[check] qwen2-smoke f32 {what} greedy streams, card vs CPU "
              f"plain path: {'identical' if same else 'DIFFERENT'} over "
              f"{len(ps_)} requests (outcomes {tally['cuda']})", flush=True)
        if not same or tally["cpu"] != tally["cuda"]:
            fail(f"{what} streams differ: cpu {got['cpu']} {tally['cpu']} "
                 f"cuda {got['cuda']} {tally['cuda']}")
        if "page_budget" in kw and tally["cuda"].get("requeued", 0) < 1:
            fail(f"{what}: no stream was requeued ({tally['cuda']})")

    # TinyTrain on qwen2-smoke: the card (Fisher kernel, flash kernel in
    # the folded engine) against the plain path on the CPU, same weights
    sbb = api.backbone("qwen2-1.5b", preset="smoke", batch_size=32, seq=16)
    stask = api.sample_lm_task(np.random.default_rng(0), small.vocab,
                               seq=16, max_way=5, support_pad=32,
                               query_pad=32)
    adapted = {}
    for where, params in (("cpu", sp_cpu), ("cuda", sp_gpu)):
        sess = api.TinyTrainSession(sbb, params, max_way=5)
        ad = sess.adapt(stask, api.JETSON_NANO, iters=4)
        eng = ServeEngine(small, params, slots=3, max_len=48, chunk=4,
                          device=where)
        ad.fold_into(eng)
        reqs = [Request(uid=i, prompt=p, max_new=6)
                for i, p in enumerate(prompts)]
        eng.run(reqs)
        adapted[where] = (ad, [(r.out, r.outcome) for r in reqs])
    (a_cpu, s_cpu), (a_gpu, s_gpu) = adapted["cpu"], adapted["cuda"]
    loss_err = max(abs(x - y) for x, y in zip(a_cpu.losses, a_gpu.losses))
    print(f"[check] qwen2-smoke f32 TinyTrain, card vs CPU plain path: "
          f"policy {'identical' if a_cpu.policy.units == a_gpu.policy.units else 'DIFFERENT'} "
          f"({a_gpu.policy.describe()}), max loss diff {loss_err:.3g} "
          f"(tol 1e-4), folded-engine streams "
          f"{'identical' if s_cpu == s_gpu else 'DIFFERENT'}", flush=True)
    if a_cpu.policy.units != a_gpu.policy.units:
        fail(f"policies differ: {a_cpu.policy.describe()} vs "
             f"{a_gpu.policy.describe()}")
    if not loss_err <= 1e-4:
        fail(f"losses differ: {a_cpu.losses} vs {a_gpu.losses}")
    if s_cpu != s_gpu:
        fail(f"folded streams differ: cpu {s_cpu} cuda {s_gpu}")

    # personalisation on qwen2-smoke: two users' deltas resident at once in
    # the per-slot arena, card against CPU and against each user's folded
    # engine on the card (block 1 and 8, contiguous and paged)
    spol = SparseUpdatePolicy(horizon=0, units=(
        SelectedUnit(1, "attn", (0, small.n_heads - 1)),
        SelectedUnit(2, "mlp", (0, 7, small.d_ff - 1))))
    dgen = torch.Generator().manual_seed(7)
    udeltas = {u: tree_map(lambda z: 0.5 * torch.randn(
        z.shape, generator=dgen), sbb.init_deltas(spol, "cpu"))
        for u in (0, 1)}
    pers_streams = {}
    for mode, kw in (("block8", {}), ("block1", dict(prefill_block=1)),
                     ("paged", dict(kv_paging=True, kv_page_size=8))):
        for where, params in (("cpu", sp_cpu), ("cuda", sp_gpu)):
            kw_all = dict(slots=3, max_len=48, chunk=4, device=where, **kw)
            eng = ServeEngine(small, params, personalise=spol, **kw_all)
            on = params["embed"].device
            for u, d in udeltas.items():
                eng.swap_deltas(u, DeltaSet.from_policy(
                    spol, tree_map(lambda t: t.to(on), d)))
            reqs = [Request(uid=i % 2, prompt=p, max_new=6)
                    for i, p in enumerate(prompts)]
            eng.run(reqs)
            pers_streams[(mode, where)] = [(r.out, r.outcome) for r in reqs]
            if where == "cuda":
                folded = {}
                for u, d in udeltas.items():
                    fe = ServeEngine(small, fold_deltas(
                        small, params, tree_map(lambda t: t.to(on), d),
                        spol), **kw_all)
                    rr = [Request(uid=i % 2, prompt=p, max_new=6)
                          for i, p in enumerate(prompts)]
                    fe.run(rr)
                    folded[u] = [(r.out, r.outcome) for r in rr]
                pers_streams[(mode, "folded")] = [
                    folded[i % 2][i] for i in range(len(prompts))]
        same_cpu = pers_streams[(mode, "cpu")] == pers_streams[(mode, "cuda")]
        same_fold = (pers_streams[(mode, "folded")]
                     == pers_streams[(mode, "cuda")])
        print(f"[check] qwen2-smoke f32 personalised ({mode}, 2 users, "
              f"{spol.describe()}): card vs CPU "
              f"{'identical' if same_cpu else 'DIFFERENT'}, card overlay vs "
              f"card folded engines {'identical' if same_fold else 'DIFFERENT'}"
              f" over {len(prompts)} requests", flush=True)
        if not same_cpu:
            fail(f"personalised streams differ, card vs CPU ({mode}): "
                 f"{pers_streams[(mode, 'cpu')]} vs "
                 f"{pers_streams[(mode, 'cuda')]}")
        if not same_fold:
            fail(f"personalised streams differ from the folded engines on "
                 f"the card ({mode}): {pers_streams[(mode, 'cuda')]} vs "
                 f"{pers_streams[(mode, 'folded')]}")

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
    phase5 = [list(r.out) for r in reqs]
    prompts5 = [r.prompt for r in reqs]
    del eng

    def full_serve(reqs, **kw):
        """Serve ``reqs`` through a fresh engine on phase 5's weights: a
        warm-up request, then the kernel counts set to 0, the run, and the
        counts read just after.  Returns (engine, wall seconds, paged
        launches, cached launches)."""
        eng = ServeEngine(cfg, params, slots=8, max_len=512, chunk=32, **kw)
        eng.run([Request(uid=-1, prompt=np.arange(8, dtype=np.int32),
                         max_new=2)])
        torch.cuda.synchronize()
        ops.flash_attention_paged.launches = 0
        ops.flash_attention_cached.launches = 0
        t0 = time.perf_counter()
        eng.run(reqs)
        torch.cuda.synchronize()
        return (eng, time.perf_counter() - t0,
                ops.flash_attention_paged.launches,
                ops.flash_attention_cached.launches)

    def all_done(reqs, n_new, what):
        bad = [(r.uid, r.outcome, len(r.out)) for r in reqs
               if r.outcome != "done" or len(r.out) != n_new
               or not all(0 <= t < cfg.vocab for t in r.out)]
        if bad:
            fail(f"{what}: requests not done with {n_new} in-vocabulary "
                 f"tokens: {bad}")

    # -- paged serve: phase 5's requests on a paged KV cache ------------------
    row_bytes = 2 * cfg.n_kv_heads * cfg.head_dim  # K and V of one row, bf16
    stripe_bytes = DEFAULT_PAGES * PAGE_SIZE * nl * row_bytes * 2
    reqs = [Request(uid=i, prompt=p, max_new=16)
            for i, p in enumerate(prompts5)]
    eng, wall, paged_launches, cached_in_paged = full_serve(
        reqs, kv_paging=True, kv_page_size=PAGE_SIZE)
    rep, mem = eng.last_run_report, eng.last_run_report["memory"]
    table_bytes = sum(g["attn"]["page_table"].numel() * 4
                      for g in eng.caches.values())
    same = sum(list(r.out) == want for r, want in zip(reqs, phase5))
    # what a stream holds at its end, in pages, against a max_len stripe
    held = statistics.mean(-(-(len(r.prompt) + len(r.out)) // PAGE_SIZE)
                           for r in reqs)
    stripe = DEFAULT_PAGES // 8  # pages in one slot's 512-row stripe
    print(f"[paged] qwen2-1.5b bf16 full width, 8 slots, max_len 512, chunk "
          f"32, page size {PAGE_SIZE}, {mem['n_pages']} pages: "
          f"{sum(len(r.out) for r in reqs)} new tokens in {wall:.3f} s = "
          f"{sum(len(r.out) for r in reqs) / wall:.2f} tok/s, {rep['ticks']} "
          f"ticks, {rep['host_syncs']} host syncs, peak {rep['peak_resident']} "
          f"resident; streams equal to phase 5's: {same} of {len(reqs)}; "
          f"kv_cache_bytes {mem['kv_cache_bytes']} (pages "
          f"{mem['page_bytes'] * mem['n_pages']}, fixed-stripe bytes "
          f"{stripe_bytes}, page table {table_bytes}); a stream holds "
          f"{held:.2f} pages at its end, {held * mem['page_bytes']:.0f} B = "
          f"{held / stripe:.3f}x a {stripe}-page stripe; flash_paged launches "
          f"{paged_launches}, flash_cached launches {cached_in_paged}",
          flush=True)
    all_done(reqs, 16, "paged serve")
    if same != len(reqs):
        fail("the paged serve's streams differ from phase 5's")
    if paged_launches <= 0 or paged_launches % nl:
        fail(f"flash_paged launches {paged_launches} is not a positive "
             f"multiple of n_layers = {nl}")
    if cached_in_paged:
        fail(f"fp pages fell through to flash_cached ({cached_in_paged} "
             "launches)")
    if mem["kv_cache_bytes"] < stripe_bytes:
        fail(f"kv_cache_bytes {mem['kv_cache_bytes']} below the fixed-stripe "
             f"bytes {stripe_bytes}")
    del eng

    # -- pressure: half the pages, streams outgrow the pool -------------------
    rng = np.random.default_rng(PRESSURE["seed"])
    lens8 = rng.integers(PRESSURE["lo"], PRESSURE["hi"], 8)
    prompts8 = [rng.integers(0, cfg.vocab, int(n)).astype(np.int32)
                for n in lens8]
    demand = sum(-(-(int(n) + PRESSURE["max_new"]) // PAGE_SIZE)
                 for n in lens8)
    admit = sum(-(-int(n) // PAGE_SIZE) for n in lens8)

    def requests8():
        return [Request(uid=i, prompt=p, max_new=PRESSURE["max_new"])
                for i, p in enumerate(prompts8)]

    reqs = requests8()
    eng, wall, pressure_launches, _ = full_serve(
        reqs, kv_paging=True, kv_page_size=PAGE_SIZE,
        page_budget=PRESSURE["pages"])
    rep = eng.last_run_report
    del eng
    roomy = requests8()
    ServeEngine(cfg, params, slots=8, max_len=512, chunk=32, kv_paging=True,
                kv_page_size=PAGE_SIZE).run(roomy)
    same = sum(list(a.out) == list(b.out) for a, b in zip(reqs, roomy))
    new_tokens = sum(len(r.out) for r in reqs)
    print(f"[pressure] {PRESSURE['pages']} pages of {PAGE_SIZE} rows (half of "
          f"{DEFAULT_PAGES}); prompts {sorted(int(n) for n in lens8)} + "
          f"{PRESSURE['max_new']} new tokens need {demand} pages at their "
          f"ends ({admit} at admission): {new_tokens} new tokens in "
          f"{wall:.3f} s = {new_tokens / wall:.2f} tok/s, {rep['ticks']} "
          f"ticks, {rep['host_syncs']} host syncs, outcomes "
          f"{rep['outcomes']}, preemptions {sum(r.preempts for r in reqs)}, "
          f"peak {rep['peak_resident']} resident where the same pages hold "
          f"{PRESSURE['pages'] // stripe} fixed stripes; streams equal to an "
          f"unpressured run: {same} of {len(reqs)} (reported, not gated); "
          f"flash_paged launches {pressure_launches}", flush=True)
    all_done(reqs, PRESSURE["max_new"], "pressure")
    if rep["outcomes"].get("requeued", 0) < 1:
        fail(f"half the pages preempted nothing: {rep['outcomes']}")
    if pressure_launches <= 0:
        fail("the pressure phase never launched flash_paged")

    # -- int8 pages: phase 5's requests ---------------------------------------
    int8_bytes = DEFAULT_PAGES * PAGE_SIZE * nl * 2 * (
        cfg.n_kv_heads * cfg.head_dim + 4)  # int8 codes + a f32 scale a row
    reqs = [Request(uid=i, prompt=p, max_new=16)
            for i, p in enumerate(prompts5)]
    eng, wall, paged_in_int8, int8_launches = full_serve(
        reqs, kv_paging=True, kv_page_size=PAGE_SIZE, kv_int8=True)
    rep, mem = eng.last_run_report, eng.last_run_report["memory"]
    pages_bytes = mem["page_bytes"] * mem["n_pages"]
    same = sum(list(r.out) == want for r, want in zip(reqs, phase5))
    print(f"[int8] int8 pages + per-row scales {pages_bytes} B (expected "
          f"{int8_bytes}; bf16 pages {stripe_bytes} B: "
          f"{pages_bytes / stripe_bytes:.3f}x), kv_cache_bytes "
          f"{mem['kv_cache_bytes']}: {sum(len(r.out) for r in reqs)} new "
          f"tokens in {wall:.3f} s = {sum(len(r.out) for r in reqs) / wall:.2f}"
          f" tok/s, {rep['ticks']} ticks; streams equal to phase 5's: {same} "
          f"of {len(reqs)} (reported, not gated); flash_cached launches "
          f"{int8_launches} (block prefill over the gathered int8 view), "
          f"flash_paged launches {paged_in_int8}", flush=True)
    all_done(reqs, 16, "int8 pages")
    if pages_bytes != int8_bytes:
        fail(f"int8 pages hold {pages_bytes} B, not {int8_bytes}")
    del eng, params
    torch.cuda.empty_cache()

    # -- adapt: examples/serve_batched.py at qwen2-1.5b's full width --------
    bb = api.backbone("qwen2-1.5b", preset="full",
                      batch_size=ADAPT["batch_size"], seq=ADAPT["seq"])
    session = api.TinyTrainSession(bb, max_way=ADAPT["max_way"], seed=0)
    # examples/serve_batched.py's profile (4 MB, compute 0.5) selects no
    # unit at this width: each unit's saved input alone is 18.9 MB
    profile = api.DeviceProfile(name="edge-lm", mem_kb=4000,
                                compute_frac=0.5).scaled(mem=500, compute=1.6)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.fisher_tapgrads.launches = ops.fisher.launches = 0
    ops.flash_attention_cached.launches = 0
    t0 = time.perf_counter()
    adaptation = session.adapt(task, profile, iters=ADAPT["iters"])
    torch.cuda.synchronize()
    adapt_wall = time.perf_counter() - t0
    adapt_peak = torch.cuda.max_memory_allocated()
    eng = ServeEngine(cfg, session.params, slots=4, max_len=96, chunk=16)
    adaptation.fold_into(eng)
    rng = np.random.default_rng(0)
    reqs = [Request(uid=i, prompt=rng.integers(
        0, cfg.vocab, size=int(rng.integers(4, 16))).astype(np.int32),
        max_new=12) for i in range(10)]
    t0 = time.perf_counter()
    eng.run(reqs)
    torch.cuda.synchronize()
    adapt_serve_wall = time.perf_counter() - t0
    fisher_launches = ops.fisher_tapgrads.launches + ops.fisher.launches
    adapt_flash_launches = ops.flash_attention_cached.launches
    rep = eng.last_run_report
    pol = adaptation.policy
    kinds = sorted({u.kind for u in pol.units})
    losses = adaptation.losses
    print(f"[adapt] qwen2-1.5b bf16 full width, {profile.name} "
          f"({profile.budget().mem_bytes:.0f} B, compute "
          f"{profile.compute_frac}), task {task.n_support} support rows "
          f"of {n_rows}: {pol.describe()}", flush=True)
    print(f"[adapt] fisher_seconds {adaptation.fisher_seconds:.4f}, "
          f"train_seconds {adaptation.train_seconds:.4f} "
          f"({ADAPT['iters']} steps), adapt wall {adapt_wall:.4f} s, peak "
          f"device memory {adapt_peak} B, host_transfers "
          f"{adaptation.host_transfers:g}, skipped {adaptation.skipped_steps}, "
          f"fisher launches {fisher_launches}, memory_report total_bytes "
          f"{adaptation.memory_report()['total_bytes']}", flush=True)
    print(f"[adapt] losses {[round(x, 6) for x in losses]}", flush=True)
    print(f"[adapt] folded engine: {len(reqs)} requests, "
          f"{sum(len(r.out) for r in reqs)} new tokens in "
          f"{adapt_serve_wall:.3f} s, {rep['ticks']} ticks, "
          f"{rep['host_syncs']} host syncs, outcomes {rep['outcomes']}, "
          f"flash_cached launches {adapt_flash_launches}", flush=True)
    if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        fail(f"adaptation losses must be finite and fall: {losses}")
    if adaptation.host_transfers != 2:
        fail(f"fused adapt made {adaptation.host_transfers} host transfers, "
             "not 2")
    if fisher_launches != 2:
        fail(f"the probe launched the Fisher kernel {fisher_launches} times, "
             "not once per tap group (2)")
    if kinds != ["attn", "mlp"]:
        fail(f"the profile selected {kinds}, not attention and MLP units")
    if not all(r.done and r.outcome == "done" for r in reqs):
        fail(f"folded-engine requests not done: "
             f"{[(r.uid, r.outcome) for r in reqs]}")
    if adapt_flash_launches <= 0 or adapt_flash_launches % nl:
        fail(f"the folded engine launched flash_cached "
             f"{adapt_flash_launches} times")
    del eng

    # -- personalise: per-slot deltas and the online refresh loop -----------
    P = PERSONALISE
    eng = ServeEngine(cfg, session.params, slots=P["slots"],
                      max_len=P["max_len"], chunk=P["chunk"],
                      personalise=pol)
    eng.run([Request(uid=-1, prompt=np.arange(8, dtype=np.int32),
                     max_new=2)])
    pers = Personaliser(session, eng, pol, profile=profile,
                        iters=P["iters"], seq=P["seq"])
    rng = np.random.default_rng(0)
    reqs = [Request(uid=i % P["users"], prompt=rng.integers(
        0, cfg.vocab, size=int(rng.integers(4, 24))).astype(np.int32),
        max_new=P["max_new"]) for i in range(P["requests"])]
    leaves = tree_leaves(session.backbone.init_deltas(pol, dev))
    leaves_per_user = len(leaves)
    largest = max(t.numel() for t in leaves)
    if largest != GQ_LEAF[0] * GQ_LEAF[1]:
        fail(f"phase 10's largest delta leaf has {largest} elements; "
             f"grad_quant was timed at {GQ_LEAF}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.grad_quant.launches = ops.flash_attention_cached.launches = 0
    t0 = time.perf_counter()
    online = pers.run_online(reqs)
    torch.cuda.synchronize()
    pers_wall = time.perf_counter() - t0
    gq_launches = ops.grad_quant.launches
    pers_flash_launches = ops.flash_attention_cached.launches
    pers_peak = torch.cuda.max_memory_allocated()
    mem = eng.memory_report()
    refreshes = online["refreshes"]
    refreshed = sum(len(r["users"]) for r in refreshes)
    new_tokens = sum(len(r.out) for r in reqs)
    adapt_s = sum(r["adapt_seconds"] for r in refreshes)
    swap_s = sum(r["swap_seconds"] for r in refreshes)
    print(f"[personalise] qwen2-1.5b bf16 full width, {P['slots']} slots, "
          f"max_len {P['max_len']}, chunk {P['chunk']}, {P['users']} users, "
          f"policy {len(pol.units)} units ({leaves_per_user} delta leaves a "
          f"user, the largest {largest} elements, grad_quant's timing "
          f"shape): {len(reqs)} requests, {new_tokens} new tokens in "
          f"{pers_wall:.3f} s = {new_tokens / pers_wall:.2f} tok/s with "
          f"refreshes (wall less adapt and swap {pers_wall - adapt_s - swap_s:.3f}"
          f" s), "
          f"{online['rounds']} rounds, {online['ticks']} ticks, "
          f"{online['host_syncs']} host syncs; peak device memory "
          f"{pers_peak} B, delta arena {mem['delta_arena_bytes']} B "
          f"({mem['delta_bytes_per_stream']} B a slot; a folded copy "
          f"{mem['params_bytes_folded_copy']} B); grad_quant launches "
          f"{gq_launches}, flash_cached launches {pers_flash_launches}",
          flush=True)
    for r in refreshes:
        print(f"[personalise] refresh {r['round']}: users {r['users']} "
              f"(deferred {r['deferred_users']}), adapt_seconds "
              f"{r['adapt_seconds']:.4f}, swap_seconds {r['swap_seconds']:.6f}"
              f", resident rows swapped {r['resident_rows_swapped']}, wire "
              f"{r['payload_bytes_wire']} B vs f32 {r['payload_bytes_f32']} B"
              f" = {r['payload_ratio']:.4f}x", flush=True)
    all_done(reqs, P["max_new"], "personalise")
    if not refreshes:
        fail("the personalised serve refreshed no user")
    if gq_launches <= 0 or gq_launches != refreshed * leaves_per_user:
        fail(f"grad_quant launched {gq_launches} times for {refreshed} "
             f"refreshed users of {leaves_per_user} leaves each")
    if min(r["payload_ratio"] for r in refreshes) <= 3.9:
        fail(f"payload ratio {[r['payload_ratio'] for r in refreshes]} not "
             "above 3.9")
    if pers_flash_launches <= 0 or pers_flash_launches % nl:
        fail(f"the personalised serve launched flash_cached "
             f"{pers_flash_launches} times")

    print(smi)
    print(json.dumps({"kernels": [{
        "name": "flash_attention_cached",
        "route": "cuda",
        "source": "src/repro_torch/csrc/flash_cached.cu",
        "replaces": "src/repro/kernels/flash_attention.py:92",
        "launches": (launches + int8_launches + adapt_flash_launches
                     + pers_flash_launches),
        **flash,
    }, {
        "name": "flash_attention_paged",
        "route": "cuda",
        "source": "src/repro_torch/csrc/flash_paged.cu",
        "replaces": "src/repro/kernels/flash_attention.py:157",
        "launches": paged_launches + pressure_launches,
        **paged,
    }, {
        "name": "fisher_tapgrads",
        "route": "cuda",
        "source": "src/repro_torch/csrc/fisher.cu",
        "replaces": "src/repro/kernels/fisher.py:66",
        "launches": fisher_launches,
        **fisher,
    }, {
        "name": "grad_quant",
        "route": "cuda",
        "source": "src/repro_torch/csrc/grad_quant.cu",
        "replaces": "src/repro/kernels/grad_quant.py:57",
        "launches": gq_launches,
        **gquant,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
