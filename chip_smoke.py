#!/usr/bin/env python3
"""Smoke test of the PyTorch/H100 port (``src/repro_torch``) on one card.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with an NVIDIA Hopper card
and the CUDA toolkit.  Phases, one line each or more, and any failure
exits non-zero:

1. environment: torch, the card, ``nvidia-smi`` name and power limit;
2. build: every CUDA source of the port with ``nvcc`` for ``sm_90a``, one
   process per source, all started together;
3. kernel parity: each kernel against its plain PyTorch version at the main
   paths' shapes (cached flash: f32 at 1e-4 with TF32 off, bf16 at 3e-2
   and within 3e-2 |want| + min(3e-2, 0.1 rms(want)) element by element,
   over the whole output and slot by slot (rms of each batch row's own
   output, so a long slot's small outputs set its own term), two runs
   bit-equal, and a 4096-row cache; paged flash: the same
   tolerances at page sizes 1, 5 and 16, NaN in every page row no query can
   see, two runs bit-equal, and exactly the cached kernel's output on the
   same rows laid out contiguously, at the 4096-row cache too; the launch
   geometry of both at the main shape, at least 128 CTAs, and their time
   also as launches replayed from a CUDA graph; both again at gemma-2b's
   block prefill (D 256, one kv head: parity, paged equal to cached, each
   timed beside SDPA and a page gather + SDPA); Fisher: f32 at 1e-5, bf16
   inputs at 2e-2, masked rows holding NaN, the tap-gradient launch held
   to its host-side model, and its task axis (T = 1, 3, 4 stacked d_ff
   groups with ragged masks: one launch, each task bit-equal to a
   one-task launch, timed at T = 4 beside ``torch.einsum``); grad_quant: codes, scale and
   residual exactly equal, f32 and bf16 g, a ragged multi-block size, ties,
   zeros and a NaN, on each of its paths (one CTA, on chip, two passes:
   one element either side of the on-chip capacity, two leaves), its one
   launch held to its host-side model, and the tree compressor with no
   host read; SSD scan: the forward kernel against the sequential oracle
   (with the final state and without it, the main path's launch of
   several heads a CTA) and the backward kernel against autograd of the
   plain chunked body, f32 at 1e-4 and bf16 at 2e-2 of max(1, max |want|)
   (the forward at 1e-4 in both), at the mamba2 adapt shape, over five
   tiles with an initial state, and at the chunk of 256, then both launch
   geometries (held to their host-side models) and the backward's time
   split by launch (torch.profiler); aligned flash (kernel 3): f32
   at 1e-4 with TF32 off and bf16 at 3e-2 at the kernel bench's two shapes
   (causal), at qwen2-1.5b's attention width as a long cache-free prefill
   (1, 4096, 12, 2, 128) in bf16, at mixtral-8x7b's sliding window (1,
   8192, 32, 8, 128, window 4096) in bf16, at gemma-2b's (1, 4096, 8, 1,
   256) and stablelm-12b's (1, 4096, 32, 8, 160) prefill widths in bf16,
   without the causal mask, with Sk != Sq both ways, a window smaller than
   a tile and D = 256, and on its TMA + wgmma path (bf16, D 64, 128 and
   160 to 256) a window smaller than its tile and Sq, Sk off multiples of
   128 both ways, f32 (TF32 tensor cores) at the same shapes), then its
   median time beside its bound (f32: three TF32 products at the TF32
   rate, the CUDA cores' bound beside it), the plain version's time and
   one PyTorch library call's time where one computes the same function
   (a yardstick the port never calls), each path's launch geometry (held
   to its host-side model, with ptxas's registers and spills) and the
   wgmma path's time with and without a GQA group sharing K/V;
4. small-input checks on qwen2-smoke in f32, card against the plain path
   on the CPU: the serving engine's greedy streams (contiguous, paged, and
   paged under half the page budget with at least one requeue), and
   TinyTrain's adaptation (the same policy, losses within 1e-4, the same
   streams from the engine with the deltas folded in), and two users'
   deltas served per slot through the personalisation arena (the same
   streams as on the CPU and as each user's folded engine on the card);
   then TinyTrain on mamba2-smoke f32 through the SSD kernels, card
   against the CPU: the same policy of SSD units, losses within 1e-4, the
   same folded streams;
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
   cached flash kernel launched a positive multiple of 28 times;
11. mamba2: the twin of ``launch.serve --arch mamba2-1.3b --preset full
   --adapt`` at mamba2-1.3b's published width and depth in bf16 (48
   layers, d_model 2048, 64 SSD heads of 64, state 128; random weights
   from a seeded generator): ``TinyTrainSession.adapt`` on phase 6's
   episode shape under phase 6's profile (the SSD scan kernels forward
   and backward, the Fisher kernel), ``fold_into`` a ``ServeEngine`` (4
   slots, max_len 96) and 10 requests; finite losses, two host transfers,
   one Fisher launch (one tap group), forward SSD launches a positive
   multiple of 48, backward launches, each backward two device kernels
   (the fused backward and the cluster groups' sum; the forward is not
   re-run), SSD units selected, every request ``done``.

12. kernel bench: ``benchmarks_torch/kernel_bench.py --full`` in this
   process (its record appended to ``build/BENCH_torch_kernels.json``),
   the path that runs kernel 3: every row within its tolerance, every
   field of the record present, the aligned flash kernel launched.
13. quickstart: the twin of ``examples/quickstart.py`` on the edge CNN
   (tiny-cnn at in_res 32, batch 64, a 'glyphs' task of 64 support and 96
   query rows, ``RPI_ZERO``, 30 fused fine-tune steps): the policy, the
   memory report against the budget, fisher and train seconds, accuracy
   before and after; two card runs with bit-equal losses and deltas, two
   host transfers; card against the CPU (``device="cpu"``, the same
   weights) over 4 steps: the same policy, losses within 1e-4, equal
   accuracy (over 30 the gap is printed: the CPU differs from itself at
   another thread count by more than 1e-4 there);
14. the paper's backbones: mcunet, mobilenetv2 and proxylessnas at their
   builders' in_res 84 and batch 64, each adapting one task under
   ``STM32F746.scaled(mem=1.6)`` (20 steps, at least one unit selected,
   card against CPU as in phase 13), then the twin of
   ``examples/ondevice_adaptation.py`` up to its ``mesh=`` part on
   mcunet: four users through ``adapt``, the same users through
   ``adapt_many`` under the first user's policy, a heterogeneous mix of 8
   through bucketed ``adapt_many`` (buckets and groups printed), each
   fleet task held to its own ``adapt`` on the card over 4 steps (losses
   within 1e-4, equal accuracy), and one user's deltas
   folded (the folded copy's features equal the delta forward's within
   1e-5).  The CNN path launches none of the port's kernels (its
   convolutions are cuDNN's, as the JAX package's are XLA's): every launch
   count stays 0 over phases 13 and 14.
15. the paper's baselines and criteria on mcunet at phase 14's shape and
   profile: ``none``, ``fulltrain``, ``lastlayer``, ``tinytl``,
   ``adapterdrop50``, ``sparseupdate`` (its ES policy searched on a
   'gratings' proxy task) through ``TinyTrainSession.baseline``, and the
   criteria ``tinytrain``, ``fisher_only``, ``fisher_mem``,
   ``fisher_compute``, ``random``, ``l2norm``: each once over 20 steps
   (accuracy, train_seconds, peak memory printed), then over 4 steps on
   the card and on the CPU from the same weights: the same policy, losses
   within 1e-4 (for fulltrain, tinytl and adapterdrop50, which train a
   dense tree, the first 2 under Adam and all 4 under SGD at the same lr;
   their first gradient in float64 within 1e-9 of the CPU's, and in
   float32 at most 3x as far from it as the CPU's float32 one, since
   float32 leaves it 5e-4 to 1e-2 off on both devices and Adam's
   sign-like steps carry that into the 3rd and 4th losses; TinyTL's own
   ops alone within 1e-5 of float64; the gaps printed step by step beside
   the CPU at 1 thread against all, and the accuracies); the session's
   params bit-equal after all twelve; no kernel launched.
16. ``adapt_many``'s criterion route (no policy override): 4 qwen2-1.5b
   tasks at phase 6's width, depth, sequence length and profile in 2
   buckets (phase 6's task of 48 support rows, and three 3-way tasks of
   12), probed a shape group at a time
   (the group's rows through one forward and backward, then kernel 1's
   task axis): exactly one Fisher launch per tap group per shape group; each task's scores bit-equal to
   a one-task launch on its tap gradients and within 1e-5 of the plain
   version; each task's policy its own ``adapt``'s, or differing only in
   channels whose scores sit within the bf16 Fisher tolerance of the
   unit's k-th score; then the same route on mcunet with phase 14's four
   users (plain reduction, no launch).

Phases 7 to 9 run right after phase 5, on its weights.  The serves of
phases 5 and 7 to 11 print ``host_syncs`` beside ``chunks`` and fail
unless they are equal (one blocking read a chunk, none inside the tick
loop); phases 5, 7, 8, 10 and 11 run their tick loops under
``torch.cuda.set_sync_debug_mode("error")``, so a hidden sync there fails
the run.  The kernel launch
counts are set to 0 just before each main path (phases 5 to 16) and read
just after.  The last three lines are the card's
``nvidia-smi`` name and power limit, the kernels' JSON record and
``{"ok": true, "device": {...}}``.  Imports nothing of JAX or of the JAX
package.
"""
from __future__ import annotations

import ctypes
import importlib.util
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory
PEAK_OPS = {"float32": 67e12, "bfloat16": 989e12,  # dense, non-TC f32 / TC bf16
            "tf32": 495e12}  # dense TF32 tensor cores

# main-path shapes of the cached flash kernel: qwen2-1.5b block prefill with
# 8 slots, prefill_block 8 and max_len 512
MAIN = dict(B=8, Sq=8, Hq=12, Hkv=2, D=128, Sk=512)
# ragged cursors: an empty cache (kv_len 0), a block past its valid rows
# (q_offset + Sq > kv_len), and a block ending at the last cache row
Q_OFFSET = [0, 0, 37, 100, 255, 300, 504, 128]
KV_LEN = [0, 8, 40, 108, 263, 305, 512, 136]
# a long cache (max_len 4096) for kernels 2 and 4: each CTA of a cluster
# walks up to 8 tiles
LONG = dict(Sk=4096, kv_len=[0, 8, 700, 1500, 2600, 3333, 4000, 4096])
PLAN_KEYS = ("CTAs", "cluster", "threads", "smem_bytes", "registers",
             "stages")
TOL = {"float32": 1e-4, "bfloat16": 3e-2}
# kernels 2, 3 and 4 in bf16: the absolute term is the smaller of 3e-2 and
# 0.1 rms(want).  An attention output's typical value shrinks as 1 / sqrt(
# visible keys) (rms 0.05 at mixtral's window), so 3e-2 alone would pass a
# dropped or unmasked kv tile at long sequences; kernel 3's own error
# beyond 3e-2 |want| is about 0.03 rms(want) at these shapes (bf16 P).
# Kernels 2 and 4 keep their fixed max |err| <= 3e-2 beside it
BF16_RMS_TOL = 0.1
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
# the SSD scan's main-path shape: mamba2-1.3b's cache-free forward over the
# adapt episode (48 rows of 64 tokens, 64 heads of 64, state 128)
SSD = dict(b=48, s=64, h=64, p=64, n=128, chunk=256)
SSD_TOL = {"float32": 1e-4, "bfloat16": 2e-2}  # relative to max |want|
SSD_TILE = 32  # csrc/ssd_scan.cu's tokens per tile
# kernel 3 (aligned flash): (what, B, Sq, Sk, Hq, Hkv, D, causal, window,
# dtypes); the cases of ALIGNED_TIMED are timed, in their first dtype
ALIGNED = [
    ("bench quick", 1, 512, 512, 4, 2, 64, True, 0, ("float32", "bfloat16")),
    ("bench full", 2, 2048, 2048, 8, 2, 128, True, 0,
     ("float32", "bfloat16")),
    ("qwen2-1.5b prefill", 1, 4096, 4096, 12, 2, 128, True, 0,
     ("bfloat16",)),
    ("mixtral-8x7b window", 1, 8192, 8192, 32, 8, 128, True, 4096,
     ("bfloat16",)),
    # the head dims of gemma-2b and paligemma-3b (256) and stablelm-12b
    # (160, padded to 192 on the wgmma path) at a 4096-token prefill
    ("gemma-2b prefill", 1, 4096, 4096, 8, 1, 256, True, 0, ("bfloat16",)),
    ("stablelm-12b prefill", 1, 4096, 4096, 32, 8, 160, True, 0,
     ("bfloat16",)),
    ("not causal", 2, 256, 256, 2, 2, 128, False, 0, ("float32", "bfloat16")),
    ("Sk < Sq", 1, 300, 200, 4, 2, 64, True, 0, ("float32", "bfloat16")),
    ("Sk > Sq, not causal", 1, 150, 333, 4, 2, 64, False, 0,
     ("float32", "bfloat16")),
    ("window 5 < tile", 2, 130, 130, 2, 1, 16, True, 5,
     ("float32", "bfloat16")),
    ("D 256", 1, 96, 90, 2, 2, 256, True, 40, ("float32", "bfloat16")),
    # the TMA + wgmma path (bf16, D 64 and 128) off its main shapes: a
    # window smaller than its 128-row tile, Sq and Sk not multiples of 128
    # either way, rows that see no key
    ("wgmma window 5 < tile", 2, 130, 130, 2, 1, 64, True, 5, ("bfloat16",)),
    ("wgmma Sk < Sq, window 7", 2, 300, 200, 2, 1, 128, True, 7,
     ("bfloat16",)),
    ("wgmma Sk > Sq, not causal", 1, 150, 333, 4, 2, 128, False, 0,
     ("bfloat16",)),
    # ... and past D 128 (64-row kv tiles, padding columns zero-filled by
    # TMA and never stored), with the float32 path at the same shapes
    ("wgmma D 160, Sk < Sq, window 7", 2, 300, 200, 2, 1, 160, True, 7,
     ("bfloat16", "float32")),
    ("wgmma D 192, window 5 < tile", 2, 130, 130, 2, 1, 192, True, 5,
     ("bfloat16", "float32")),
    ("wgmma D 256, Sk > Sq, not causal", 1, 150, 333, 4, 2, 256, False, 0,
     ("bfloat16", "float32")),
]
ALIGNED_TIMED = ("bench quick", "bench full", "qwen2-1.5b prefill",
                 "mixtral-8x7b window", "gemma-2b prefill",
                 "stablelm-12b prefill")
# phase 13: examples/quickstart.py (tiny-cnn, a 'glyphs' task, RPI_ZERO)
QUICKSTART = dict(arch="tiny-cnn", in_res=32, batch_size=64, max_way=8,
                  domain="glyphs", support_pad=64, query_pad=96, iters=30)
# phase 14: the paper's backbones at their builders' resolution, 64 support
# rows a task, and examples/ondevice_adaptation.py's users on mcunet
PAPER = dict(archs=("mcunet", "mobilenetv2", "proxylessnas"), in_res=84,
             batch_size=64, max_way=8, domain="glyphs", support_pad=64,
             query_pad=96, support_total=64, per_class=16, iters=20, mem=1.6)
# phases 13 and 14 hold the card to the CPU, and adapt_many to adapt, over
# 4 fine-tune steps.  Over 20 to 30, Adam on these random-weight backbones
# carries a 1e-7 rounding difference to losses 1e-4 to 1e-3 apart and to
# another query accuracy: so does the CPU against itself at 1 and 8
# threads (benchmarks_torch/adapt_profile.py prints both gaps step by step)
PARITY_ITERS = 4
USERS = (("user-a", "stripes"), ("user-b", "spots"), ("user-c", "waves"),
         ("user-d", "stripes"))
# phase 15: every baseline and criterion of the paper's tables on mcunet at
# phase 14's shape, the ES baseline's proxy task from a source domain
BASELINES = ("none", "fulltrain", "lastlayer", "tinytl", "adapterdrop50",
             "sparseupdate")
CRITERIA = ("tinytrain", "fisher_only", "fisher_mem", "fisher_compute",
            "random", "l2norm")
PROXY_DOMAIN = "gratings"
# the baselines that train a dense tree (the whole backbone, TinyTL's
# adapters) are held to the CPU on their first gradient, over their first
# DENSE_PARITY_LOSSES losses under Adam (one update) and over all
# PARITY_ITERS under SGD at the same lr.  Taken in float64 on both devices,
# the first gradient agrees to GRAD_F64_TOL of each leaf's largest value;
# in float32 it lies 5e-4 to 1e-2 of that from the float64 one on the card
# and on the CPU alike (the backward through mcunet's ReLU6 layers cancels),
# and the card's may lie at most GRAD_F32_FACTOR times as far as the CPU's.
# Adam's first steps move each weight by about lr in the sign of its
# gradient, so the elements whose sign float32 cannot settle part the two
# devices' 3rd and 4th losses; TinyTL's own ops alone, which do not cancel,
# agree with float64 to TINYTL_OP_TOL of their largest value
DENSE_BASELINES = ("fulltrain", "tinytl", "adapterdrop50")
DENSE_PARITY_LOSSES = 2
GRAD_F64_TOL = 1e-9
GRAD_F32_FACTOR = 3.0
TINYTL_OP_TOL = 1e-5
BASELINE_LR = 1e-3  # TinyTrainSession's baseline_lr
# phase 16: adapt_many's criterion route, 4 LM tasks in 2 buckets at
# phase 6's width, depth, sequence length and profile: phase 6's own task
# (48 support rows, bucket 64) and three 3-way 4-shot tasks (12 rows,
# bucket 16).  Two of phase 6's tasks do not fit on an 80 GB card: their
# batched probe alone holds 47 GB above the weights, against 17.7 GB for
# one task's whole adapt, and adapt_many of the two runs out of memory
# (benchmarks_torch/fleet_memory.py)
FLEET_SHOTS = (4, 4, 4)
FLEET_ITERS = 4
# kernel 1's task axis at the adapt's d_ff group, the masks ragged
FISHER_TASKS = (1, 3, 4)
# kernels 2 and 4 at gemma-2b's block prefill (D 256 on their FMA loops):
# timed beside SDPA and a page gather + SDPA, 18 layers' buffers cycled
WIDE_BLOCK = dict(B=8, Sq=8, Hq=8, Hkv=1, D=256, Sk=512, layers=18)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def one_sync_a_chunk(report, what: str) -> None:
    """The JAX engine's contract: one blocking host read a serving chunk."""
    if report["host_syncs"] != report["chunks"]:
        fail(f"{what}: {report['host_syncs']} host syncs for "
             f"{report['chunks']} chunks")


def max_err(got, want, tol: float, what: str, atol=None) -> float:
    """Max abs error of ``got`` against ``want``; fails unless every
    element is finite and within ``atol + tol * |want|`` (atol defaults
    to ``tol``)."""
    import torch

    atol = tol if atol is None else atol
    got, want = got.float(), want.float()
    err = (got - want).abs()
    worst = err.max().item()
    if not (torch.isfinite(got).all().item()
            and (err <= atol + tol * want.abs()).all().item()):
        fail(f"{what}: max abs error {worst} beyond {atol:.3g} + {tol:g} "
             f"|want| (or non-finite)")
    return worst


def rms(t) -> float:
    """Root mean square of ``t``."""
    return t.float().pow(2).mean().sqrt().item()


# the largest err / allowed of kernels 2 and 4's per-slot bf16 gate
GATE_WORST = {"ratio": 0.0, "what": ""}


def bf16_gate(got, want, dname: str, what: str) -> None:
    """Kernels 2 and 4 in bf16: every element within ``3e-2 |want| +
    min(3e-2, 0.1 rms(want))`` over the whole output, and each slot (batch
    row) b within ``3e-2 |want[b]| + min(3e-2, 0.1 rms(want[b]))``: a slot
    with thousands of visible keys has outputs of rms ~0.02, which the
    short slots' rms near 1 would otherwise set the absolute term for
    (float32 keeps its fixed 1e-4)."""
    if dname != "bfloat16":
        return
    tol = TOL[dname]
    max_err(got, want, tol, what, atol=min(tol, BF16_RMS_TOL * rms(want)))
    for b in range(got.shape[0]):
        atol = min(tol, BF16_RMS_TOL * rms(want[b]))
        max_err(got[b], want[b], tol, f"{what}, slot {b}", atol=atol)
        err = (got[b].float() - want[b].float()).abs()
        allowed = atol + tol * want[b].float().abs()
        ratio = (err / allowed.clamp_min(1e-30)).max().item()
        if ratio > GATE_WORST["ratio"]:
            GATE_WORST.update(ratio=ratio, what=f"{what}, slot {b}")


def kernel_launches(ops, zero: bool = False) -> dict:
    """Every launch count of the port's kernel wrappers, by name (set to 0
    first with ``zero``)."""
    counts = {}
    for name, attr in (("flash_attention", "launches"),
                       ("flash_attention_cached", "launches"),
                       ("flash_attention_paged", "launches"),
                       ("fisher", "launches"), ("fisher_tapgrads", "launches"),
                       ("grad_quant", "launches"), ("ssd_scan", "launches"),
                       ("ssd_scan", "bwd_launches")):
        if zero:
            setattr(getattr(ops, name), attr, 0)
        counts[f"{name}.{attr}"] = getattr(getattr(ops, name), attr)
    return counts


def same_adapt(a, b) -> bool:
    """Two adaptations with bit-equal losses and deltas."""
    import torch

    return a.losses == b.losses and all(
        torch.equal(x["conv"]["w"].cpu(), y["conv"]["w"].cpu())
        for x, y in zip(a.deltas.values(), b.deltas.values()))


def adapt_gap(a, b) -> tuple:
    """(max loss difference, max delta difference) of two adaptations of
    one policy structure, wherever their deltas lie."""
    loss = max((abs(x - y) for x, y in zip(a.losses, b.losses)),
               default=0.0)
    delta = max(((x["conv"]["w"].cpu().double() - y["conv"]["w"].cpu()
                  .double()).abs().max().item()
                 for x, y in zip(a.deltas.values(), b.deltas.values())),
                default=0.0)
    return loss, delta


def card_vs_cpu(api, session, task, profile, full, what: str) -> None:
    """An adapt of PARITY_ITERS steps on the card and on the CPU, on
    ``session``'s weights: the same policy, losses within 1e-4 and equal
    query accuracy, or fail.  Then the CPU's run at ``full``'s length,
    whose gap to ``full`` (the card's) is printed, not gated."""
    from repro_torch.utils import tree_map

    cpu = api.TinyTrainSession(session.backbone,
                               tree_map(lambda t: t.cpu(), session.params),
                               max_way=session.max_way)
    card = session.adapt(task, profile, iters=PARITY_ITERS)
    ref = cpu.adapt(task, profile, iters=PARITY_ITERS)
    loss_err, delta_err = adapt_gap(card, ref)
    acc, acc_cpu = card.accuracy(), ref.accuracy()
    same_policy = card.policy.units == ref.policy.units
    long_ref = cpu.adapt(task, profile, iters=len(full.losses))
    long_loss, long_delta = adapt_gap(full, long_ref)
    print(f"[{what}] card vs CPU plain path, {PARITY_ITERS} steps: policy "
          f"{'identical' if same_policy else 'DIFFERENT'}, max loss diff "
          f"{loss_err:.3g} (tol 1e-4), max delta diff {delta_err:.3g}, "
          f"accuracy {acc:.4f} vs {acc_cpu:.4f}; {len(full.losses)} steps "
          f"(not gated): max loss diff {long_loss:.3g}, max delta diff "
          f"{long_delta:.3g}, accuracy {full.accuracy():.4f} vs "
          f"{long_ref.accuracy():.4f}", flush=True)
    if not same_policy:
        fail(f"{what}: policies differ: card {card.policy.describe()}, "
             f"CPU {ref.policy.describe()}")
    if not loss_err <= 1e-4:
        fail(f"{what}: card and CPU losses differ by {loss_err}")
    if acc != acc_cpu:
        fail(f"{what}: card accuracy {acc} against CPU {acc_cpu}")


def launch_plan(lib, entry: str, *args: int) -> dict:
    """The launch a block flash kernel's C entry would make for these
    shapes (``flash_cached_plan``/``flash_paged_plan``), without making it."""
    import ctypes

    fn = getattr(lib, entry)
    fn.argtypes = [ctypes.c_int] * len(args) + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = (ctypes.c_int * len(PLAN_KEYS))()
    err = fn(*args, out)
    if err:
        fail(f"{entry} returned cudaError {err}")
    return dict(zip(PLAN_KEYS, out))


def ptxas_report(log: str, *parts: str, what: str = "registers"):
    """What ptxas reports for the one entry function of ``log`` whose
    mangled name holds every one of ``parts``: its ``registers`` or its
    bytes of ``spill`` stores (None when absent)."""
    pattern = (r"Used (\d+) registers" if what == "registers"
               else r"(\d+) bytes spill stores")
    for block in log.split("Compiling entry function '")[1:]:
        name = block.split("'", 1)[0]
        if all(x in name for x in parts):
            m = re.search(pattern, block)
            return int(m.group(1)) if m else None
    return None


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


def graph_ms(launch, n: int) -> float:
    """Device time per call of ``launch(stream)`` without the host's
    launch cost: ``n`` calls captured in one CUDA graph, replayed."""
    import torch

    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        st = torch.cuda.current_stream().cuda_stream
        for _ in range(n):
            launch(st)
    return time_ms(g.replay, 1) / n


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


def aligned_work(b, sq, sk, hq, hkv, d, causal, window, elt):
    """(bytes, operations) of one aligned attention call: q, k, v read and
    out written once, two multiply-adds per (query, visible key, feature);
    positions from 0 on both axes."""
    pairs = 0
    for i in range(sq):
        hi = min(sk - 1, i) if causal else sk - 1
        lo = max(0, i - window + 1) if window else 0
        pairs += max(0, hi - lo + 1)
    return (elt * (2 * b * sq * hq * d + 2 * b * sk * hkv * d),
            4 * d * hq * b * pairs)


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


def ssd_work(b, s, h, p, n, elt, backward, zero_init=True):
    """(bytes, operations) of one SSD scan call at these dims, with no
    final state asked for: each input read once and each output written
    once (x, B and C of ``elt`` bytes, dt, a, y and the gradients float32,
    dx/dB/dC back in x's dtype), and the multiply-adds of the tile
    algebra on this data (two operations each, tile by tile of 32 tokens;
    the state terms skipped where the state is known to be zero or no
    output needs it).  The forward kernel tiles by 64; the count keeps
    the tile of 32, so the bound stays comparable with earlier designs."""
    bshp, bsh, bsn = b * s * h * p, b * s * h, b * s * n
    tiles = [min(SSD_TILE, s - t0) for t0 in range(0, s, SSD_TILE)]
    pairs = SSD_TILE * (SSD_TILE + 1) // 2
    if not backward:
        nbytes = bshp * elt + 4 * bsh + 4 * h + 2 * bsn * elt + 4 * bshp
        macs = 0
        for t, rows in enumerate(tiles):
            macs += pairs * n + p * rows * (rows + 1) // 2
            macs += (0 if t == 0 and zero_init else rows * n * p)
            macs += SSD_TILE * p * n if t < len(tiles) - 1 else 0
        return nbytes, 2 * macs * b * h
    nbytes = (4 * bshp + bshp * elt + 4 * bsh + 4 * h + 2 * bsn * elt
              + bshp * elt + 4 * bsh + 2 * bsn * elt)
    macs = 0
    for t, rows in enumerate(tiles):
        state_in = not (t == 0 and zero_init)
        ds = t < len(tiles) - 1
        macs += SSD_TILE * p * n if ds else 0                # recompute
        macs += pairs * (n + p)                              # W and dy.u
        macs += pairs * p + (SSD_TILE * p * n if ds else 0)  # du
        macs += pairs * n + (SSD_TILE * p * n if state_in else 0)  # dC
        macs += pairs * n + (SSD_TILE * p * n if ds else 0)  # dB
        macs += SSD_TILE * p * n if t > 0 else 0             # dS
    return nbytes, 2 * macs * b * h + 2 * bsn * h  # + the head sums


def sync(dev) -> None:
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize()


def peak_reset(dev) -> int:
    """Reset the card's peak memory; the bytes allocated at the reset."""
    import torch

    if dev.type != "cuda":
        return 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    return torch.cuda.memory_allocated()


def peak_bytes(dev, base: int = 0) -> int:
    """The card's peak memory since the last reset, less ``base``."""
    import torch

    return (torch.cuda.max_memory_allocated() - base if dev.type == "cuda"
            else 0)


def policy_gap(got, want, chans_got, chans_want, tol: float):
    """Whether two policies of one task agree, under the port's rule for a
    difference of precision: the same units and channel counts, and every
    channel one picks and the other does not scored within ``tol`` (of
    the unit's largest score) of that unit's k-th score, in both score
    sets, which agree within ``tol`` themselves.  Returns (equal, within
    the rule, the largest such distance)."""
    import torch

    if got.units == want.units:
        return True, True, 0.0
    sg = [(u.layer, u.kind, u.n_channels) for u in got.units]
    sw = [(u.layer, u.kind, u.n_channels) for u in want.units]
    if sg != sw or got.horizon != want.horizon:
        return False, False, float("inf")
    worst = 0.0
    for ug, uw in zip(got.units, want.units):
        if ug.channels == uw.channels:
            continue
        swapped = sorted(set(ug.channels) ^ set(uw.channels))
        for sc in (chans_got, chans_want):
            s_ = torch.as_tensor(sc[(ug.layer, ug.kind)]).double()
            top = s_.abs().max().item() or 1.0
            kth = s_.sort(descending=True).values[ug.n_channels - 1].item()
            worst = max(worst, max(abs(s_[c].item() - kth)
                                   for c in swapped) / top)
        a = torch.as_tensor(chans_got[(ug.layer, ug.kind)]).double()
        b = torch.as_tensor(chans_want[(ug.layer, ug.kind)]).double()
        worst = max(worst, ((a - b).abs().max() / b.abs().max()).item())
    return False, worst <= tol, worst


def paper_baselines(api, dev, pp, pprofile, methods, iters, parity_iters):
    """Phase 15: each of ``methods`` (a ``baseline`` name or a criterion)
    once on ``dev`` at ``iters`` steps (accuracy, train_seconds, peak
    memory printed), then at ``parity_iters`` steps on ``dev`` and on the
    CPU from the same weights: the same policy (the ES policy too) and
    losses within 1e-4 (a dense baseline's first ``DENSE_PARITY_LOSSES``,
    and all of them again under SGD at the same lr; its first gradient
    through :func:`gradient_gate`, and TinyTL's ops through
    :func:`tinytl_op_gate`); the session's frozen
    params unchanged bit for bit.  The CPU at one
    thread against the CPU at all its threads, step by step, is printed
    beside it: the same code in another reduction order, the noise floor.
    The accuracies are printed, not gated: fulltrain's first Adam steps
    move every weight of the backbone by about lr in the sign of its
    gradient, so a query near a tie may flip (one of 96 on mcunet over 4
    steps).  Returns {method: the ``dev`` run}."""
    import numpy as np
    import torch

    from repro_torch.optim import sgd
    from repro_torch.utils import tree_leaves, tree_map

    bb = api.backbone(pp["arch"], in_res=pp["in_res"],
                      batch_size=pp["batch_size"])
    session = api.TinyTrainSession(bb, max_way=pp["max_way"], seed=0,
                                   device=dev)
    frozen = [t.clone() for t in tree_leaves(session.params)]
    cpu = api.TinyTrainSession(bb, tree_map(lambda t: t.cpu(),
                                            session.params),
                               max_way=pp["max_way"])

    def task_of(seed, domain):
        return api.sample_task(
            np.random.default_rng(seed), domain, res=pp["in_res"],
            max_way=pp["max_way"], support_pad=pp["support_pad"],
            query_pad=pp["query_pad"],
            max_support_total=pp["support_total"],
            max_support_per_class=pp["per_class"])

    task, proxy = task_of(0, pp["domain"]), task_of(1, PROXY_DOMAIN)
    if "tinytl" in methods:
        tinytl_op_gate(bb, dev, pp["support_pad"])
    out = {}
    for name in methods:
        base = peak_reset(dev)
        t0 = time.perf_counter()
        a = session.baseline(name, task, pprofile, iters=iters,
                             proxy_task=proxy)
        sync(dev)
        wall = time.perf_counter() - t0
        peak = peak_bytes(dev, base)
        card = session.baseline(name, task, pprofile, iters=parity_iters,
                                proxy_task=proxy)
        ref = cpu.baseline(name, task, pprofile, iters=parity_iters,
                           proxy_task=proxy)
        threads = torch.get_num_threads()
        torch.set_num_threads(1)
        ref1 = cpu.baseline(name, task, pprofile, iters=parity_iters,
                            proxy_task=proxy)
        torch.set_num_threads(threads)
        steps = [abs(x - y) for x, y in zip(card.losses, ref.losses)]
        floor = [abs(x - y) for x, y in zip(ref1.losses, ref.losses)]
        n_gate = (DENSE_PARITY_LOSSES if name in DENSE_BASELINES
                  else parity_iters)
        gap = max(steps[:n_gate], default=0.0)
        same = ((card.policy is None and ref.policy is None)
                or card.policy.units == ref.policy.units)
        acc, acc_ref = card.accuracy(), ref.accuracy()
        pol = a.policy.describe() if a.policy is not None else "none"
        print(f"[baselines] {pp['arch']} {name}: accuracy {a.accuracy():.4f}"
              f", fisher_seconds {a.fisher_seconds:.4f}, train_seconds "
              f"{a.train_seconds:.4f} ({len(a.losses)} steps), wall "
              f"{wall:.4f} s, peak {peak} B over the allocation before, host "
              f"transfers "
              f"{a.host_transfers:g}, policy {pol}; {parity_iters} steps "
              f"against the CPU: policy "
              f"{'identical' if same else 'DIFFERENT'}, loss diff by step "
              f"{[float(f'{x:.3g}') for x in steps]} (tol 1e-4 over the "
              f"first {n_gate}), the CPU at 1 thread against {threads} "
              f"{[float(f'{x:.3g}') for x in floor]}, accuracy {acc:.4f} vs "
              f"{acc_ref:.4f}", flush=True)
        if not all(math.isfinite(x) for x in a.losses):
            fail(f"{name}: losses must be finite: {a.losses}")
        if name != "none" and len(a.losses) != iters:
            fail(f"{name}: {len(a.losses)} losses for {iters} steps")
        if a.policy is not None and a.policy.n_units < 1:
            fail(f"{name}: the policy selects no unit")
        if not same:
            fail(f"{name}: policies differ: {card.policy.describe()} "
                 f"against the CPU's {ref.policy.describe()}")
        if not gap <= 1e-4:
            fail(f"{name}: losses differ from the CPU's by {gap} over the "
                 f"first {n_gate}")
        if name in DENSE_BASELINES:
            gradient_gate(bb, cpu.params, task, name, pp["max_way"], dev)
            # the same training loop with a linear update, card and CPU
            sgd_runs = []
            for params in (session.params, cpu.params):
                s_ = api.TinyTrainSession(bb, params, max_way=pp["max_way"])
                s_.baseline_optimizer = sgd(BASELINE_LR)
                sgd_runs.append(s_.baseline(name, task, pprofile,
                                            iters=parity_iters).losses)
            sgd_gap = max(abs(x - y) for x, y in zip(*sgd_runs))
            print(f"[baselines] {pp['arch']} {name} under SGD (lr "
                  f"{BASELINE_LR:g}), {parity_iters} steps against the CPU: "
                  f"max loss diff {sgd_gap:.3g} (tol 1e-4)", flush=True)
            if not sgd_gap <= 1e-4:
                fail(f"{name} under SGD: losses differ from the CPU's by "
                     f"{sgd_gap}")
        out[name] = a
    unchanged = all(torch.equal(x, y) for x, y in
                    zip(tree_leaves(session.params), frozen))
    print(f"[baselines] the session's frozen params after every method: "
          f"{'bit-equal' if unchanged else 'CHANGED'}", flush=True)
    if not unchanged:
        fail("a baseline changed the session's frozen params")
    return out


def first_gradient(bb, params, task, name, max_way, dev, dtype) -> list:
    """The gradient of dense baseline ``name``'s first loss (fulltrain:
    every backbone leaf; tinytl/adapterdrop: the adapters, drawn as the
    session draws them) from ``params``, on ``dev`` in ``dtype``: its
    leaves in float64 on the CPU."""
    import torch

    from repro_torch.core import baselines as B
    from repro_torch.core.protonet import episode_loss
    from repro_torch.utils import tree_leaves, tree_map

    def on(tree):
        ts = {k: torch.as_tensor(v, device=dev) for k, v in tree.items()}
        return {k: t.to(dtype) if t.is_floating_point() else t
                for k, t in ts.items()}

    p = tree_map(lambda t: t.detach().to(dev, dtype), params)
    if name == "fulltrain":
        x, feats = p, bb.features
    else:
        drop = B.adapter_dropped_blocks(bb.cfg, name)
        x = tree_map(lambda t: t.to(dev, dtype), B.tinytl_adapter_init(
            bb.cfg, torch.Generator().manual_seed(0)))

        def feats(a, b):
            return B.tinytl_features(bb.cfg, p, a, b["images"],
                                     dropped_blocks=drop)
    leaves = [t.requires_grad_() for t in tree_leaves(x)]
    loss = episode_loss(feats, x, on(task.support), on(task.pseudo_query),
                        max_way)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return [(torch.zeros_like(t) if g is None else g).cpu().double()
            for t, g in zip(leaves, grads)]


def gradient_gate(bb, params, task, name, max_way, dev) -> None:
    """Dense baseline ``name``'s first gradient on ``dev`` against the
    CPU's: in float64 within GRAD_F64_TOL of each leaf's largest value,
    and in float32 no farther from the float64 gradient than
    GRAD_F32_FACTOR times the CPU's float32 one, or fail."""
    import torch

    cpu = torch.device("cpu")
    exact = first_gradient(bb, params, task, name, max_way, cpu,
                           torch.float64)

    def dist(dev_, dtype):
        got = first_gradient(bb, params, task, name, max_way, dev_, dtype)
        return max((a - b).abs().max().item() / (b.abs().max().item() or 1.0)
                   for a, b in zip(got, exact))

    e64, e_card, e_cpu = (dist(dev, torch.float64), dist(dev, torch.float32),
                          dist(cpu, torch.float32))
    print(f"[baselines] {name} first gradient ({len(exact)} leaves, "
          f"{sum(t.numel() for t in exact)} elements), the largest distance "
          f"from the CPU's float64 one, of its leaf's largest value: card "
          f"float64 {e64:.3g} (tol {GRAD_F64_TOL:g}); float32 card "
          f"{e_card:.3g}, CPU {e_cpu:.3g} (the card's at most "
          f"{GRAD_F32_FACTOR:g}x the CPU's)", flush=True)
    if not e64 <= GRAD_F64_TOL:
        fail(f"{name}: the card's float64 first gradient is {e64} off")
    if not e_card <= GRAD_F32_FACTOR * e_cpu:
        fail(f"{name}: the card's float32 first gradient is {e_card} off "
             f"the float64 one, the CPU's {e_cpu}")


def tinytl_op_gate(bb, dev, rows: int) -> None:
    """TinyTL's own ops alone at each block's shapes on ``dev`` in float32
    against the CPU in float64: the "SAME" 2x2 pool, the 3x3 and pointwise
    adapter convs and the nearest-exact resize, each op's value and the
    gradients of all its inputs under a random cotangent within
    TINYTL_OP_TOL of their largest value, or fail."""
    import torch
    import torch.nn.functional as F

    from repro_torch.core.baselines import _pool_same, tinytl_blocks

    cfg = bb.cfg
    size, start, end = cfg.in_res, {}, {}
    for spec in cfg.layers:
        start.setdefault(spec.block, size)
        size = -(-size // spec.stride)
        end[spec.block] = size
    gen = torch.Generator().manual_seed(15)
    worst, cases = 0.0, set()
    for b, cin, r, cout in tinytl_blocks(cfg):
        s0, s1 = start[b], end[b]
        sp = -(-s0 // 2)
        for op, shapes, fn in (
                ("pool", [(rows, cin, s0, s0)], _pool_same),
                ("conv3x3", [(rows, cin, sp, sp), (r, cin, 3, 3)],
                 lambda h, w: F.conv2d(h, w, padding=1)),
                ("conv1x1", [(rows, r, sp, sp), (cout, r, 1, 1)], F.conv2d),
                ("resize", [(rows, cout, sp, sp)],
                 lambda h: F.interpolate(h, size=(s1, s1),
                                         mode="nearest-exact"))):
            key = (op, *shapes)
            if key in cases:
                continue
            cases.add(key)
            xs = [torch.randn(sh, generator=gen, dtype=torch.float64)
                  for sh in shapes]
            runs = []
            for d, dt in ((dev, torch.float32), ("cpu", torch.float64)):
                ins = [x.to(d, dt).requires_grad_() for x in xs]
                y = fn(*ins)
                cot = torch.randn(y.shape, generator=torch.Generator()
                                  .manual_seed(len(cases)),
                                  dtype=torch.float64).to(d, dt)
                grads = torch.autograd.grad(y, ins, cot)
                runs.append([t.detach().cpu().double() for t in (y, *grads)])
            for got, want in zip(*runs):
                err = ((got - want).abs().max().item()
                       / (want.abs().max().item() or 1.0))
                worst = max(worst, err)
                if not err <= TINYTL_OP_TOL:
                    fail(f"TinyTL's {op} at {shapes}: {err} of the largest "
                         f"value off float64")
    print(f"[baselines] TinyTL's ops alone ({len(cases)} cases: pool, 3x3 and "
          f"pointwise adapter convs, nearest-exact resize at every block's "
          f"shapes, {rows} rows), card float32 against CPU float64, values "
          f"and input gradients: the largest error {worst:.3g} of the "
          f"largest value (tol {TINYTL_OP_TOL:g})", flush=True)


def fleet_probe(api, ops, session, tasks, profile, iters, tol, what):
    """Phase 16: ``adapt_many`` of ``tasks`` with no policy override (the
    criterion route: a batched probe a shape group) on ``session``; returns
    (fleet, wall, launches of the task-axis reduction, the captured (tap
    gradients, ns, mask, scores) of each reduction).  Each task's policy is
    held to its own ``adapt``'s under ``policy_gap``'s rule at ``tol``."""
    import torch

    bb = session.backbone
    captured = []
    real = bb.fisher_reduce_batch

    def capture(tg, ns, mask=None):
        out = real(tg, ns, mask)
        captured.append((tg, ns, mask, out))
        return out

    bb.fisher_reduce_batch = capture
    try:
        for name in ("fisher_tapgrads", "fisher"):
            getattr(ops, name).launches = 0
        peak_reset(session.device)
        t0 = time.perf_counter()
        fleet = session.adapt_many(tasks, profile, iters=iters)
        sync(session.device)
        wall = time.perf_counter() - t0
        counts = ops.fisher_tapgrads.launches + ops.fisher.launches
        peak = peak_bytes(session.device)
    finally:
        bb.fisher_reduce_batch = real
    rep = session.last_fleet_report
    print(f"[fleet] {what}: adapt_many of {len(tasks)} tasks, no override: "
          f"{rep['buckets']} buckets, {rep['groups']} fine-tune groups, "
          f"wall {wall:.4f} s, probe (fisher_seconds a task) "
          f"{', '.join(f'{a.fisher_seconds:.4f}' for a in fleet)}, "
          f"train_seconds a task {fleet[0].train_seconds:.4f} ({iters} "
          f"steps), peak {peak} B, Fisher launches {counts}, host transfers "
          f"{sum(a.host_transfers for a in fleet):g}", flush=True)
    groups = _fleet_groups(session, tasks)
    for i, (t, f) in enumerate(zip(tasks, fleet)):
        labels = torch.as_tensor(t.support["episode_labels"],
                                 device=session.device)
        taps = bb.make_taps(labels.shape[0], session.device)
        sup = {k: torch.as_tensor(v, device=session.device)
               for k, v in t.support.items()}
        pq = {k: torch.as_tensor(v, device=session.device)
              for k, v in t.pseudo_query.items()}
        own_chans = session.step_cache.probe_fisher()(
            session.params, sup, pq, taps, float(t.n_support))
        one = session.adapt(t, profile, iters=1)
        j = next(j for j, idxs in enumerate(groups) if i in idxs)
        k = groups[j].index(i)
        fleet_chans = {key: v[k] for key, v in captured[j][3].items()}
        equal, ok, worst = policy_gap(f.policy, one.policy, fleet_chans,
                                      own_chans, tol)
        print(f"[fleet] {what} task {i} ({t.n_support} support rows of "
              f"{labels.shape[0]}): {f.policy.describe()}; its own adapt's "
              f"policy {'identical' if equal else 'differs'}"
              + ("" if equal else f" (largest swapped-channel distance "
                 f"{worst:.3g} of the unit's top score, rule {tol:g}: "
                 f"{'a difference of precision' if ok else 'A FAULT'})"),
              flush=True)
        if not ok:
            fail(f"{what} task {i}: adapt_many's policy "
                 f"{f.policy.describe()} against its own adapt's "
                 f"{one.policy.describe()}")
        if not all(math.isfinite(x) for x in f.losses):
            fail(f"{what} task {i}: losses must be finite: {f.losses}")
    return fleet, wall, counts, captured


def _fleet_groups(session, tasks):
    """The probe's shape groups of ``tasks`` (input indices), in the order
    ``adapt_many`` probes them."""
    from repro_torch.core.session import (
        _bucket_episode, _episode_shape_key, _group_indices,
    )

    keys = [_episode_shape_key(*_bucket_episode(t)) for t in tasks]
    return list(_group_indices(keys).values())


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
    from repro_torch.kernels import (
        build, flash_aligned, flash_attention, flash_paged, ops,
    )
    from repro_torch.kernels import fisher as fisher_kernel
    from repro_torch.kernels import grad_quant as gq_kernel
    from repro_torch.kernels import ssd_scan as ssd_kernel
    from repro_torch.kernels.ref import (
        fisher_ref, fisher_tapgrads_ref, flash_attention_cached_ref,
        flash_attention_paged_ref, flash_attention_ref, grad_quant_ref,
        ssd_scan_ref,
    )
    from repro_torch.core.policy import SelectedUnit, SparseUpdatePolicy
    from repro_torch.models import ssm
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
            again = ops.flash_attention_cached(q, k, v, q_offset=qo,
                                               kv_len=kl, causal=True,
                                               window=window)
            want = flash_attention_cached_ref(q, k, v, q_offset=qo, kv_len=kl,
                                              causal=True, window=window)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            zero_row = got[0].float().abs().max().item()
            print(f"[parity] flash_cached {dname} window={window}: max abs "
                  f"err {err:.3g} (tol {TOL[dname]:g}); kv_len=0 row max "
                  f"{zero_row:g}; a second run "
                  f"{'bit-equal' if torch.equal(got, again) else 'DIFFERS'}",
                  flush=True)
            if not math.isfinite(err) or err > TOL[dname]:
                fail(f"flash_cached {dname} window={window} error {err}")
            bf16_gate(got, want, dname, f"flash_cached window={window}")
            if zero_row != 0.0:
                fail("a kv_len = 0 row must give 0")
            if not torch.equal(got, again):
                fail(f"flash_cached {dname} window={window}: two runs on the "
                     "same inputs differ")
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

    def run_kernel(st=stream):
        k, v = layer()
        err = entry(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                    qo.data_ptr(), kl.data_ptr(), B, Sq, Sk, Hq, Hkv, D, 1, 0,
                    1, st)
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
    device_ms = graph_ms(run_kernel, 4 * nl)
    plain_ms = time_ms(run_plain, nl)
    library_ms = time_ms(run_library, 4 * nl)
    nbytes, nops = flash_work(Q_OFFSET, KV_LEN, Sq, Hq, Hkv, D, 2, 0)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, nops / PEAK_OPS["bfloat16"]
    bound_ms = 1e3 * max(t_bytes, t_ops)
    bound_by = "bytes" if t_bytes >= t_ops else "operations"
    print(f"[time] flash_cached bf16 B={B} Sq={Sq} Hq={Hq} Hkv={Hkv} D={D} "
          f"Sk={Sk}: kernel {ms:.4f} ms ({device_ms:.4f} ms a launch in a "
          f"CUDA graph), bound {bound_ms:.5f} ms ({bound_by}: "
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
            again = ops.flash_attention_paged(q, kp, vp, table, q_offset=qo,
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
                  f"{'output unchanged' if torch.equal(poisoned, got) else 'OUTPUT CHANGED'}"
                  f"; a second run "
                  f"{'bit-equal' if torch.equal(got, again) else 'DIFFERS'}",
                  flush=True)
            if not math.isfinite(err) or err > TOL[dname]:
                fail(f"flash_paged {dname} page_size={ps} error {err}")
            bf16_gate(got, want, dname, f"flash_paged page_size={ps}")
            if not torch.equal(got, cached):
                fail(f"flash_paged {dname} page_size={ps} differs from "
                     f"flash_cached on the same rows by {vs_cached}")
            if zero_row != 0.0:
                fail("a kv_len = 0 row must give 0")
            if not torch.equal(poisoned, got):
                fail(f"flash_paged {dname} page_size={ps}: a NaN in a row no "
                     "query can see reached the output")
            if not torch.equal(got, again):
                fail(f"flash_paged {dname} page_size={ps}: two runs on the "
                     "same inputs differ")
            p_worst = max(p_worst, err)

    # a 4096-row cache: both kernels against their plain versions, and the
    # paged one (pages of 16) equal to the cached one on the same rows
    long_sk, long_kl = LONG["Sk"], LONG["kv_len"]
    long_qo = [max(0, n - Sq) for n in long_kl]
    lqo = torch.tensor(long_qo, dtype=torch.int32, device=dev)
    lkl = torch.tensor(long_kl, dtype=torch.int32, device=dev)
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[-1]
        q = torch.randn((B, Sq, Hq, D), generator=gen, device=dev).to(dtype)
        k = torch.randn((B, long_sk, Hkv, D), generator=gen,
                        device=dev).to(dtype)
        v = torch.randn((B, long_sk, Hkv, D), generator=gen,
                        device=dev).to(dtype)
        mp = long_sk // PAGE_SIZE
        n_pages = sum(-(-n // PAGE_SIZE) for n in long_kl) + 7
        table = page_table(long_kl, PAGE_SIZE, mp, n_pages, gen, dev)
        shape = (n_pages, PAGE_SIZE, Hkv, D)
        kp = fill_pages(torch.zeros(shape, device=dev, dtype=dtype), k, table,
                        long_kl)
        vp = fill_pages(torch.zeros(shape, device=dev, dtype=dtype), v, table,
                        long_kl)
        got = ops.flash_attention_cached(q, k, v, q_offset=lqo, kv_len=lkl)
        want = flash_attention_cached_ref(q, k, v, q_offset=lqo, kv_len=lkl)
        pgot = ops.flash_attention_paged(q, kp, vp, table, q_offset=lqo,
                                         kv_len=lkl)
        pwant = flash_attention_paged_ref(q, kp, vp, table, q_offset=lqo,
                                          kv_len=lkl)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        perr = (pgot.float() - pwant.float()).abs().max().item()
        print(f"[parity] 4096-row cache, {dname}: flash_cached max abs err "
              f"{err:.3g}, flash_paged (pages of {PAGE_SIZE}) {perr:.3g} "
              f"(tol {TOL[dname]:g}); paged "
              f"{'equal to' if torch.equal(pgot, got) else 'DIFFERS FROM'} "
              f"cached", flush=True)
        for what, e in (("flash_cached", err), ("flash_paged", perr)):
            if not math.isfinite(e) or e > TOL[dname]:
                fail(f"{what} {dname} error {e} on a 4096-row cache")
        bf16_gate(got, want, dname, "flash_cached on a 4096-row cache")
        bf16_gate(pgot, pwant, dname, "flash_paged on a 4096-row cache")
        if not torch.equal(pgot, got):
            fail(f"flash_paged {dname} differs from flash_cached on a "
                 "4096-row cache")
        if got[0].abs().max().item() != 0.0:
            fail("a kv_len = 0 row must give 0")
        worst, p_worst = max(worst, err), max(p_worst, perr)
    del k, v, kp, vp

    # the launch each kernel makes at the main shape (bf16)
    for what, lib, entry, args in (
            ("flash_cached", "flash_cached", "flash_cached_plan",
             (B, Sq, Sk, Hq, Hkv, D, 1)),
            ("flash_paged", "flash_paged", "flash_paged_plan",
             (B, Sq, Hq, Hkv, D, DEFAULT_PAGES, PAGE_SIZE, Sk // PAGE_SIZE,
              1))):
        plan = launch_plan(build.load(lib), entry, *args)
        rows = "ContigRows" if lib == "flash_cached" else "PagedRows"
        ptx = ptxas_report(build.BUILD_LOG.get(lib, (0, ""))[1],
                              "flash_block_kernel", "13__nv_bfloat16",
                              f"Li{D}E", "Lb1E", rows)
        print(f"[geometry] {what} bf16 B={B} Sq={Sq} Hq={Hq} Hkv={Hkv} D={D} "
              f"{'Sk=' + str(Sk) if rows == 'ContigRows' else f'pages of {PAGE_SIZE}'}: "
              f"{plan['CTAs']} CTAs in clusters of {plan['cluster']}, "
              f"{plan['threads']} threads, {plan['smem_bytes']} B of dynamic "
              f"shared memory, {plan['stages']} stages, {plan['registers']} "
              f"registers a thread (ptxas log: "
              f"{'not in this build' if ptx is None else ptx})", flush=True)
        if plan["CTAs"] < 128:
            fail(f"{what} spans {plan['CTAs']} CTAs at the main shape, "
                 "fewer than 128")

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

    def run_paged(st=stream):
        kp, vp = pages()
        err = p_entry(q.data_ptr(), kp.data_ptr(), vp.data_ptr(),
                      out.data_ptr(), table.data_ptr(), qo.data_ptr(),
                      kl.data_ptr(), B, Sq, Hq, Hkv, D, DEFAULT_PAGES,
                      PAGE_SIZE, mp, 1, st)
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
    p_device_ms = graph_ms(run_paged, 4 * nl)
    p_plain_ms = time_ms(run_paged_plain, nl)
    p_library_ms = time_ms(run_paged_library, 4 * nl)
    nbytes, nops = flash_work(Q_OFFSET, KV_LEN, Sq, Hq, Hkv, D, 2, 0)
    nbytes += table.numel() * 4
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, nops / PEAK_OPS["bfloat16"]
    p_bound_ms = 1e3 * max(t_bytes, t_ops)
    p_bound_by = "bytes" if t_bytes >= t_ops else "operations"
    print(f"[time] flash_paged bf16 B={B} Sq={Sq} Hq={Hq} Hkv={Hkv} D={D} "
          f"page_size={PAGE_SIZE} table {B}x{mp} over {DEFAULT_PAGES} pages: "
          f"kernel {p_ms:.4f} ms ({p_device_ms:.4f} ms a launch in a CUDA "
          f"graph), bound {p_bound_ms:.5f} ms ({p_bound_by}: "
          f"{nbytes} B, {nops} ops), plain {p_plain_ms:.4f} ms, page gather "
          f"+ sdpa {p_library_ms:.4f} ms", flush=True)
    paged = {"ms": p_ms, "plain_ms": p_plain_ms, "library_ms": p_library_ms,
             "bound_ms": p_bound_ms, "bound_by": p_bound_by,
             "max_abs_err": p_worst}
    del kps, vps

    # kernels 2 and 4 at gemma-2b's block prefill (D 256, one kv head: the
    # FMA loops of flash_block.cuh): parity, then each beside SDPA and a
    # page gather + SDPA, one buffer set a layer cycled past the L2
    wb, wsq, whq, whkv, wd, wsk, wl = (WIDE_BLOCK[x] for x in (
        "B", "Sq", "Hq", "Hkv", "D", "Sk", "layers"))
    bf = torch.bfloat16
    wq = torch.randn((wb, wsq, whq, wd), generator=gen, device=dev).to(bf)
    wks = torch.randn((wl, wb, wsk, whkv, wd), generator=gen,
                      device=dev).to(bf)
    wvs = torch.randn((wl, wb, wsk, whkv, wd), generator=gen,
                      device=dev).to(bf)
    wmp = wsk // PAGE_SIZE
    wtable = page_table(KV_LEN, PAGE_SIZE, wmp, DEFAULT_PAGES, gen, dev)
    wkps = torch.zeros((wl, DEFAULT_PAGES, PAGE_SIZE, whkv, wd), device=dev,
                       dtype=bf)
    wvps = torch.zeros_like(wkps)
    for i in range(wl):
        fill_pages(wkps[i], wks[i], wtable, KV_LEN)
        fill_pages(wvps[i], wvs[i], wtable, KV_LEN)
    wgot = ops.flash_attention_cached(wq, wks[0], wvs[0], q_offset=qo,
                                      kv_len=kl)
    wwant = flash_attention_cached_ref(wq, wks[0], wvs[0], q_offset=qo,
                                       kv_len=kl)
    wpgot = ops.flash_attention_paged(wq, wkps[0], wvps[0], wtable,
                                      q_offset=qo, kv_len=kl)
    torch.cuda.synchronize()
    w_err = (wgot.float() - wwant.float()).abs().max().item()
    if not w_err <= TOL["bfloat16"]:
        fail(f"flash_cached at D 256: max abs error {w_err}")
    bf16_gate(wgot, wwant, "bfloat16", "flash_cached at D 256")
    if not torch.equal(wpgot, wgot):
        fail("flash_paged differs from flash_cached at gemma-2b's block "
             "prefill")
    wout = torch.empty_like(wq)
    c_entry = flash_attention._entry()
    it["i"] = 0

    def wide_layer():
        i = it["i"] = (it["i"] + 1) % wl
        return i

    def run_wide_cached():
        i = wide_layer()
        rc = c_entry(wq.data_ptr(), wks[i].data_ptr(), wvs[i].data_ptr(),
                   wout.data_ptr(), qo.data_ptr(), kl.data_ptr(), wb, wsq,
                   wsk, whq, whkv, wd, 1, 0, 1, stream)
        if rc:
            fail(f"flash_cached_fwd returned cudaError {rc}")

    def run_wide_paged():
        i = wide_layer()
        rc = p_entry(wq.data_ptr(), wkps[i].data_ptr(), wvps[i].data_ptr(),
                     wout.data_ptr(), wtable.data_ptr(), qo.data_ptr(),
                     kl.data_ptr(), wb, wsq, whq, whkv, wd, DEFAULT_PAGES,
                     PAGE_SIZE, wmp, 1, stream)
        if rc:
            fail(f"flash_paged_fwd returned cudaError {rc}")

    wqt = wq.transpose(1, 2)
    wrows_ok = (wtable >= 0).repeat_interleave(PAGE_SIZE, dim=1)
    widx = wtable.long().clamp(min=0)

    def run_wide_sdpa():
        i = wide_layer()
        F.scaled_dot_product_attention(wqt, wks[i].transpose(1, 2),
                                       wvs[i].transpose(1, 2),
                                       attn_mask=mask, enable_gqa=True)

    def run_wide_gather_sdpa():
        i = wide_layer()
        kk = wkps[i][widx].reshape(wb, wsk, whkv, wd).transpose(1, 2)
        vv = wvps[i][widx].reshape(wb, wsk, whkv, wd).transpose(1, 2)
        F.scaled_dot_product_attention(
            wqt, kk, vv, attn_mask=mask & wrows_ok[:, None, None],
            enable_gqa=True)

    nbytes, nops = flash_work(Q_OFFSET, KV_LEN, wsq, whq, whkv, wd, 2, 0)
    for what, run, lib, extra in (
            ("flash_cached", run_wide_cached, run_wide_sdpa, 0),
            ("flash_paged", run_wide_paged, run_wide_gather_sdpa,
             4 * wtable.numel())):
        k_ms = time_ms(run, 4 * wl)
        l_ms = time_ms(lib, 4 * wl)
        t_bytes = (nbytes + extra) / HBM_BYTES_PER_S
        t_ops = nops / PEAK_OPS["bfloat16"]
        print(f"[time] {what} bf16 gemma-2b block prefill B={wb} Sq={wsq} "
              f"Hq={whq} Hkv={whkv} D={wd} max_len={wsk}: kernel "
              f"{k_ms:.4f} ms, bound {1e3 * max(t_bytes, t_ops):.5f} ms "
              f"({'bytes' if t_bytes >= t_ops else 'operations'}), "
              f"{'sdpa' if what == 'flash_cached' else 'page gather + sdpa'} "
              f"{l_ms:.4f} ms; max abs err {w_err:.3g}, paged equal to "
              f"cached", flush=True)
    del wks, wvs, wkps, wvps
    print(f"[gate] kernels 2 and 4, bf16, per slot: every slot within 3e-2 "
          f"|want| + min(3e-2, 0.1 rms(want[slot])); the largest err / "
          f"allowed {GATE_WORST['ratio']:.4f} ({GATE_WORST['what']})",
          flush=True)

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
    f_entry = fisher_kernel._tap_entry()
    scale = 1.0 / (2.0 * n_valid)
    n_one = torch.full((1,), float(n_valid), device=dev)
    it["i"] = 0

    def next_g():
        i = it["i"] = (it["i"] + 1) % len(gs)
        return gs[i]

    def run_fisher():
        err = f_entry(next_g().data_ptr(), row_mask.data_ptr(),
                      n_one.data_ptr(), out.data_ptr(), 1, shape[0],
                      shape[1], shape[2], 0, stream, None)
        if err:
            fail(f"fisher_tapgrads_fwd returned cudaError {err}")

    def run_fisher_plain():
        fisher_tapgrads_ref(next_g(), n_valid, row_mask)

    def run_fisher_library():
        g = next_g()
        torch.einsum("lbc,lbc,b->lc", g, g, row_mask).mul_(scale)

    f_ms = time_ms(run_fisher, 100)
    f_plain_ms = time_ms(run_fisher_plain, 20)
    f_library_ms = time_ms(run_fisher_library, 50)
    cells = shape[0] * shape[2]
    # valid rows, mask, count, out
    f_bytes = 4 * (n_valid * cells + n_rows + 1 + cells)
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
    # the launch at the main shape, held to the host-side model: 16-byte
    # loads, every block resident at once (one wave)
    f_plan = fisher_kernel.plan(gs[0][None])
    f_model = fisher_kernel.rows_plan(*shape, torch.float32)
    print(f"[geometry] fisher_tapgrads f32 {shape}: {f_plan['blocks']} "
          f"blocks of {f_plan['threads']} threads, {f_plan['vec']} columns "
          f"a thread, {f_plan['rows_ahead']} rows loaded ahead, valid rows "
          f"compacted {f_plan['rows_a_pass']} a pass", flush=True)
    if any(f_plan[k] != f_model[k] for k in fisher_kernel.PLAN_KEYS):
        fail(f"fisher's launch {f_plan} differs from the model")

    # kernel 1's task axis (a fleet's probe, phase 16): T stacked d_ff
    # groups with ragged masks (NaN in the masked rows), one launch, each
    # task bit-equal to a one-task (T = 1) launch on its slice, within
    # FISHER_TOL of the plain version
    t_worst = 0.0
    for nt in FISHER_TASKS:
        g = torch.randn((nt, *shape), generator=gen, device=dev)
        tm = torch.ones((nt, n_rows), device=dev)
        for t in range(nt):
            tm[t, n_rows - 8 * t - (n_rows - n_valid):] = 0.0
        g[tm[:, None, :, None].expand_as(g) == 0] = float("nan")
        tn = tm.sum(1)
        got = ops.fisher_tapgrads(g, tn, tm)
        want = fisher_tapgrads_ref(g, tn, tm)
        ones = [ops.fisher_tapgrads(g[t].contiguous(), float(tn[t]),
                                    tm[t].contiguous()) for t in range(nt)]
        sync(dev)
        err = max_err(got, want, FISHER_TOL["float32"],
                      f"fisher_tapgrads task axis T={nt}")
        bits = all(torch.equal(got[t], ones[t]) for t in range(nt))
        t_plan = fisher_kernel.plan(g)
        t_model = fisher_kernel.rows_plan(*shape, torch.float32, tasks=nt)
        print(f"[parity] fisher_tapgrads task axis f32 T={nt} x {shape} "
              f"(valid rows {[int(x) for x in tn.tolist()]}): max abs err "
              f"{err:.3g} (tol {FISHER_TOL['float32']:g} rel+abs), each task "
              f"{'bit-equal to' if bits else 'DIFFERS FROM'} a one-task "
              f"launch; launch {t_plan['blocks']} x {t_plan['tasks']} blocks "
              f"of {t_plan['threads']}, {t_plan['vec']} columns a thread",
              flush=True)
        if not bits:
            fail(f"the task-axis launch at T={nt} differs from one-task "
                 "launches")
        if any(t_plan[k] != t_model[k] for k in (*fisher_kernel.PLAN_KEYS,
                                                  "tasks")):
            fail(f"fisher's task-axis launch {t_plan} differs from the model")
        t_worst = max(t_worst, err)
    # its time at T = 4, four stacks cycled past the L2 as in the probe
    nt = FISHER_TASKS[-1]
    tgs = [torch.randn((nt, *shape), generator=gen, device=dev)
           for _ in range(4)]
    tmask = torch.ones((nt, n_rows), device=dev)
    tmask[:, n_valid:] = 0.0
    tn = tmask.sum(1)
    t_out = torch.empty((nt, shape[0], shape[2]), device=dev)
    t_entry = fisher_kernel._tap_entry()
    it["i"] = 0

    def next_tg():
        i = it["i"] = (it["i"] + 1) % len(tgs)
        return tgs[i]

    def run_tasks():
        err = t_entry(next_tg().data_ptr(), tmask.data_ptr(), tn.data_ptr(),
                      t_out.data_ptr(), nt, shape[0], shape[1], shape[2], 0,
                      stream, None)
        if err:
            fail(f"fisher_tapgrads_fwd returned cudaError {err}")

    def run_tasks_plain():
        fisher_tapgrads_ref(next_tg(), tn, tmask)

    def run_tasks_library():
        g = next_tg()
        torch.einsum("tlbc,tlbc,tb->tlc", g, g, tmask).mul_(
            (0.5 / tn)[:, None, None])

    ft_ms = time_ms(run_tasks, 50)
    ft_plain_ms = time_ms(run_tasks_plain, 10)
    ft_library_ms = time_ms(run_tasks_library, 20)
    ft_bytes = 4 * (nt * (n_valid * cells + n_rows + cells) + nt)
    ft_ops = 3 * nt * n_valid * cells
    t_bytes, t_ops = ft_bytes / HBM_BYTES_PER_S, ft_ops / PEAK_OPS["float32"]
    ft_bound_ms = 1e3 * max(t_bytes, t_ops)
    ft_bound_by = "bytes" if t_bytes >= t_ops else "operations"
    print(f"[time] fisher_tapgrads task axis f32 T={nt} x {shape} ({n_valid} "
          f"of {n_rows} rows valid a task): kernel {ft_ms:.4f} ms, bound "
          f"{ft_bound_ms:.5f} ms ({ft_bound_by}: {ft_bytes} B, {ft_ops} ops), "
          f"plain {ft_plain_ms:.4f} ms, einsum {ft_library_ms:.4f} ms",
          flush=True)
    fisher_tasks = {"ms": ft_ms, "plain_ms": ft_plain_ms,
                    "library_ms": ft_library_ms, "bound_ms": ft_bound_ms,
                    "bound_by": ft_bound_by, "max_abs_err": t_worst}
    del gs, tgs

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

    # the paths by size: one CTA (<= 8192), on chip (the leaf, up to the
    # SMs' shared memory, gq_cap) and two passes (one element past gq_cap,
    # two leaves)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    gq_cap = gq_kernel.capacity(sms)
    n_leaf = GQ_LEAF[0] * GQ_LEAF[1]
    gq_cases = [(1, "normal"), (5000, "normal"), (6151, "normal"),
                (1_000_003, "normal"), (n_leaf, "normal"),
                (gq_cap - 1, "normal"), (gq_cap, "normal"),
                (gq_cap + 1, "normal"), (2 * n_leaf, "normal"),
                (8, "ties"), (4099, "zeros"), (4099, "nan"),
                (gq_cap + 1, "nan")]
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
            path = gq_kernel.PATHS[gq_kernel.plan_model(n, sms)["path"]]
            print(f"[parity] grad_quant {dname} n={n} {kind} ({path}): "
                  f"codes, scale and residual "
                  f"{'equal' if same else 'DIFFERENT'} (gate: equal); scale "
                  f"{got[1].item():.6g}", flush=True)
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

    # one launch a call, on the path and grid of the host-side model
    gq_log = build.BUILD_LOG.get("grad_quant", (0, ""))[1]
    for n in (5000, n_leaf, gq_cap, gq_cap + 1):
        plan = gq_kernel.grad_quant_plan(n, torch.bfloat16)
        model = gq_kernel.plan_model(n, sms)
        ptx = ptxas_report(gq_log, "grad_quant_kernel", "13__nv_bfloat16",
                              f"Li{plan['path']}E")
        path = gq_kernel.PATHS[plan["path"]]
        print(f"[geometry] grad_quant bf16 n={n}: {path}, {plan['ctas']} "
              f"CTAs of {plan['threads']} threads on "
              f"{plan['sms']} SMs, {plan['smem_bytes']} B of dynamic shared "
              f"memory, {plan['registers']} registers a thread (ptxas log: "
              f"{'not in this build' if ptx is None else ptx}), one launch",
              flush=True)
        if (plan["path"], plan["ctas"], plan["threads"],
                plan["smem_bytes"]) != (model["path"], model["ctas"],
                                        model["threads"], model["smem_bytes"]):
            fail(f"grad_quant launch {plan} differs from the model {model}")

    # time at the largest leaf: bf16 g and a float32 residual, cycling 4
    # buffers (4 x 41 MB > the 50 MB L2), the kernel through its C entry
    n_gq = GQ_LEAF[0] * GQ_LEAF[1]
    gbufs = [(torch.randn(n_gq, generator=gen, device=dev).bfloat16(),
              0.01 * torch.randn(n_gq, generator=gen, device=dev))
             for _ in range(4)]
    q_out = torch.empty(n_gq, dtype=torch.int8, device=dev)
    e_out = torch.empty(n_gq, device=dev)
    scratch = torch.empty(2 + gq_kernel.MAX_CTAS, device=dev)
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

    # -- SSD scan kernels: forward and backward against their plain versions
    # forward against the sequential oracle, backward against autograd of
    # the plain chunked body in float32 on the same (rounded) inputs; at
    # the main path's shape, over several tiles with an initial state, and
    # at the Pallas chunk of 256
    def ssd_inputs(b, s, h, p, n, dtype, init=False):
        x = (0.5 * torch.randn((b, s, h, p), generator=gen, device=dev)
             ).to(dtype)
        dt = F.softplus(torch.randn((b, s, h), generator=gen, device=dev))
        a = -torch.exp(torch.randn((h,), generator=gen, device=dev))
        bm = (0.5 * torch.randn((b, s, n), generator=gen, device=dev)
              ).to(dtype)
        cm = (0.5 * torch.randn((b, s, n), generator=gen, device=dev)
              ).to(dtype)
        st = (0.5 * torch.randn((b, h, p, n), generator=gen, device=dev)
              if init else None)
        return x, dt, a, bm, cm, st

    def rel_err(got, want, tol, what):
        """Max abs error; fails unless finite and within ``tol`` of
        max(1, max |want|)."""
        got, want = got.float(), want.float()
        err = (got - want).abs().max().item()
        e = err / max(1.0, want.abs().max().item())
        if not (torch.isfinite(got).all().item() and e <= tol):
            fail(f"{what}: error {e} (relative to max |want|) beyond {tol:g}")
        return err

    ssd_cases = [dict(SSD), dict(b=2, s=160, h=4, p=32, n=64, chunk=80,
                                 init=True),
                 dict(b=1, s=512, h=2, p=64, n=128, chunk=256)]
    ssd_worst = ssd_bwd_worst = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[-1]
        tol = SSD_TOL[dname]
        for case in ssd_cases:
            chunk = case["chunk"]
            dims = {k: case[k] for k in ("b", "s", "h", "p", "n")}
            x, dt, a, bm, cm, st = ssd_inputs(**dims, dtype=dtype,
                                              init=case.get("init", False))
            y, fin = ops.ssd_scan(x, dt, a, bm, cm, chunk=chunk,
                                  init_state=st, out_dtype=torch.float32)
            yr, sr = ssd_scan_ref(x.float(), dt, a, bm, cm, st)
            # and the main path's launch: no final state asked for, so
            # several heads a CTA and the states kept only where a tile
            # needs one
            y0, _ = ops.ssd_scan(x, dt, a, bm, cm, chunk=chunk,
                                 init_state=st, want_state=False,
                                 out_dtype=torch.float32)
            e_fwd = max(rel_err(y, yr, 1e-4, f"ssd_scan y {dname} {case}"),
                        rel_err(fin, sr, 1e-4, f"ssd_scan state {dname}"),
                        rel_err(y0, yr, 1e-4, f"ssd_scan y without the "
                                f"final state {dname} {case}"))
            y0_same = torch.equal(y0, y)
            w = torch.randn(y.shape, generator=gen, device=dev)
            leaves = [t.clone().requires_grad_() for t in (x, dt, bm, cm)]
            y, _ = ssm.ssd_chunked(leaves[0], leaves[1], a, leaves[2],
                                   leaves[3], chunk, st, need_state=False)
            got = torch.autograd.grad((y * w).sum(), leaves)
            y, _ = ssm.ssd_chunked(leaves[0], leaves[1], a, leaves[2],
                                   leaves[3], chunk, st, need_state=False)
            again = torch.autograd.grad((y * w).sum(), leaves)
            if not all(torch.equal(g, g2) for g, g2 in zip(got, again)):
                fail(f"ssd_scan_bwd {dname} {case}: two runs differ")
            refl = [t.float().clone().requires_grad_()
                    for t in (x, dt, bm, cm)]
            yp, _ = ssm.ssd_chunked_plain(refl[0], refl[1], a, refl[2],
                                          refl[3], chunk, st)
            want = torch.autograd.grad((yp * w).sum(), refl)
            torch.cuda.synchronize()
            e_bwd = max(rel_err(g, wv, tol, f"ssd_scan_bwd {name_} {dname} "
                                f"{case}")
                        for g, wv, name_ in zip(got, want, ("dx", "d(dt)",
                                                            "dB", "dC")))
            ssd_worst, ssd_bwd_worst = (max(ssd_worst, e_fwd),
                                        max(ssd_bwd_worst, e_bwd))
            print(f"[parity] ssd_scan {dname} {case}: forward (with and "
                  f"without the final state, y "
                  f"{'bit-equal' if y0_same else 'not bit-equal'} between "
                  f"them) max abs error {e_fwd:.3g} (tol "
                  f"1e-4 of max(1, max |y|)), backward (dx, "
                  f"d(dt), dB, dC) {e_bwd:.3g} (tol {tol:g} of the same), "
                  f"two runs bit-equal", flush=True)
    del (x, dt, a, bm, cm, st, y, y0, yp, yr, w, leaves, refl, got, again,
         want)

    # time at the main path's shape in bf16, two input sets cycled (each
    # call moves 78 MB, above the 50 MB L2), the kernels through their C
    # entries
    b_, s_, h_, p_, n_ = (SSD[k] for k in ("b", "s", "h", "p", "n"))
    sets = [ssd_inputs(b_, s_, h_, p_, n_, torch.bfloat16) for _ in range(2)]
    dys = [torch.randn((b_, s_, h_, p_), generator=gen, device=dev)
           for _ in range(2)]
    y_out = torch.empty((b_, s_, h_, p_), device=dev)
    dx_o, ddt_o = torch.empty_like(y_out), torch.empty((b_, s_, h_),
                                                       device=dev)
    geo = ssd_kernel.bwd_geometry(b_, s_, h_)
    part = (torch.empty((2, b_, geo["groups"], s_, n_), device=dev)
            if geo["groups"] > 1 else None)
    dbc_o = torch.empty((2, b_, s_, n_), device=dev)
    states = (torch.empty((b_, h_, geo["state_slots"], p_, n_), device=dev)
              if geo["state_slots"] else None)
    launched = ctypes.c_int(0)
    fwd_entry, bwd_entry = ssd_kernel._entry(), ssd_kernel._bwd_entry()
    it["i"] = 0

    def next_set():
        i = it["i"] = (it["i"] + 1) % len(sets)
        return sets[i], dys[i]

    def run_ssd():
        (x, dt, a, bm, cm, _), _ = next_set()
        rc = fwd_entry(x.data_ptr(), dt.data_ptr(), a.data_ptr(),
                       bm.data_ptr(), cm.data_ptr(), None, y_out.data_ptr(),
                       None, b_, s_, h_, p_, n_, 1, stream)
        if rc:
            fail(f"ssd_scan_fwd returned cudaError {rc}")

    def run_ssd_bwd():
        (x, dt, a, bm, cm, _), dy = next_set()
        rc = bwd_entry(dy.data_ptr(), x.data_ptr(), dt.data_ptr(),
                       a.data_ptr(), bm.data_ptr(), cm.data_ptr(), None,
                       None if states is None else states.data_ptr(),
                       dx_o.data_ptr(), ddt_o.data_ptr(),
                       None if part is None else part.data_ptr(),
                       dbc_o.data_ptr(), b_, s_, h_, p_, n_, 1, stream,
                       ctypes.byref(launched))
        if rc:
            fail(f"ssd_scan_bwd returned cudaError {rc}")

    def run_ssd_plain():
        (x, dt, a, bm, cm, _), _ = next_set()
        ssd_scan_ref(x, dt, a, bm, cm)

    def run_ssd_bwd_plain():
        (x, dt, a, bm, cm, _), dy = next_set()
        lv = [t.detach().requires_grad_() for t in (x, dt, bm, cm)]
        y, _ = ssm.ssd_chunked_plain(lv[0], lv[1], a, lv[2], lv[3],
                                     SSD["chunk"])
        torch.autograd.grad(y, lv, dy)

    ssd_ms = time_ms(run_ssd, 20)
    ssd_bwd_ms = time_ms(run_ssd_bwd, 10)
    # the backward's launch and its time split by launch (device time from
    # torch.profiler over ten calls)
    plan = ssd_kernel.bwd_plan(b_, s_, h_, p_, n_, torch.bfloat16)
    want_plan = dict(CTAs=geo["ctas"], cluster=geo["cluster"], threads=512,
                     smem_bytes=ssd_kernel.bwd_smem_bytes(p_, n_, 2),
                     state_slots=geo["state_slots"])
    ptx = ptxas_report(build.BUILD_LOG.get("ssd_scan", (0, ""))[1],
                          "ssd_bwd_kernel", "13__nv_bfloat16")
    print(f"[geometry] ssd_scan_bwd bf16 B={b_} S={s_} H={h_} P={p_} N={n_}: "
          f"{plan['CTAs']} CTAs in clusters of {plan['cluster']} heads, "
          f"{plan['threads']} threads, {plan['smem_bytes']} B of dynamic "
          f"shared memory, {plan['registers']} registers a thread (ptxas "
          f"log: {'not in this build' if ptx is None else ptx}), "
          f"{plan['state_slots']} tile states in a scratch, {launched.value} "
          f"launches a call ({geo['groups']} group partials a (b, s))",
          flush=True)
    if any(plan[k] != v for k, v in want_plan.items()):
        fail(f"ssd_scan_bwd launch {plan} differs from the model {want_plan}")
    if launched.value != geo["launches"]:
        fail(f"ssd_scan_bwd launched {launched.value} kernels a call, not "
             f"{geo['launches']}")
    # the forward's launch at the main path's call (no initial or final
    # state): heads a CTA and shared memory as the host-side model sets them
    fplan = ssd_kernel.fwd_plan(b_, s_, h_, p_, n_, torch.bfloat16)
    fgeo = ssd_kernel.fwd_geometry(b_, s_, h_, p_, n_, 2)
    ptx = ptxas_report(build.BUILD_LOG.get("ssd_scan", (0, ""))[1],
                          "ssd_fwd_kernel", "13__nv_bfloat16", "Lb1E")
    per_sm = ("two CTAs" if fgeo["smem_bytes"] <= ssd_kernel.HALF_SM_SMEM
              else "one CTA")
    print(f"[geometry] ssd_scan_fwd bf16 B={b_} S={s_} H={h_} P={p_} N={n_}: "
          f"{fplan['CTAs']} CTAs of {fplan['heads']} heads, "
          f"{fplan['threads']} threads, {fplan['smem_bytes']} B of dynamic "
          f"shared memory ({per_sm} an SM), {fplan['registers']} registers "
          f"a thread (ptxas log: "
          f"{'not in this build' if ptx is None else ptx}), "
          f"{fplan['stages']} staging area(s), states "
          f"{'kept' if fplan['state'] else 'not kept'}, {fgeo['tiles']} "
          f"tile(s) of {ssd_kernel.FWD_TILE} tokens", flush=True)
    want_f = dict(CTAs=fgeo["ctas"], heads=fgeo["heads"],
                  threads=fgeo["threads"], smem_bytes=fgeo["smem_bytes"],
                  stages=fgeo["stages"], state=int(fgeo["state"]))
    if any(fplan[k] != v for k, v in want_f.items()):
        fail(f"ssd_scan_fwd launch {fplan} differs from the model {want_f}")
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(10):
            run_ssd_bwd()
        torch.cuda.synchronize()
    split = {next((n for n in ("ssd_bwd_kernel", "reduce_groups")
                   if n in ev.key), ev.key[:40]):
             ev.device_time_total / max(ev.count, 1) / 1e3
             for ev in prof.key_averages()
             if getattr(ev, "device_time_total", 0) > 0}
    print("[time] ssd_scan_bwd split by launch (torch.profiler, device ms a "
          "call): " + (", ".join(f"{k} {v:.4f}" for k, v in split.items())
                       or "not measured (no device events)"), flush=True)
    ssd_plain_ms = time_ms(run_ssd_plain, 2)
    ssd_bwd_plain_ms = time_ms(run_ssd_bwd_plain, 2)
    ssd_rec = {}
    for what, backward, ms, plain_ms, worst_ in (
            ("forward", False, ssd_ms, ssd_plain_ms, ssd_worst),
            ("backward", True, ssd_bwd_ms, ssd_bwd_plain_ms, ssd_bwd_worst)):
        nbytes, nops = ssd_work(b_, s_, h_, p_, n_, 2, backward)
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, nops / PEAK_OPS["bfloat16"]
        bound_ms = 1e3 * max(t_bytes, t_ops)
        bound_by = "bytes" if t_bytes >= t_ops else "operations"
        f32_ms = 1e3 * nops / PEAK_OPS["float32"]
        print(f"[time] ssd_scan {what} bf16 B={b_} S={s_} H={h_} P={p_} "
              f"N={n_}: kernel {ms:.4f} ms, bound {bound_ms:.5f} ms "
              f"({bound_by}: {nbytes} B, {nops} ops; the same operations on "
              f"float32 CUDA cores {f32_ms:.4f} ms), plain {plain_ms:.4f} ms"
              f", no single library call", flush=True)
        ssd_rec[what] = {"ms": ms, "plain_ms": plain_ms, "library_ms": None,
                         "bound_ms": bound_ms, "bound_by": bound_by,
                         "max_abs_err": worst_}
    del sets, dys, y_out, dx_o, ddt_o, part, dbc_o, states

    # -- kernel 3, aligned flash attention: parity against the plain version
    # at every case of ALIGNED, then the timed cases (kernel through its C
    # entry; their K/V fit the L2, as a long prefill's do layer by layer)
    fa_entry = flash_aligned._entry()
    fa_worst, fa_times = 0.0, {}
    for (what, b_, sq_, sk_, hq_, hkv_, d_, causal_, window_,
         dnames) in ALIGNED:
        for dname in dnames:
            dtype = getattr(torch, dname)
            q = torch.randn((b_, sq_, hq_, d_), generator=gen,
                            device=dev).to(dtype)
            k = torch.randn((b_, sk_, hkv_, d_), generator=gen,
                            device=dev).to(dtype)
            v = torch.randn((b_, sk_, hkv_, d_), generator=gen,
                            device=dev).to(dtype)
            got = ops.flash_attention(q, k, v, causal=causal_,
                                      window=window_)
            again = ops.flash_attention(q, k, v, causal=causal_,
                                        window=window_)
            want = flash_attention_ref(q, k, v, causal=causal_,
                                       window=window_)
            torch.cuda.synchronize()
            if not torch.equal(got, again):
                fail(f"flash_attention {what} {dname}: two runs differ")
            scale = rms(want)
            atol = (min(TOL[dname], BF16_RMS_TOL * scale)
                    if dtype == torch.bfloat16 else TOL[dname])
            err = max_err(got, want, TOL[dname], f"flash_attention {what} "
                          f"{dname}", atol)
            fa_worst = max(fa_worst, err)
            print(f"[parity] flash_attention {what} {dname} (B={b_} Sq={sq_} "
                  f"Sk={sk_} Hq={hq_} Hkv={hkv_} D={d_} causal={causal_} "
                  f"window={window_}): max abs err {err:.3g} = "
                  f"{err / scale:.3g} rms(want) (gate {atol:.3g} + "
                  f"{TOL[dname]:g} |want|), two runs bit-equal", flush=True)
            if (what not in ALIGNED_TIMED or dname != dnames[0]
                    or what in fa_times):
                continue
            out = torch.empty_like(q)

            def run_fa():
                rc = fa_entry(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                              out.data_ptr(), b_, sq_, sk_, hq_, hkv_, d_,
                              int(causal_), window_,
                              0 if dtype == torch.float32 else 1, stream)
                if rc:
                    fail(f"flash_aligned_fwd returned cudaError {rc}")

            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
            pos = torch.arange(sk_, device=dev)
            qp = torch.arange(sq_, device=dev)[:, None]
            band = (pos[None, :] <= qp) & (pos[None, :] > qp - window_)

            def run_sdpa():
                if window_:
                    F.scaled_dot_product_attention(qt, kt, vt,
                                                   attn_mask=band,
                                                   enable_gqa=True)
                else:
                    F.scaled_dot_product_attention(qt, kt, vt,
                                                   is_causal=causal_,
                                                   enable_gqa=True)

            ms = time_ms(run_fa, 10)
            plain_ms = time_ms(lambda: flash_attention_ref(
                q, k, v, causal=causal_, window=window_), 1)
            library_ms = time_ms(run_sdpa, 10)
            nbytes, nops = aligned_work(b_, sq_, sk_, hq_, hkv_, d_, causal_,
                                        window_, q.element_size())
            # float32 runs three TF32 products a multiply-add: its bound is
            # theirs at the TF32 rate; the CUDA cores' is printed beside
            rate = "tf32" if dtype == torch.float32 else dname
            k_ops = 3 * nops if dtype == torch.float32 else nops
            t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, k_ops / PEAK_OPS[rate]
            bound_ms = 1e3 * max(t_bytes, t_ops)
            bound_by = "bytes" if t_bytes >= t_ops else "operations"
            fa_times[what] = {"ms": ms, "plain_ms": plain_ms,
                              "library_ms": library_ms, "bound_ms": bound_ms,
                              "bound_by": bound_by}
            cores = ("" if dtype != torch.float32 else
                     f"; on the CUDA cores {1e3 * max(t_bytes, nops / PEAK_OPS['float32']):.5f} ms")
            print(f"[time] flash_attention {what} {dname} (B={b_} S={sq_} "
                  f"Hq={hq_} Hkv={hkv_} D={d_} causal window={window_}, "
                  f"{flash_aligned.path(d_, dtype)} path): kernel {ms:.4f} "
                  f"ms, bound {bound_ms:.5f} ms ({bound_by}: {nbytes} B, "
                  f"{k_ops} ops at the {rate} peak{cores}), plain "
                  f"{plain_ms:.4f} ms, sdpa {library_ms:.4f} ms", flush=True)
    aligned = dict(fa_times["bench full"], max_abs_err=fa_worst)
    # each path's launch at its timed shapes, held to the host-side models:
    # the wgmma path at qwen2-1.5b's, gemma-2b's and stablelm-12b's prefill
    # widths (head dims 128, 256 and 160 padded to 192), the float32 path
    # at the bench's full shape; ptxas's registers and spills of each
    fa_log = build.BUILD_LOG.get("flash_aligned", (0, ""))[1]
    for b_, sq_, hq_, hkv_, d_, dtype in (
            (1, 4096, 12, 2, 128, torch.bfloat16),
            (1, 4096, 8, 1, 256, torch.bfloat16),
            (1, 4096, 32, 8, 160, torch.bfloat16),
            (2, 2048, 8, 2, 128, torch.float32)):
        plan = flash_aligned.plan(b_, sq_, sq_, hq_, hkv_, d_, dtype)
        if dtype == torch.float32:
            sched = flash_aligned.tf32_schedule(b_, sq_, sq_, hq_)
            smem, threads, stages = (flash_aligned.tf32_smem(d_),
                                     flash_aligned.TF_THREADS,
                                     flash_aligned.TF_STAGES)
            kern, dp = "flash_aligned_tf32", d_
            who = "four warps"
        else:
            sched = flash_aligned.wgmma_schedule(b_, sq_, sq_, hq_, d=d_)
            smem, threads, stages = (flash_aligned.wgmma_smem(d_),
                                     flash_aligned.WG_THREADS,
                                     flash_aligned.WG_STAGES)
            kern = "flash_aligned_wgmma"
            dp = flash_aligned.wgmma_tiles(d_)["dp"]
            who = ("a producer warpgroup, two consumer warpgroups; "
                   "setmaxnreg: producer 24, consumers 240")
        tiles = sum(len(o["tiles"]) for o in sched["order"])
        masked = sum(m for o in sched["order"] for _, m in o["tiles"])
        spill = ptxas_report(fa_log, kern, f"Li{dp}E", what="spill")
        ptx = ptxas_report(fa_log, kern, f"Li{dp}E")
        print(f"[geometry] flash_aligned {flash_aligned.path(d_, dtype)} "
              f"{str(dtype).split('.')[-1]} B={b_} S={sq_} Hq={hq_} "
              f"Hkv={hkv_} D={d_} causal: {plan['CTAs']} CTAs (grid "
              f"{sched['grid']}, longest bands first), {plan['threads']} "
              f"threads ({who}), {plan['smem_bytes']} B of dynamic shared "
              f"memory, {plan['stages']} K/V stages, {plan['registers']} "
              f"registers a thread at launch (ptxas log: "
              f"{'not in this build' if ptx is None else ptx} registers, "
              f"{'?' if spill is None else spill} bytes of spill stores); "
              f"{tiles} kv tiles of {sched['bn']}, {masked} masked",
              flush=True)
        if (plan["CTAs"] != sched["grid"][0] * sched["grid"][1]
                or plan["threads"] != threads
                or plan["smem_bytes"] != smem or plan["stages"] != stages):
            fail(f"flash_aligned's launch {plan} at D={d_} {dtype} differs "
                 "from the model")
    # whether L2 serves a GQA group's K/V on the wgmma path: the same work
    # with one kv head a query head, at qwen2-1.5b's prefill width
    b_, sq_, hq_, hkv_, d_ = 1, 4096, 12, 2, 128
    q = torch.randn((b_, sq_, hq_, d_), generator=gen, device=dev).bfloat16()
    k = torch.randn((b_, sq_, hkv_, d_), generator=gen, device=dev).bfloat16()
    v = torch.randn((b_, sq_, hkv_, d_), generator=gen, device=dev).bfloat16()
    kf, vf = (x.repeat_interleave(hq_ // hkv_, dim=2).contiguous()
              for x in (k, v))
    gqa_ms = time_ms(lambda: flash_aligned.flash_attention_aligned_cuda(
        q, k, v), 10)
    mha_ms = time_ms(lambda: flash_aligned.flash_attention_aligned_cuda(
        q, kf, vf), 10)
    print(f"[time] flash_aligned wgmma, GQA group of {hq_ // hkv_} sharing "
          f"K/V through L2: {gqa_ms:.4f} ms; the same work with a kv head "
          f"a query head: {mha_ms:.4f} ms", flush=True)
    del q, k, v, kf, vf, got, again, want, out, qt, kt, vt, band
    torch.cuda.empty_cache()

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

    # TinyTrain on mamba2-smoke: the SSD kernels (forward and backward)
    # and the Fisher kernel on the card against the plain path on the CPU,
    # same weights; the folded engines serve through the recurrence
    msmall = configs.get_reduced("mamba2-1.3b")
    mp_cpu = T.init_params(msmall, torch.Generator().manual_seed(0),
                           device="cpu")
    mp_gpu = tree_map(lambda t: t.to(dev), mp_cpu)
    mbb = api.backbone("mamba2-1.3b", preset="smoke", batch_size=32, seq=16)
    mtask = api.sample_lm_task(np.random.default_rng(0), msmall.vocab,
                               seq=16, max_way=5, support_pad=32,
                               query_pad=32)
    mrng = np.random.default_rng(2)
    mprompts = [mrng.integers(0, msmall.vocab, n).astype(np.int32)
                for n in lens]
    madapted = {}
    ssd_before = (ops.ssd_scan.launches, ops.ssd_scan.bwd_launches)
    for where, params in (("cpu", mp_cpu), ("cuda", mp_gpu)):
        sess = api.TinyTrainSession(mbb, params, max_way=5)
        ad = sess.adapt(mtask, api.JETSON_NANO, iters=4)
        eng = ServeEngine(msmall, params, slots=3, max_len=48, chunk=4,
                          device=where)
        ad.fold_into(eng)
        reqs = [Request(uid=i, prompt=p, max_new=6)
                for i, p in enumerate(mprompts)]
        eng.run(reqs)
        madapted[where] = (ad, [(r.out, r.outcome) for r in reqs])
    ssd_smoke = (ops.ssd_scan.launches - ssd_before[0],
                 ops.ssd_scan.bwd_launches - ssd_before[1])
    (a_cpu, s_cpu), (a_gpu, s_gpu) = madapted["cpu"], madapted["cuda"]
    loss_err = max(abs(x - y) for x, y in zip(a_cpu.losses, a_gpu.losses))
    print(f"[check] mamba2-smoke f32 TinyTrain, card vs CPU plain path: "
          f"policy {'identical' if a_cpu.policy.units == a_gpu.policy.units else 'DIFFERENT'} "
          f"({a_gpu.policy.describe()}), max loss diff {loss_err:.3g} "
          f"(tol 1e-4), folded-engine streams "
          f"{'identical' if s_cpu == s_gpu else 'DIFFERENT'}; ssd_scan "
          f"launches {ssd_smoke[0]} forward, {ssd_smoke[1]} backward",
          flush=True)
    if a_cpu.policy.units != a_gpu.policy.units:
        fail(f"mamba2 policies differ: {a_cpu.policy.describe()} vs "
             f"{a_gpu.policy.describe()}")
    if not {u.kind for u in a_gpu.policy.units} == {"ssm"}:
        fail(f"mamba2-smoke selected no SSD unit: {a_gpu.policy.describe()}")
    if not loss_err <= 1e-4:
        fail(f"mamba2 losses differ: {a_cpu.losses} vs {a_gpu.losses}")
    if s_cpu != s_gpu:
        fail(f"mamba2 folded streams differ: cpu {s_cpu} cuda {s_gpu}")
    if min(ssd_smoke) <= 0:
        fail(f"the card's mamba2-smoke adapt launched the SSD kernels "
             f"{ssd_smoke} times")
    del mp_cpu, mp_gpu, madapted

    # -- serve: qwen2-1.5b at full width -----------------------------------
    params = T.init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    eng = ServeEngine(cfg, params, slots=8, max_len=512, chunk=32)
    eng.run([Request(uid=-1, prompt=np.arange(8, dtype=np.int32), max_new=2)])
    rng = np.random.default_rng(0)
    reqs = [Request(uid=i,
                    prompt=rng.integers(0, cfg.vocab, int(n)).astype(np.int32),
                    max_new=16)
            for i, n in enumerate(rng.integers(32, 257, 8))]
    eng.tick_sync_debug = "error"
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
          f"{new_tokens / wall:.2f} tok/s, {rep['ticks']} ticks "
          f"({rep['ticks_issued']} issued), {rep['host_syncs']} host syncs "
          f"for {rep['chunks']} chunks, kv_cache_bytes "
          f"{eng.memory_report()['kv_cache_bytes']}, flash_cached launches "
          f"{launches}", flush=True)
    one_sync_a_chunk(rep, "serve")
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

    def full_serve(reqs, sync_debug="error", **kw):
        """Serve ``reqs`` through a fresh engine on phase 5's weights: a
        warm-up request, then the kernel counts set to 0, the run (its tick
        loops under ``sync_debug``), and the counts read just after.
        Returns (engine, wall seconds, paged launches, cached launches)."""
        eng = ServeEngine(cfg, params, slots=8, max_len=512, chunk=32, **kw)
        eng.run([Request(uid=-1, prompt=np.arange(8, dtype=np.int32),
                         max_new=2)])
        eng.tick_sync_debug = sync_debug
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
          f"ticks ({rep['ticks_issued']} issued), {rep['host_syncs']} host "
          f"syncs for {rep['chunks']} chunks, peak {rep['peak_resident']} "
          f"resident; streams equal to phase 5's: {same} of {len(reqs)}; "
          f"kv_cache_bytes {mem['kv_cache_bytes']} (pages "
          f"{mem['page_bytes'] * mem['n_pages']}, fixed-stripe bytes "
          f"{stripe_bytes}, page table {table_bytes}); a stream holds "
          f"{held:.2f} pages at its end, {held * mem['page_bytes']:.0f} B = "
          f"{held / stripe:.3f}x a {stripe}-page stripe; flash_paged launches "
          f"{paged_launches}, flash_cached launches {cached_in_paged}",
          flush=True)
    all_done(reqs, 16, "paged serve")
    one_sync_a_chunk(rep, "paged serve")
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
          f"ticks ({rep['ticks_issued']} issued), {rep['host_syncs']} host "
          f"syncs for {rep['chunks']} chunks, outcomes "
          f"{rep['outcomes']}, preemptions {sum(r.preempts for r in reqs)}, "
          f"peak {rep['peak_resident']} resident where the same pages hold "
          f"{PRESSURE['pages'] // stripe} fixed stripes; streams equal to an "
          f"unpressured run: {same} of {len(reqs)} (reported, not gated); "
          f"flash_paged launches {pressure_launches}", flush=True)
    all_done(reqs, PRESSURE["max_new"], "pressure")
    one_sync_a_chunk(rep, "pressure")
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
        reqs, sync_debug=None, kv_paging=True, kv_page_size=PAGE_SIZE,
        kv_int8=True)
    rep, mem = eng.last_run_report, eng.last_run_report["memory"]
    pages_bytes = mem["page_bytes"] * mem["n_pages"]
    same = sum(list(r.out) == want for r, want in zip(reqs, phase5))
    print(f"[int8] int8 pages + per-row scales {pages_bytes} B (expected "
          f"{int8_bytes}; bf16 pages {stripe_bytes} B: "
          f"{pages_bytes / stripe_bytes:.3f}x), kv_cache_bytes "
          f"{mem['kv_cache_bytes']}: {sum(len(r.out) for r in reqs)} new "
          f"tokens in {wall:.3f} s = {sum(len(r.out) for r in reqs) / wall:.2f}"
          f" tok/s, {rep['ticks']} ticks, {rep['host_syncs']} host syncs "
          f"for {rep['chunks']} chunks; streams equal to phase 5's: {same} "
          f"of {len(reqs)} (reported, not gated); flash_cached launches "
          f"{int8_launches} (block prefill over the gathered int8 view), "
          f"flash_paged launches {paged_in_int8}", flush=True)
    all_done(reqs, 16, "int8 pages")
    one_sync_a_chunk(rep, "int8 pages")
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
    eng.tick_sync_debug = "error"
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
          f"{online['host_syncs']} host syncs for {online['chunks']} chunks; "
          f"peak device memory "
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
    one_sync_a_chunk(online, "personalise")
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

    del eng, pers, session, adaptation
    torch.cuda.empty_cache()

    # -- adapt mamba2: mamba2-1.3b at full width, adapt -> fold -> serve ----
    # phase 6's episode shape and profile on the ssm family: the probe and
    # the fine-tune run every SSD layer's scan through the forward kernel
    # and back-propagate through the backward kernel; the folded engine
    # serves through the recurrence (no SSD kernel)
    mcfg = configs.get_config("mamba2-1.3b")
    mnl = mcfg.n_layers
    mbb = api.backbone("mamba2-1.3b", preset="full",
                       batch_size=ADAPT["batch_size"], seq=ADAPT["seq"])
    msession = api.TinyTrainSession(mbb, max_way=ADAPT["max_way"], seed=0)
    mtask = api.sample_lm_task(np.random.default_rng(0), mcfg.vocab,
                               seq=ADAPT["seq"], max_way=ADAPT["task_way"],
                               support_pad=ADAPT["pad"],
                               query_pad=ADAPT["pad"])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.fisher_tapgrads.launches = ops.fisher.launches = 0
    ops.ssd_scan.launches = ops.ssd_scan.bwd_launches = 0
    ssd_kernel.bwd_kernels = 0
    t0 = time.perf_counter()
    madapt = msession.adapt(mtask, profile, iters=ADAPT["iters"])
    torch.cuda.synchronize()
    madapt_wall = time.perf_counter() - t0
    madapt_peak = torch.cuda.max_memory_allocated()
    m_fisher = ops.fisher_tapgrads.launches + ops.fisher.launches
    ssd_launches = ops.ssd_scan.launches
    ssd_bwd_launches = ops.ssd_scan.bwd_launches
    ssd_bwd_kernels = ssd_kernel.bwd_kernels
    ssd_geo = ssd_kernel.bwd_geometry(ADAPT["batch_size"], ADAPT["seq"],
                                      mcfg.n_ssm_heads)
    eng = ServeEngine(mcfg, msession.params, slots=4, max_len=96, chunk=16)
    madapt.fold_into(eng)
    eng.run([Request(uid=-1, prompt=np.arange(8, dtype=np.int32),
                     max_new=2)])
    eng.tick_sync_debug = "error"
    rng = np.random.default_rng(0)
    reqs = [Request(uid=i, prompt=rng.integers(
        0, mcfg.vocab, size=int(rng.integers(4, 16))).astype(np.int32),
        max_new=12) for i in range(10)]
    ops.ssd_scan.launches = 0
    t0 = time.perf_counter()
    eng.run(reqs)
    torch.cuda.synchronize()
    mserve_wall = time.perf_counter() - t0
    serve_ssd = ops.ssd_scan.launches
    rep = eng.last_run_report
    mpol = madapt.policy
    mlosses = madapt.losses
    new_tokens = sum(len(r.out) for r in reqs)
    print(f"[mamba2] mamba2-1.3b bf16 full width ({mnl} layers, d_model "
          f"{mcfg.d_model}, {mcfg.n_ssm_heads} SSD heads of "
          f"{mcfg.ssm_head_dim}, state {mcfg.ssm_state}), {profile.name}, "
          f"task {mtask.n_support} support rows of "
          f"{len(mtask.support['episode_labels'])}: {mpol.describe()}",
          flush=True)
    print(f"[mamba2] fisher_seconds {madapt.fisher_seconds:.4f}, "
          f"train_seconds {madapt.train_seconds:.4f} ({ADAPT['iters']} "
          f"steps), adapt wall {madapt_wall:.4f} s, peak device memory "
          f"{madapt_peak} B, host_transfers {madapt.host_transfers:g}, "
          f"skipped {madapt.skipped_steps}, fisher launches {m_fisher}, "
          f"ssd_scan launches {ssd_launches} forward, {ssd_bwd_launches} "
          f"backward ({ssd_bwd_kernels} device kernels: "
          f"{ssd_geo['launches']} a backward, the forward never re-run)",
          flush=True)
    print(f"[mamba2] losses {[round(x, 6) for x in mlosses]}", flush=True)
    print(f"[mamba2] folded engine: {len(reqs)} requests, {new_tokens} new "
          f"tokens in {mserve_wall:.3f} s = {new_tokens / mserve_wall:.2f} "
          f"tok/s, {rep['ticks']} ticks ({rep['ticks_issued']} issued), "
          f"{rep['host_syncs']} host syncs for {rep['chunks']} chunks, "
          f"outcomes {rep['outcomes']}, recurrent state "
          f"{rep['memory']['kv_cache_bytes']} B, ssd_scan launches "
          f"{serve_ssd} (the serve runs the recurrence)", flush=True)
    if not all(math.isfinite(x) for x in mlosses):
        fail(f"mamba2 adaptation losses must be finite: {mlosses}")
    if madapt.host_transfers != 2:
        fail(f"the mamba2 adapt made {madapt.host_transfers} host transfers, "
             "not 2")
    if m_fisher != 1:
        fail(f"the mamba2 probe launched the Fisher kernel {m_fisher} times, "
             "not once (one tap group)")
    if {u.kind for u in mpol.units} != {"ssm"}:
        fail(f"the profile selected no SSD unit: {mpol.describe()}")
    if ssd_launches <= 0 or ssd_launches % mnl:
        fail(f"ssd_scan forward launches {ssd_launches} is not a positive "
             f"multiple of n_layers = {mnl}")
    if ssd_bwd_launches <= 0:
        fail("the mamba2 adapt never launched the SSD backward kernel")
    if ssd_bwd_kernels != ssd_geo["launches"] * ssd_bwd_launches:
        fail(f"the mamba2 adapt's {ssd_bwd_launches} SSD backwards launched "
             f"{ssd_bwd_kernels} kernels, not {ssd_geo['launches']} each")
    if not all(r.done and r.outcome == "done" for r in reqs):
        fail(f"mamba2 folded-engine requests not done: "
             f"{[(r.uid, r.outcome) for r in reqs]}")
    one_sync_a_chunk(rep, "mamba2 serve")
    del eng, msession, madapt
    torch.cuda.empty_cache()

    # -- kernel bench: the twin of benchmarks/kernel_bench.py --------------
    # the path that runs kernel 3 (and every other kernel at the reference
    # bench's full shapes); its record goes to the build directory
    spec = importlib.util.spec_from_file_location(
        "kernel_bench", os.path.join(ROOT, "benchmarks_torch",
                                     "kernel_bench.py"))
    kb = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(kb)
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    ops.flash_attention.launches = 0
    t0 = time.perf_counter()
    bench = kb.main(quick=False, device="cuda",
                    out=os.path.join(ROOT, "build", "BENCH_torch_kernels.json"))
    bench_launches = ops.flash_attention.launches
    for r in bench["rows"]:
        lib = ("-" if r["library_ms"] is None else f"{r['library_ms']:.4f}")
        print(f"[bench] {r['name']} {r['shape']}: {r['ms']:.4f} ms "
              f"({r['ms_min']:.4f}-{r['ms_max']:.4f} over {r['trials']} "
              f"trials of {r['inner']}), plain {r['plain_ms']:.4f} ms, bound "
              f"{r['bound_ms']:.5f} ms ({r['bound_by']}), library {lib} ms, "
              f"max abs err {r['max_abs_err']:.3g} (tol {r['tol']:g})",
              flush=True)
    print(f"[bench] kernel_bench --full in {time.perf_counter() - t0:.1f} s, "
          f"{len(bench['rows'])} rows, flash_aligned launches "
          f"{bench_launches}", flush=True)
    bad = kb.check(bench)
    if bad:
        fail(f"kernel_bench: {bad}")
    if bench_launches <= 0:
        fail("the kernel bench never launched the aligned flash kernel")
    torch.cuda.empty_cache()

    # -- phase 13: examples/quickstart.py on the card -----------------------
    # the edge-CNN path's convolutions are cuDNN's; none of the port's
    # kernels lies on it, so every launch count stays 0 over 13 and 14
    from repro_torch.core import adapt as telemetry
    from repro_torch.models.edge_cnn import cnn_total_costs

    kernel_launches(ops, zero=True)
    qs = QUICKSTART
    qbb = api.backbone(qs["arch"], in_res=qs["in_res"],
                       batch_size=qs["batch_size"])
    qsession = api.TinyTrainSession(qbb, max_way=qs["max_way"], seed=0)
    qtask = api.sample_task(np.random.default_rng(0), qs["domain"],
                            res=qs["in_res"], max_way=qs["max_way"],
                            support_pad=qs["support_pad"],
                            query_pad=qs["query_pad"])
    qprofile = api.RPI_ZERO
    acc_before = qsession.evaluate(qtask)
    syncs = telemetry.host_sync_count()
    t0 = time.perf_counter()
    qa = qsession.adapt(qtask, qprofile, iters=qs["iters"])
    torch.cuda.synchronize()
    q_wall = time.perf_counter() - t0
    syncs = telemetry.host_sync_count() - syncs
    report = qa.memory_report()
    print(f"[quickstart] {qs['arch']} in_res {qs['in_res']} "
          f"({qbb.cfg.n_layers} conv layers), task {qtask.name} "
          f"{qtask.n_support} support rows of "
          f"{len(qtask.support['episode_labels'])}, {qprofile.name}: "
          f"policy {qa.policy.describe()}", flush=True)
    print(f"[quickstart] fisher probe {qa.fisher_seconds:.4f} s, fine-tune "
          f"{qa.train_seconds:.4f} s ({qs['iters']} steps), adapt wall "
          f"{q_wall:.4f} s, backward memory {report['total_bytes'] / 1e3:.1f}"
          f" KB (budget {qprofile.mem_kb:.0f} KB on {qprofile.name}), "
          f"host transfers {syncs}, accuracy {acc_before * 100:.1f}% -> "
          f"{qa.accuracy() * 100:.1f}%", flush=True)
    if qa.policy.n_units < 1:
        fail("the quickstart's policy selects no unit")
    if not all(math.isfinite(x) for x in qa.losses):
        fail(f"quickstart losses must be finite: {qa.losses}")
    if report["total_bytes"] > qprofile.mem_kb * 1e3:
        fail(f"the quickstart's policy needs {report['total_bytes']} B, "
             f"over the budget")
    if qa.host_transfers != 2 or syncs != 2:
        fail(f"the quickstart's fused adapt made {syncs} host transfers, "
             "not 2")
    again = qsession.adapt(qtask, qprofile, iters=qs["iters"])
    print(f"[quickstart] a second card run: losses and deltas "
          f"{'bit-equal' if same_adapt(qa, again) else 'DIFFER'}", flush=True)
    if not same_adapt(qa, again):
        fail(f"two card runs of the quickstart differ by "
             f"{adapt_gap(qa, again)}")
    card_vs_cpu(api, qsession, qtask, qprofile, qa, "quickstart")
    del qsession, qa, again

    # -- phase 14: the paper's backbones at in_res 84, then the users -------
    pp = PAPER
    pprofile = api.STM32F746.scaled(mem=pp["mem"])

    def paper_task(rng, domain, **kw):
        kw = {"support_pad": pp["support_pad"], "query_pad": pp["query_pad"],
              "max_support_total": pp["support_total"],
              "max_support_per_class": pp["per_class"], **kw}
        return api.sample_task(rng, domain, res=pp["in_res"],
                               max_way=pp["max_way"], **kw)

    sessions = {}
    for arch in pp["archs"]:
        bb = api.backbone(arch, in_res=pp["in_res"],
                          batch_size=pp["batch_size"])
        session = api.TinyTrainSession(bb, max_way=pp["max_way"], seed=0)
        task = paper_task(np.random.default_rng(0), pp["domain"])
        acc0 = session.evaluate(task)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        syncs = telemetry.host_sync_count()
        t0 = time.perf_counter()
        a = session.adapt(task, pprofile, iters=pp["iters"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        syncs = telemetry.host_sync_count() - syncs
        n_params, macs = cnn_total_costs(bb.cfg)
        print(f"[paper] {arch} ({bb.cfg.name}, {bb.cfg.n_layers} conv "
              f"layers, {n_params} params, {macs} MACs an image at in_res "
              f"{pp['in_res']}), batch {len(task.support['episode_labels'])}"
              f", {pprofile.name}: {a.policy.describe()}; fisher_seconds "
              f"{a.fisher_seconds:.4f}, train_seconds {a.train_seconds:.4f} "
              f"({pp['iters']} steps), adapt wall {wall:.4f} s, peak "
              f"{torch.cuda.max_memory_allocated()} B, backward memory "
              f"{a.memory_report()['total_bytes']:.0f} B, host transfers "
              f"{syncs}, accuracy {acc0:.4f} -> {a.accuracy():.4f}",
              flush=True)
        if a.policy.n_units < 1:
            fail(f"{arch}: {pprofile.name} selects no unit, so no fine-tune "
                 "ran")
        if not all(math.isfinite(x) for x in a.losses):
            fail(f"{arch} losses must be finite: {a.losses}")
        if a.host_transfers != 2 or syncs != 2:
            fail(f"{arch}: the fused adapt made {syncs} host transfers")
        card_vs_cpu(api, session, task, pprofile, a, f"paper {arch}")
        sessions[arch] = session

    # examples/ondevice_adaptation.py on mcunet, up to its mesh= part
    session = sessions["mcunet"]
    for arch in pp["archs"][1:]:
        del sessions[arch]
    torch.cuda.empty_cache()
    rng = np.random.default_rng(0)
    user_tasks, store = [], {}
    for uid, domain in USERS:
        task = paper_task(rng, domain)
        t0 = time.perf_counter()
        a = session.adapt(task, pprofile, iters=pp["iters"])
        dt = time.perf_counter() - t0
        user_tasks.append(task)
        store[uid] = a
        print(f"[users] {uid} ({domain}): adapted in {dt:.3f} s (fisher "
              f"{a.fisher_seconds:.4f} s), {a.delta_param_count()} delta "
              f"params, {a.policy.describe()}, query acc "
              f"{a.accuracy() * 100:.1f}%", flush=True)
    policy = store["user-a"].policy

    def fleet_vs_adapt(tasks, what):
        """``adapt_many`` of ``tasks`` at the parity steps against each
        task's own ``adapt``, held as the card is held to the CPU: losses
        within 1e-4 and equal accuracy (the deltas' gap is printed: Adam
        turns a rounding difference in a gradient near its eps into one of
        up to lr a step)."""
        worst, bits, accs = (0.0, 0.0), True, True
        fleet = session.adapt_many(tasks, pprofile, iters=PARITY_ITERS,
                                   policy_override=policy)
        for t, f in zip(tasks, fleet):
            one = session.adapt(t, pprofile, iters=PARITY_ITERS,
                                policy_override=policy)
            gap = adapt_gap(f, one)
            worst = tuple(max(x, y) for x, y in zip(worst, gap))
            bits = bits and same_adapt(f, one)
            accs = accs and f.accuracy() == one.accuracy()
        print(f"[users] {what} against each task's own adapt on the card: "
              f"max loss diff {worst[0]:.3g} (tol 1e-4), max delta diff "
              f"{worst[1]:.3g}, accuracies {'equal' if accs else 'DIFFER'}, "
              f"{'bit-equal' if bits else 'not bit-equal'}", flush=True)
        if not worst[0] <= 1e-4 or not accs:
            fail(f"{what}: adapt_many differs from adapt by {worst}"
                 f"{'' if accs else ' and in accuracy'}")

    t0 = time.perf_counter()
    fleet = session.adapt_many(user_tasks, pprofile, iters=pp["iters"],
                               policy_override=policy)
    dt = time.perf_counter() - t0
    print(f"[users] adapt_many: {len(fleet)} users in {dt:.3f} s under "
          f"user-a's policy (query accs "
          f"{', '.join(f'{a.accuracy() * 100:.0f}%' for a in fleet)}), "
          f"{session.last_fleet_report['groups']} group(s)", flush=True)
    fleet_vs_adapt(user_tasks, "adapt_many of the four users")
    het = [paper_task(rng, domain, min_way=2 + i % 4, support_pad=None,
                      query_pad=None, max_support_total=6 + 7 * (i % 3),
                      max_support_per_class=8, query_per_class=4)
           for i, (_, domain) in enumerate(USERS * 2)]
    shapes = {t.support["episode_labels"].shape[0] for t in het}
    t0 = time.perf_counter()
    het_fleet = session.adapt_many(het, pprofile, iters=pp["iters"],
                                   policy_override=policy)
    dt = time.perf_counter() - t0
    rep = session.last_fleet_report
    print(f"[users] heterogeneous fleet: {len(het)} users, {len(shapes)} "
          f"episode shapes -> {rep['buckets']} buckets, {rep['groups']} "
          f"groups in {dt:.3f} s", flush=True)
    if rep["buckets"] >= len(shapes) or rep["groups"] != rep["buckets"]:
        fail(f"the heterogeneous fleet's grouping: {rep}")
    if not all(math.isfinite(x) for a in het_fleet for x in a.losses):
        fail("heterogeneous fleet losses must be finite")
    fleet_vs_adapt(het, "the heterogeneous fleet")
    a = store["user-b"]
    folded = a.fold_into(session.params)
    batch = {"images": torch.as_tensor(user_tasks[1].query["images"],
                                       device=dev)}
    with torch.no_grad():
        want = session.backbone.features(session.params, batch,
                                         deltas=a.deltas, plan=a.policy)
        got = session.backbone.features(folded, batch)
    torch.cuda.synchronize()
    fold_err = (got - want).abs().max().item()
    scale = want.abs().max().item()
    print(f"[users] user-b's deltas folded into a serving copy: features "
          f"max abs diff {fold_err:.3g} against the delta forward (tol "
          f"{1e-5 * scale:.3g} = 1e-5 max |want|)", flush=True)
    if not fold_err <= 1e-5 * scale:
        fail(f"folded features differ from the delta forward by {fold_err}")
    cnn_launches = kernel_launches(ops)
    print(f"[paper] the port's kernel launches over phases 13 and 14: "
          f"{cnn_launches}", flush=True)
    if any(cnn_launches.values()):
        fail(f"the edge-CNN path launched a kernel: {cnn_launches}")
    del session, sessions, folded
    torch.cuda.empty_cache()

    # -- phase 15: the paper's baselines and criteria on mcunet -------------
    # f32 with TF32 off, phase 14's task shape and profile; none of the
    # port's kernels lies on this path (cuDNN convolutions)
    kernel_launches(ops, zero=True)
    paper_baselines(api, dev, dict(pp, arch="mcunet"), pprofile,
                    BASELINES + CRITERIA, pp["iters"], PARITY_ITERS)
    base_launches = kernel_launches(ops)
    print(f"[baselines] the port's kernel launches over phase 15: "
          f"{base_launches}", flush=True)
    if any(base_launches.values()):
        fail(f"the baselines' CNN path launched a kernel: {base_launches}")
    torch.cuda.empty_cache()

    # -- phase 16: adapt_many's criterion route (kernel 1's task axis) ------
    # phase 6's backbone, profile and task (48 support rows, bucket 64) and
    # three tasks of 12 rows (bucket 16), 64 tokens, no override
    from repro_torch.data import lm_episode

    bb = api.backbone("qwen2-1.5b", preset="full",
                      batch_size=ADAPT["batch_size"], seq=ADAPT["seq"])
    session = api.TinyTrainSession(bb, max_way=ADAPT["max_way"], seed=0)
    rng = np.random.default_rng(16)
    ftasks = [api.sample_lm_task(
        np.random.default_rng(0), cfg.vocab, seq=ADAPT["seq"],
        max_way=ADAPT["task_way"], support_pad=ADAPT["pad"],
        query_pad=ADAPT["pad"])]
    for shots in FLEET_SHOTS:
        ep = lm_episode(rng, cfg.vocab, ADAPT["seq"], max_way=3, min_way=3,
                        shots=shots, query_per_class=8)
        ftasks.append(api.Task.from_episode(ep, rng, ADAPT["task_way"]))
    kernel_launches(ops, zero=True)
    fleet, fleet_wall, fleet_launches, captured = fleet_probe(
        api, ops, session, ftasks, profile, FLEET_ITERS,
        FISHER_TOL["bfloat16"], "qwen2-1.5b bf16")
    tap_groups = sum(len(grp) for grp in bb.make_taps(1, "cpu").values())
    want_launches = tap_groups * session.last_fleet_report["buckets"]
    if fleet_launches != want_launches or len(captured) != \
            session.last_fleet_report["buckets"]:
        fail(f"the fleet probe launched the Fisher kernel {fleet_launches} "
             f"times, not once per tap group per shape group "
             f"({want_launches})")
    # each task's scores: bit-equal to a one-task launch on its own tap
    # gradients, within FISHER_TOL of the plain version
    ops.fisher_tapgrads.launches = 0
    c_worst, c_bits = 0.0, True
    for tg, ns, mask, _ in captured:
        for gk, grp in tg.items():
            for kind, g in grp.items():
                got = ops.fisher_tapgrads(g, ns, mask)
                want = fisher_tapgrads_ref(g, ns, mask)
                c_worst = max(c_worst, max_err(
                    got, want, FISHER_TOL["float32"],
                    f"the fleet's {gk}/{kind} reduction"))
                for t in range(g.shape[0]):
                    one = ops.fisher_tapgrads(g[t].contiguous(), float(ns[t]),
                                              mask[t].contiguous())
                    c_bits = c_bits and torch.equal(got[t], one)
    sync(dev)
    fleet_single = ops.fisher_tapgrads.launches  # the checks', not counted
    shapes = [tuple(g.shape) for tg, *_ in captured for grp in tg.values()
              for g in grp.values()]
    print(f"[fleet] the captured reductions {shapes} ({g.dtype}): max abs "
          f"err against the plain version "
          f"{c_worst:.3g} (tol {FISHER_TOL['float32']:g}), each task "
          f"{'bit-equal to' if c_bits else 'DIFFERS FROM'} a one-task launch "
          f"({fleet_single} check launches)", flush=True)
    if not c_bits:
        fail("a fleet task's scores differ from a one-task launch's")
    fisher_tasks["max_abs_err"] = max(fisher_tasks["max_abs_err"], c_worst)
    del session, fleet, captured
    torch.cuda.empty_cache()
    # the same route on mcunet: the CNN's reduction is plain torch
    bb = api.backbone("mcunet", in_res=pp["in_res"],
                      batch_size=pp["batch_size"])
    session = api.TinyTrainSession(bb, max_way=pp["max_way"], seed=0)
    kernel_launches(ops, zero=True)
    fleet_probe(api, ops, session, user_tasks, pprofile, FLEET_ITERS,
                FISHER_TOL["float32"], "mcunet f32")
    cnn_fleet_launches = kernel_launches(ops)
    if any(cnn_fleet_launches.values()):
        fail(f"the CNN fleet probe launched a kernel: {cnn_fleet_launches}")
    del session

    print(smi)
    print(json.dumps({"kernels": [{
        "name": "flash_attention",
        "route": "cuda",
        "source": "src/repro_torch/csrc/flash_aligned.cu",
        "replaces": "src/repro/kernels/flash_attention.py:38",
        "launches": bench_launches,
        **aligned,
    }, {
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
        "launches": fisher_launches + m_fisher,
        **fisher,
    }, {
        "name": "fisher_tapgrads_tasks",
        "route": "cuda",
        "source": "src/repro_torch/csrc/fisher.cu",
        "replaces": "src/repro/kernels/fisher.py:66",
        "launches": fleet_launches,
        **fisher_tasks,
    }, {
        "name": "grad_quant",
        "route": "cuda",
        "source": "src/repro_torch/csrc/grad_quant.cu",
        "replaces": "src/repro/kernels/grad_quant.py:57",
        "launches": gq_launches,
        **gquant,
    }, {
        "name": "ssd_scan",
        "route": "cuda",
        "source": "src/repro_torch/csrc/ssd_scan.cu",
        "replaces": "src/repro/kernels/ssd_scan.py:22",
        "launches": ssd_launches,
        **ssd_rec["forward"],
    }, {
        "name": "ssd_scan_bwd",
        "route": "cuda",
        "source": "src/repro_torch/csrc/ssd_scan.cu",
        "replaces": "none: no TPU kernel (XLA autodiff of "
                    "src/repro/models/ssm.py:78 ssd_chunked)",
        "launches": ssd_bwd_launches,
        **ssd_rec["backward"],
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
