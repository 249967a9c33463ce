#!/usr/bin/env python3
"""Kernels 1, 2, 3 and 4 at the shapes whose designs changed or that the
kernel table lacked, through their C entries, on one card.

    python3 benchmarks_torch/redesign_bench.py [--out PATH] [--only NAMES]

Rows (bf16 unless named):

- ``flash_aligned gemma-2b prefill`` (1, 4096, 8, 1, 256) causal and
  ``flash_aligned stablelm-12b prefill`` (1, 4096, 32, 8, 160) causal:
  kernel 3 at the head dims of gemma-2b/paligemma-3b and stablelm-12b,
  beside ``F.scaled_dot_product_attention`` (``enable_gqa``);
- ``flash_aligned bench full f32`` (2, 2048, 8, 2, 128) causal: the
  reference kernel bench's own row, kernel 3's float32 path, beside SDPA
  in float32 (TF32 off); its bound is given twice, for the CUDA cores
  (67 TFLOP/s) and for three TF32 products (495 TFLOP/s);
- ``flash_aligned qwen2-1.5b prefill`` (1, 4096, 12, 2, 128) causal: a
  control on the bf16 D 128 path;
- ``fisher_tapgrads`` (28, 48, 8960) f32: kernel 1 at qwen2-1.5b's d_ff
  tap group, 40 of 48 rows valid (the adapt episode's mask), four buffer
  sets cycled past the 50 MB L2, beside ``torch.einsum``;
- ``fisher <name>``: kernel 1's (N, D, C) route through ``fisher_fwd``
  at the bench's (16, 2048, 1024) and qwen2-1.5b's d_ff over an episode
  of 48 rows of 64 tokens (48, 64, 8960), f32 and bf16, and at two edge
  CNN layers at 84 px, f32: the first (64 support images, a 42 x 42 map,
  8 channels: (64, 1764, 8)) and a late depthwise one of mcunet-5fps
  (576 channels at 3 x 3: (64, 9, 576)); buffer sets cycled past the
  L2, beside the plain version and the einsum pair (``einsum("ndc,ndc->
  nc")``, then ``einsum("nc,nc->c") / (2n)``: two calls, since no single
  one computes Eq. 2), eager and in a CUDA graph;
- ``flash_cached <model> block prefill`` and ``flash_paged <model> block
  prefill``: kernels 2 and 4 at B 8, Sq 8 and ragged cursors
  (``chip_smoke.py``'s) at three models' heads: gemma-2b's (Hq 8, Hkv 1,
  D 256, max_len 512, 18 layers), paligemma-3b's (gemma-2b's heads at
  max_len 768, the cursors past the first block moved past its 256-row
  image prefix: ``chip_smoke.py`` phase 20's) and stablelm-12b's (Hq 32,
  Hkv 8, D 160, max_len 512, 40 layers), and two controls on the D 128
  path, qwen2-1.5b's (Hq 12, Hkv 2, 28 layers) and mixtral-8x7b's (Hq 32,
  Hkv 8, 16 layers); one K/V buffer per layer cycled past the L2, beside
  SDPA with a mask and beside a page gather + SDPA; and their f32 path
  (FMA loops) at qwen2-1.5b's and gemma-2b's shapes (``... f32``), beside
  SDPA in f32 (TF32 off).

Each time is the median of 5 trials of CUDA events around enough calls to
pass 2 ms, with its spread.  The block rows also give the device time
without the host's launch cost (``graph_ms``, ``library_graph_ms``): two
calls a layer captured in one CUDA graph and replayed, since a call there
takes about as long to launch from Python as to run.  Each row also holds
the largest error against
the plain version on the same inputs and the bound (the larger of the
bytes over 3.35 TB/s and the operations over the dtype's dense peak).
Prints one line a row and, last, one JSON object with ``nvidia-smi``'s
name and power limit.  It uses only the kernels' C entries and plain
versions, so a copy of this file in another checkout's
``benchmarks_torch/`` times that tree when its entries have the same
signatures (kernel 1's tap-gradient route is ``fisher_tapgrads_fwd``
here; older trees take it through ``fisher_fwd``); run two trees
alternately in one call to compare them.  Imports nothing of JAX or of
the JAX package.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import statistics
import subprocess
import sys
import time
from typing import Any, Callable, Dict, List, Optional

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HBM = 3.35e12
PEAK = {"bfloat16": 989e12, "float32": 67e12, "tf32": 495e12}
# chip_smoke.py's ragged cursors for the block kernels (max_len 512)
Q_OFFSET = [0, 0, 37, 100, 255, 300, 504, 128]
KV_LEN = [0, 8, 40, 108, 263, 305, 512, 136]
PAGE = 16
ALIGNED = [  # (row, B, S, Hq, Hkv, D, dtype)
    ("gemma-2b prefill", 1, 4096, 8, 1, 256, "bfloat16"),
    ("stablelm-12b prefill", 1, 4096, 32, 8, 160, "bfloat16"),
    ("bench full f32", 2, 2048, 8, 2, 128, "float32"),
    ("qwen2-1.5b prefill", 1, 4096, 12, 2, 128, "bfloat16"),
]
# (model, B, Sq, Hq, Hkv, D, max_len, layers, q_offset, kv_len)
BLOCKS = [
    ("gemma-2b", 8, 8, 8, 1, 256, 512, 18, Q_OFFSET, KV_LEN),
    ("paligemma-3b", 8, 8, 8, 1, 256, 768, 18,
     [o + 256 if o else o for o in Q_OFFSET],
     [n + 256 if o else n for o, n in zip(Q_OFFSET, KV_LEN)]),
    ("stablelm-12b", 8, 8, 32, 8, 160, 512, 40, Q_OFFSET, KV_LEN),
    ("qwen2-1.5b", 8, 8, 12, 2, 128, 512, 28, Q_OFFSET, KV_LEN),
    ("mixtral-8x7b", 8, 8, 32, 8, 128, 512, 16, Q_OFFSET, KV_LEN),
]
# kernels 2 and 4's f32 path, at these of BLOCKS' models
BLOCKS_F32 = ("qwen2-1.5b", "gemma-2b")
# kernel 1's (N, D, C) route: (name, N, D, C, dtypes)
GENERAL = [
    ("bench", 16, 2048, 1024, ("float32", "bfloat16")),
    ("wide", 48, 64, 8960, ("float32", "bfloat16")),
    ("cnn-early", 64, 1764, 8, ("float32",)),
    ("cnn-head", 64, 9, 576, ("float32",)),
]
L2_BYTES = 50 * 2 ** 20
ROWS = ("aligned", "fisher", "general", "block")


def _smi() -> Optional[str]:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip() or None
    except (OSError, subprocess.SubprocessError):
        return None


def timed(fn: Callable[[], Any], trials: int = 5):
    """(median, min, max) ms a call over ``trials`` of CUDA events."""
    import torch

    def once(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / n

    fn()
    torch.cuda.synchronize()
    inner = max(1, math.ceil(2.0 / max(once(1), 1e-4)))
    per = [once(inner) for _ in range(trials)]
    return statistics.median(per), min(per), max(per)


def graphed(fn: Callable[[], Any], st: List[int], n: int):
    """(median, min, max) device ms a call of ``fn`` without the host's
    launch cost: ``n`` calls captured in one CUDA graph (``st[0]`` set to
    the capture stream for the kernels' C entries), replayed under
    ``timed``."""
    import torch

    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        st[0] = torch.cuda.current_stream().cuda_stream
        for _ in range(n):
            fn()
    return tuple(x / n for x in timed(g.replay))


def bound(nbytes: float, nops: float, peak: float):
    t_b, t_o = nbytes / HBM, nops / peak
    return 1e3 * max(t_b, t_o), ("bytes" if t_b >= t_o else "operations")


def causal_pairs(s: int) -> int:
    return s * (s + 1) // 2


def block_pairs(sq: int, q_offset=Q_OFFSET, kv_len=KV_LEN):
    """(K/V rows read, visible (query, key) pairs) of the block cursors."""
    rows = keys = 0
    for qo, kl in zip(q_offset, kv_len):
        rows += max(0, min(kl, qo + sq))
        keys += sum(max(0, min(kl - 1, qo + i) + 1) for i in range(sq))
    return rows, keys


def check(rc: int, what: str) -> None:
    if rc:
        raise RuntimeError(f"{what} returned cudaError {rc}")


def aligned_rows(dev, gen, stream) -> List[Dict[str, Any]]:
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_aligned
    from repro_torch.kernels.ref import flash_attention_ref

    entry = flash_aligned._entry()
    rows = []
    for what, b, s, hq, hkv, d, dname in ALIGNED:
        dtype = getattr(torch, dname)
        q = torch.randn((b, s, hq, d), generator=gen, device=dev).to(dtype)
        k = torch.randn((b, s, hkv, d), generator=gen, device=dev).to(dtype)
        v = torch.randn((b, s, hkv, d), generator=gen, device=dev).to(dtype)
        out = torch.empty_like(q)

        def run():
            check(entry(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                        out.data_ptr(), b, s, s, hq, hkv, d, 1, 0,
                        0 if dtype == torch.float32 else 1, stream),
                  "flash_aligned_fwd")

        run()
        want = flash_attention_ref(q, k, v, causal=True)
        torch.cuda.synchronize()
        err = (out.float() - want.float()).abs().max().item()
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        ms = timed(run)
        sdpa = timed(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True))
        nbytes = q.element_size() * (2 * b * s * hq * d + 2 * b * s * hkv * d)
        nops = 4 * d * hq * b * causal_pairs(s)
        bms, by = bound(nbytes, nops, PEAK[dname])
        row = {"name": f"flash_aligned {what}", "shape": [b, s, hq, hkv, d],
               "dtype": dname, "ms": ms[0], "ms_min": ms[1], "ms_max": ms[2],
               "library_ms": sdpa[0], "bound_ms": bms, "bound_by": by,
               "max_abs_err": err, "rms_want": want.float().pow(2).mean()
               .sqrt().item()}
        if dname == "float32":
            row["bound_tf32x3_ms"] = bound(nbytes, 3 * nops, PEAK["tf32"])[0]
        rows.append(row)
        del q, k, v, out, want, qt, kt, vt
        torch.cuda.empty_cache()
    return rows


def fisher_row(dev, gen, stream) -> Dict[str, Any]:
    import numpy as np
    import torch

    from repro_torch import api
    from repro_torch.kernels import fisher as fisher_kernel
    from repro_torch.kernels.ref import fisher_tapgrads_ref

    task = api.sample_lm_task(np.random.default_rng(0), 151936, seq=64,
                              max_way=5, support_pad=48, query_pad=48)
    mask = torch.from_numpy(
        (task.support["episode_labels"] >= 0).astype(np.float32)).to(dev)
    n_valid = int(mask.sum().item())
    shape = (28, mask.numel(), 8960)
    gs = [torch.randn(shape, generator=gen, device=dev) for _ in range(4)]
    out = torch.empty(shape[::2], device=dev)
    entry = fisher_kernel._tap_entry()
    scale = 1.0 / (2.0 * n_valid)
    n_one = torch.full((1,), float(n_valid), device=dev)
    it = [0]

    def nxt():
        it[0] = (it[0] + 1) % len(gs)
        return gs[it[0]]

    def run():
        check(entry(nxt().data_ptr(), mask.data_ptr(), n_one.data_ptr(),
                    out.data_ptr(), 1, shape[0], shape[1], shape[2], 0,
                    stream, None), "fisher_tapgrads_fwd")

    g = gs[0]
    g[:, mask == 0] = float("nan")  # a masked row is never read
    it[0] = len(gs) - 1
    run()
    want = fisher_tapgrads_ref(g, n_valid, mask)
    torch.cuda.synchronize()
    err = (out - want).abs().max().item()
    finite = bool(torch.isfinite(out).all().item())
    ms = timed(run)

    def einsum():
        x = nxt()
        torch.einsum("lbc,lbc,b->lc", x, x, mask).mul_(scale)

    lib = timed(einsum)
    cells = shape[0] * shape[2]
    bms, by = bound(4 * (n_valid * cells + shape[1] + 1 + cells),
                    3 * n_valid * cells, PEAK["float32"])
    return {"name": "fisher_tapgrads", "shape": list(shape),
            "dtype": "float32", "valid_rows": n_valid, "ms": ms[0],
            "ms_min": ms[1], "ms_max": ms[2], "library_ms": lib[0],
            "bound_ms": bms, "bound_by": by, "max_abs_err": err,
            "finite_with_nan_rows": finite}


def general_rows(dev, gen, stream) -> List[Dict[str, Any]]:
    import torch

    from repro_torch.kernels import fisher as fisher_kernel
    from repro_torch.kernels.ref import fisher_ref

    entry = fisher_kernel._entry()
    rows = []
    for name, n, d, c, dtypes in GENERAL:
        for dname in dtypes:
            dt = getattr(torch, dname)
            elt = torch.empty((), dtype=dt).element_size()
            nbytes = 2 * n * d * c * elt
            sets = max(1, math.ceil(2 * L2_BYTES / nbytes))
            bufs = [(torch.randn((n, d, c), generator=gen, device=dev).to(dt),
                     (0.1 * torch.randn((n, d, c), generator=gen,
                                        device=dev)).to(dt))
                    for _ in range(sets)]
            out = torch.empty((c,), device=dev)
            it, st = [0], [stream]

            def nxt():
                it[0] = (it[0] + 1) % sets
                return bufs[it[0]]

            def run():
                a, g = nxt()
                check(entry(a.data_ptr(), g.data_ptr(), None, out.data_ptr(),
                            n, d, c, 1.0 / (2 * n), 0,
                            0 if dt == torch.float32 else 1, st[0]),
                      "fisher_fwd")

            def plain():
                fisher_ref(*nxt())

            def einsum():
                a, g = nxt()
                u = torch.einsum("ndc,ndc->nc", a, g)
                torch.einsum("nc,nc->c", u, u).div_(2 * n)

            it[0] = sets - 1
            run()
            want = fisher_ref(*bufs[0])
            torch.cuda.synchronize()
            err = (out - want).abs().max().item()
            ms, pms, lms = timed(run), timed(plain), timed(einsum)
            gms, glms = graphed(run, st, 20), graphed(einsum, st, 20)
            st[0] = stream
            bms, by = bound(nbytes + 4 * c, 2 * n * d * c + 3 * n * c,
                            PEAK[dname])
            rows.append({"name": f"fisher {name}", "shape": [n, d, c],
                         "dtype": dname, "ms": ms[0], "ms_min": ms[1],
                         "ms_max": ms[2], "plain_ms": pms[0],
                         "library_ms": lms[0], "graph_ms": gms[0],
                         "graph_ms_min": gms[1], "graph_ms_max": gms[2],
                         "library_graph_ms": glms[0], "bound_ms": bms,
                         "bound_by": by, "max_abs_err": err,
                         "buffer_sets": sets})
            del bufs
    return rows


def block_rows(dev, gen, stream) -> List[Dict[str, Any]]:
    import torch

    rows = []
    for blk in BLOCKS:
        rows += block_shape(dev, gen, stream, *blk)
    for blk in BLOCKS:
        if blk[0] in BLOCKS_F32:
            rows += block_shape(dev, gen, stream, *blk, dt=torch.float32)
    return rows


def block_shape(dev, gen, stream, model, b, sq, hq, hkv, d, sk, layers,
                q_offset, kv_len, dt=None) -> List[Dict[str, Any]]:
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention, flash_paged
    from repro_torch.kernels.ref import (
        flash_attention_cached_ref, flash_attention_paged_ref,
    )

    bf = torch.bfloat16 if dt is None else dt
    code = 1 if bf == torch.bfloat16 else 0
    dname = str(bf).split(".")[-1]
    elt = torch.empty((), dtype=bf).element_size()
    qo = torch.tensor(q_offset, dtype=torch.int32, device=dev)
    kl = torch.tensor(kv_len, dtype=torch.int32, device=dev)
    q = torch.randn((b, sq, hq, d), generator=gen, device=dev).to(bf)
    ks = torch.randn((layers, b, sk, hkv, d), generator=gen, device=dev).to(bf)
    vs = torch.randn((layers, b, sk, hkv, d), generator=gen, device=dev).to(bf)
    out = torch.empty_like(q)
    it = [0]

    def layer():
        it[0] = (it[0] + 1) % layers
        return it[0]

    c_entry, p_entry = flash_attention._entry(), flash_paged._entry()
    st = [stream]  # the stream a launch goes to: a graph's while captured

    def run_cached():
        i = layer()
        check(c_entry(q.data_ptr(), ks[i].data_ptr(), vs[i].data_ptr(),
                      out.data_ptr(), qo.data_ptr(), kl.data_ptr(), b, sq, sk,
                      hq, hkv, d, 1, 0, code, st[0]), "flash_cached_fwd")

    # pages of 16 over a permuted arena: the page i of sample j holds its
    # logical rows [16 i, 16 i + 16)
    mp = sk // PAGE
    n_pages = b * mp
    perm = torch.randperm(n_pages, generator=gen, device=dev)
    table = perm.view(b, mp).to(torch.int32).contiguous()
    for j, n in enumerate(kv_len):
        table[j, -(-n // PAGE):] = -1
    idx = table.long().clamp(min=0)
    kps = torch.empty((layers, n_pages, PAGE, hkv, d), device=dev, dtype=bf)
    vps = torch.empty_like(kps)
    kps[:, perm.view(b, mp)] = ks.view(layers, b, mp, PAGE, hkv, d)
    vps[:, perm.view(b, mp)] = vs.view(layers, b, mp, PAGE, hkv, d)

    def run_paged():
        i = layer()
        check(p_entry(q.data_ptr(), kps[i].data_ptr(), vps[i].data_ptr(),
                      out.data_ptr(), table.data_ptr(), qo.data_ptr(),
                      kl.data_ptr(), b, sq, hq, hkv, d, n_pages, PAGE, mp,
                      code, st[0]), "flash_paged_fwd")

    pos = torch.arange(sk, device=dev)
    qpos = qo[:, None].long() + torch.arange(sq, device=dev)[None, :]
    mask = ((pos[None, None, :] < kl[:, None, None])
            & (pos[None, None, :] <= qpos[..., None]))[:, None]
    qt = q.transpose(1, 2)

    def sdpa():
        i = layer()
        F.scaled_dot_product_attention(qt, ks[i].transpose(1, 2),
                                       vs[i].transpose(1, 2), attn_mask=mask,
                                       enable_gqa=True)

    def gather_sdpa():
        i = layer()
        kk = kps[i][idx].reshape(b, sk, hkv, d).transpose(1, 2)
        vv = vps[i][idx].reshape(b, sk, hkv, d).transpose(1, 2)
        F.scaled_dot_product_attention(qt, kk, vv, attn_mask=mask,
                                       enable_gqa=True)

    kv_rows, keys = block_pairs(sq, q_offset, kv_len)
    nbytes = elt * (2 * b * sq * hq * d + 2 * kv_rows * hkv * d) + 8 * b
    nops = 4 * d * hq * keys
    rows = []
    for what, run, ref, lib, extra in (
            ("flash_cached", run_cached,
             lambda i: flash_attention_cached_ref(q, ks[i], vs[i],
                                                  q_offset=qo, kv_len=kl),
             sdpa, 0),
            ("flash_paged", run_paged,
             lambda i: flash_attention_paged_ref(q, kps[i], vps[i], table,
                                                 q_offset=qo, kv_len=kl),
             gather_sdpa, 4 * table.numel())):
        it[0] = layers - 1
        run()
        want = ref(0)
        torch.cuda.synchronize()
        err = (out.float() - want.float()).abs().max().item()
        ms = timed(run)
        lms = timed(lib)
        gms, glms = graphed(run, st, 2 * layers), graphed(lib, st, 2 * layers)
        st[0] = stream
        bms, by = bound(nbytes + extra, nops, PEAK[dname])
        tag = "" if code else " f32"
        rows.append({"name": f"{what} {model} block prefill{tag}",
                     "shape": [b, sq, hq, hkv, d, sk], "dtype": dname,
                     "ms": ms[0], "ms_min": ms[1], "ms_max": ms[2],
                     "library_ms": lms[0], "graph_ms": gms[0],
                     "graph_ms_min": gms[1], "graph_ms_max": gms[2],
                     "library_graph_ms": glms[0], "bound_ms": bms,
                     "bound_by": by, "max_abs_err": err})
    return rows


def main(out: Optional[str] = None, only=ROWS) -> Dict[str, Any]:
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("redesign_bench: no CUDA device")
    from repro_torch.kernels import build

    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    build.build_all(("flash_aligned", "fisher", "flash_cached",
                     "flash_paged"))
    built = time.perf_counter() - t0
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rows: List[Dict[str, Any]] = []
    if "aligned" in only:
        rows += aligned_rows(dev, gen, stream)
    if "fisher" in only:
        rows.append(fisher_row(dev, gen, stream))
    if "general" in only:
        rows += general_rows(dev, gen, stream)
    if "block" in only:
        rows += block_rows(dev, gen, stream)
    for r in rows:
        extra = (f", 3xTF32 bound {r['bound_tf32x3_ms']:.5f} ms"
                 if "bound_tf32x3_ms" in r else "")
        graph = (f", in a CUDA graph {r['graph_ms']:.4f} ms "
                 f"({r['graph_ms_min']:.4f}-{r['graph_ms_max']:.4f}), "
                 f"library {r['library_graph_ms']:.4f} ms"
                 if "graph_ms" in r else "")
        plain = (f", plain {r['plain_ms']:.4f} ms" if "plain_ms" in r
                 else "")
        print(f"[redesign] {r['name']} {r['shape']} {r['dtype']}: "
              f"{r['ms']:.4f} ms ({r['ms_min']:.4f}-{r['ms_max']:.4f}){plain}, "
              f"library {r['library_ms']:.4f} ms{graph}, bound "
              f"{r['bound_ms']:.5f} "
              f"ms ({r['bound_by']}){extra}, max abs err "
              f"{r['max_abs_err']:.3g}", flush=True)
    rec = {"bench": "redesign", "root": ROOT, "build_s": built,
           "device": torch.cuda.get_device_name(dev), "nvidia_smi": _smi(),
           "torch": torch.__version__, "rows": rows}
    if out:
        os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
        with open(out, "w") as f:
            json.dump(rec, f, indent=1)
    print(json.dumps(rec), flush=True)
    return rec


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None)
    ap.add_argument("--only", default=",".join(ROWS),
                    help="comma-separated subset of " + ", ".join(ROWS))
    a = ap.parse_args()
    main(a.out, tuple(a.only.split(",")))
