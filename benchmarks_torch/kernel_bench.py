#!/usr/bin/env python3
"""Kernel microbenchmarks of the port: the twin of
``benchmarks/kernel_bench.py`` at its quick and full shapes, on one card.

    python3 benchmarks_torch/kernel_bench.py [--full] [--device cpu]
        [--out BENCH_torch_kernels.json] [--commit SHA]

Each row runs one of the port's kernels through its ``kernels.ops`` entry
(or, for the page reads, the port's PyTorch path), named as the reference
names its rows, and gives:

- ``ms``: the median over 5 trials of enough calls to pass 1 ms each
  (CUDA events on the card), with ``ms_min``/``ms_max`` as its spread;
- ``plain_ms``: the plain PyTorch version (``kernels.ref``) on the same
  inputs; the reference's ``fisher_xla_ref`` row is the ``fisher`` row's
  plain column;
- ``bound_ms`` and ``bound_by``: the larger of the bytes the function must
  move (each input read once, each output written once) at 3.35 TB/s and
  its operations at 989 TFLOP/s (bf16, tensor cores) or 67 TFLOP/s (f32),
  counted for these inputs (visible query-key pairs for attention);
- ``library_ms``: one PyTorch call that computes the same function, where
  one exists (``F.scaled_dot_product_attention`` for the attention rows, a
  page gather before it for the paged rows; for ``fisher``, where none
  does, the pair of ``torch.einsum`` calls its ``port`` names), a
  yardstick the port never calls; else null;
- ``max_abs_err`` against the plain version (the paged rows: against the
  contiguous kernel on the same rows; the int8 unpack: against the fp
  read), and ``tol``, which it must not exceed times max(1, max |want|).

Inputs come from a seeded ``torch.Generator`` at the reference's shapes,
f32 as there (the values differ from JAX's).  Appends one record to
``BENCH_torch_kernels.json`` (ROADMAP's Bench trajectory convention):
torch's version, the device's name, ``nvidia-smi``'s name and power limit
on a card, the commit and the rows.  Runs on the card by default;
``--device cpu`` runs the plain paths as a correctness smoke test, no
speed claim.  Imports nothing of JAX or of the JAX package.
"""
from __future__ import annotations

import argparse
import datetime
import json
import math
import os
import statistics
import subprocess
import sys
import time
from typing import Any, Callable, Dict, List, Optional

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {"float32": 67e12, "bfloat16": 989e12}
ROW_FIELDS = ("name", "shape", "port", "ms", "ms_min", "ms_max", "trials",
              "inner", "plain_ms", "bound_ms", "bound_by", "library_ms",
              "max_abs_err", "tol", "want_max")
RECORD_FIELDS = ("bench", "quick", "device", "torch", "cuda", "nvidia_smi",
                 "commit", "created", "rows")


def _timer(dev):
    import torch

    def run(fn: Callable[[], Any], trials: int = 5):
        """(median, min, max ms a call, inner calls a trial)."""
        def once(n):
            if dev.type == "cuda":
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                for _ in range(n):
                    fn()
                end.record()
                end.synchronize()
                return start.elapsed_time(end) / n
            t0 = time.perf_counter()
            for _ in range(n):
                fn()
            return 1e3 * (time.perf_counter() - t0) / n

        fn()  # warm-up
        inner = max(1, math.ceil(1.0 / max(once(1), 1e-4)))
        per = [once(inner) for _ in range(trials)]
        return statistics.median(per), min(per), max(per), inner
    return run


def _bound(nbytes: float, nops: float, dtype: str):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, nops / PEAK_OPS[dtype]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def _err(got, want):
    got, want = got.float(), want.float()
    return (got - want).abs().max().item(), want.abs().max().item()


def attention_pairs(sq: int, sk: int, causal: bool, window: int,
                    q_offset: int = 0, kv_len: Optional[int] = None) -> int:
    """Visible (query, key) pairs of one sample and head: query i sits at
    q_offset + i and sees keys j < kv_len, j <= its position when causal,
    j > its position - window when windowed."""
    kv_len = sk if kv_len is None else kv_len
    n = 0
    for i in range(sq):
        qpos = q_offset + i
        hi = min(kv_len - 1, qpos) if causal else kv_len - 1
        lo = max(0, qpos - window + 1) if window else 0
        n += max(0, hi - lo + 1)
    return n


def _git_commit() -> Optional[str]:
    try:
        out = subprocess.run(["git", "rev-parse", "HEAD"], cwd=ROOT,
                             capture_output=True, text=True, timeout=30)
    except OSError:
        return None
    return out.stdout.strip() or None


def _smi() -> Optional[str]:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def run_rows(quick: bool, dev) -> List[Dict[str, Any]]:
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import ops, ref
    from repro_torch.models import ssm
    from repro_torch.optim import compress
    from repro_torch.serving import paging as PG

    gen = torch.Generator(device=dev).manual_seed(0)
    timed = _timer(dev)
    card = dev.type == "cuda"
    rows: List[Dict[str, Any]] = []

    def randn(*shape, scale=1.0):
        return scale * torch.randn(shape, generator=gen, device=dev)

    def row(name, shape, port, fn, plain, got, want, nbytes, nops, tol,
            dtype="float32", library=None):
        ms, lo, hi, inner = timed(fn)
        err, scale = _err(got, want)
        bound_ms, bound_by = _bound(nbytes, nops, dtype)
        rows.append({
            "name": name, "shape": shape, "port": port, "ms": ms,
            "ms_min": lo, "ms_max": hi, "trials": 5, "inner": inner,
            "plain_ms": timed(plain)[0], "bound_ms": bound_ms,
            "bound_by": bound_by,
            "library_ms": None if library is None else timed(library)[0],
            "max_abs_err": err, "tol": tol, "want_max": scale})

    # fisher: Eq. 2 over materialised activations and gradients
    n, d, c = (4, 512, 256) if quick else (16, 2048, 1024)
    a, g = randn(n, d, c), randn(n, d, c, scale=0.1)
    def einsum_pair():
        u = torch.einsum("ndc,ndc->nc", a, g)
        return torch.einsum("nc,nc->c", u, u).div_(2 * n)

    row("fisher", f"({n}x{d}x{c})",
        "csrc/fisher.cu; library: two calls, einsum('ndc,ndc->nc') then "
        "einsum('nc,nc->c') / (2n) (no single call computes Eq. 2)",
        lambda: ops.fisher(a, g), lambda: ref.fisher_ref(a, g),
        ops.fisher(a, g), ref.fisher_ref(a, g),
        nbytes=4 * (2 * n * d * c + c), nops=2 * n * d * c + 2 * n * c,
        tol=1e-5, library=einsum_pair)

    # flash attention, aligned mode: kernel 3
    b, s, hq, hkv, hd = (1, 512, 4, 2, 64) if quick else (2, 2048, 8, 2, 128)
    q, k, v = randn(b, s, hq, hd), randn(b, s, hkv, hd), randn(b, s, hkv, hd)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    row("flash_attention", f"({b}x{s}x{hq}x{hkv}x{hd}) causal",
        "csrc/flash_aligned.cu",
        lambda: ops.flash_attention(q, k, v, causal=True),
        lambda: ref.flash_attention_ref(q, k, v, causal=True),
        ops.flash_attention(q, k, v, causal=True),
        ref.flash_attention_ref(q, k, v, causal=True),
        nbytes=4 * (2 * b * s * hq * hd + 2 * b * s * hkv * hd),
        nops=4 * hd * hq * b * attention_pairs(s, s, True, 0), tol=1e-4,
        library=lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True))

    # ssd scan, forward and (no TPU row) backward
    b, s, h, p, nst = (1, 256, 2, 32, 16) if quick else (2, 1024, 8, 64, 64)
    x = randn(b, s, h, p, scale=0.5)
    dt = F.softplus(randn(b, s, h))
    aa = -torch.exp(randn(h))
    bm, cm = randn(b, s, nst, scale=0.5), randn(b, s, nst, scale=0.5)
    shape = f"({b}x{s}x{h}x{p}x{nst})"
    # the recurrence's work: decay, outer product and add into the state,
    # and its product with C, per (token, head, p, n)
    cells = b * s * h * p * nst
    io = 4 * (2 * b * s * h * p + b * s * h + h + 2 * b * s * nst)
    row("ssd_scan", shape, "csrc/ssd_scan.cu (ssd_scan_fwd)",
        lambda: ops.ssd_scan(x, dt, aa, bm, cm, chunk=64),
        lambda: ref.ssd_scan_ref(x, dt, aa, bm, cm),
        ops.ssd_scan(x, dt, aa, bm, cm, chunk=64)[0],
        ref.ssd_scan_ref(x, dt, aa, bm, cm)[0],
        nbytes=io, nops=5 * cells, tol=1e-3)
    dy = randn(b, s, h, p)
    leaves = [t.clone().requires_grad_() for t in (x, dt, bm, cm)]
    y, _ = ops.ssd_scan(leaves[0], leaves[1], aa, leaves[2], leaves[3],
                        chunk=64, want_state=False)
    plain_leaves = [t.clone().requires_grad_() for t in (x, dt, bm, cm)]
    yp, _ = ssm.ssd_chunked_plain(plain_leaves[0], plain_leaves[1], aa,
                                  plain_leaves[2], plain_leaves[3], 64)
    got = torch.autograd.grad(y, leaves, dy, retain_graph=True)
    want = torch.autograd.grad(yp, plain_leaves, dy, retain_graph=True)
    scale = max(1.0, max(w.abs().max().item() for w in want))
    worst = max(_err(gg, ww)[0] for gg, ww in zip(got, want))
    row("ssd_scan_bwd", shape, "csrc/ssd_scan.cu (ssd_scan_bwd)",
        lambda: torch.autograd.grad(y, leaves, dy, retain_graph=True),
        lambda: torch.autograd.grad(yp, plain_leaves, dy, retain_graph=True),
        torch.zeros(()), torch.zeros(()),
        nbytes=2 * io + 4 * b * s * h * p, nops=10 * cells, tol=1e-3)
    rows[-1].update(max_abs_err=worst, want_max=scale)
    del leaves, plain_leaves, y, yp, got, want

    # cached flash, contiguous vs paged, on the serving hot paths: decode
    # (Sq 1) and block prefill (Sq 8); the pages hold a permutation of the
    # contiguous rows, so the paged kernel must give the contiguous one's
    b, hq, hkv, hd = (2, 4, 2, 64) if quick else (4, 8, 2, 128)
    ps, mp = (16, 16) if quick else (16, 64)
    cap = mp * ps
    k, v = randn(b, cap, hkv, hd), randn(b, cap, hkv, hd)
    perm = torch.randperm(b * mp, generator=gen, device=dev)
    table = perm.reshape(b, mp).to(torch.int32)
    kp = torch.zeros((b * mp, ps, hkv, hd), device=dev)
    vp = torch.zeros_like(kp)
    kp[table.reshape(-1).long()] = k.reshape(b * mp, ps, hkv, hd)
    vp[table.reshape(-1).long()] = v.reshape(b * mp, ps, hkv, hd)
    kv_len = torch.tensor([cap - 5, cap // 2] * (b // 2), dtype=torch.int32,
                          device=dev)
    kpos = torch.arange(cap, device=dev)
    ktt, vtt = k.transpose(1, 2), v.transpose(1, 2)
    for sq, tag in ((1, "decode"), (8, "prefill8")):
        qo = kv_len - sq
        q = randn(b, sq, hq, hd)
        qt = q.transpose(1, 2)
        qpos = qo[:, None].long() + torch.arange(sq, device=dev)[None, :]
        mask = ((kpos[None, None, :] < kv_len[:, None, None])
                & (kpos[None, None, :] <= qpos[..., None]))[:, None]
        pairs = sum(attention_pairs(sq, cap, True, 0, int(o), int(n))
                    for o, n in zip(qo.tolist(), kv_len.tolist()))
        kv_rows = int(kv_len.sum())
        nbytes = 4 * (2 * b * sq * hq * hd + 2 * kv_rows * hkv * hd) + 8 * b
        nops = 4 * hd * hq * pairs
        contig = ops.flash_attention_cached(q, k, v, q_offset=qo,
                                            kv_len=kv_len)
        paged = ops.flash_attention_paged(q, kp, vp, table, q_offset=qo,
                                          kv_len=kv_len)
        shape = f"({b}x{sq}x{hq}x{hd}) cache {cap}"
        row(f"cached_flash_contig_{tag}", shape, "csrc/flash_cached.cu",
            lambda: ops.flash_attention_cached(q, k, v, q_offset=qo,
                                               kv_len=kv_len),
            lambda: ref.flash_attention_cached_ref(q, k, v, q_offset=qo,
                                                   kv_len=kv_len),
            contig, ref.flash_attention_cached_ref(q, k, v, q_offset=qo,
                                                   kv_len=kv_len),
            nbytes=nbytes, nops=nops, tol=1e-4,
            library=lambda: F.scaled_dot_product_attention(
                qt, ktt, vtt, attn_mask=mask, enable_gqa=True))
        gidx = table.long()
        # the two kernels read the same rows in the same order (equal bits);
        # the two plain versions gather differently and round apart
        row(f"cached_flash_paged_{tag}", shape + f", pages of {ps}",
            "csrc/flash_paged.cu",
            lambda: ops.flash_attention_paged(q, kp, vp, table, q_offset=qo,
                                              kv_len=kv_len),
            lambda: ref.flash_attention_paged_ref(q, kp, vp, table,
                                                  q_offset=qo, kv_len=kv_len),
            paged, contig, nbytes=nbytes + 4 * table.numel(), nops=nops,
            tol=0.0 if card else 1e-5,
            library=lambda: F.scaled_dot_product_attention(
                qt, kp[gidx].reshape(b, cap, hkv, hd).transpose(1, 2),
                vp[gidx].reshape(b, cap, hkv, hd).transpose(1, 2),
                attn_mask=mask, enable_gqa=True))

    # the int8 page store: gather only (fp pages) vs gather + dequantise
    spec = PG.PagingSpec(page_size=ps, n_pages=b * mp, max_pages=mp)
    spec_i8 = PG.PagingSpec(page_size=ps, n_pages=b * mp, max_pages=mp,
                            int8=True)
    q8, sc = compress.rowwise_quant(kp, 2)
    fp_store, i8_store = {"pages": kp}, {"pages": q8, "scale": sc}
    read_fp = PG.read_rows(fp_store, table, spec, torch.float32)
    view = b * cap * hkv * hd
    shape = f"({b}x{cap}x{hkv}x{hd})"
    row("page_read_fp", shape, "serving/paging.read_rows (PyTorch)",
        lambda: PG.read_rows(fp_store, table, spec, torch.float32),
        lambda: kp[table.long()].reshape(b, cap, hkv, hd),
        read_fp, kp[table.long()].reshape(b, cap, hkv, hd),
        nbytes=8 * view + 4 * table.numel(), nops=0, tol=0.0)
    row("page_read_int8_unpack", shape, "serving/paging.read_rows (PyTorch)",
        lambda: PG.read_rows(i8_store, table, spec_i8, torch.float32),
        lambda: compress.rowwise_dequant(
            q8[table.long()], sc[table.long()],
            torch.float32).reshape(b, cap, hkv, hd),
        PG.read_rows(i8_store, table, spec_i8, torch.float32), read_fp,
        nbytes=5 * view + 4 * b * cap + 4 * table.numel(), nops=view,
        tol=1.0 / 127)

    # grad quant: int8 error feedback of one tensor
    g1, e1 = randn(4096, scale=0.01), torch.zeros(4096, device=dev)
    got, want = ops.grad_quant(g1, e1), ref.grad_quant_ref(g1, e1)
    row("grad_quant", "(4096)", "csrc/grad_quant.cu",
        lambda: ops.grad_quant(g1, e1), lambda: ref.grad_quant_ref(g1, e1),
        got[2], want[2], nbytes=4096 * (4 + 4 + 1 + 4) + 4, nops=8 * 4096,
        tol=0.0)
    if not torch.equal(got[0], want[0]):
        rows[-1]["max_abs_err"] = math.inf  # int8 codes must be equal
    return rows


def check(record: Dict[str, Any]) -> List[str]:
    """What is wrong with a record: missing fields, rows beyond their
    tolerance.  Empty when it is whole and every row agrees."""
    bad = [f"record lacks {k}" for k in RECORD_FIELDS if k not in record]
    for r in record.get("rows", []):
        bad += [f"row {r.get('name')} lacks {k}" for k in ROW_FIELDS
                if k not in r]
        if not (r.get("max_abs_err", math.inf)
                <= r.get("tol", 0.0) * max(1.0, r.get("want_max", 1.0))):
            bad.append(f"row {r.get('name')}: error {r.get('max_abs_err')} "
                       f"beyond {r.get('tol')} x max(1, {r.get('want_max')})")
    return bad


def main(quick: bool = True, device: str = "cuda",
         out: Optional[str] = None,
         commit: Optional[str] = None) -> Dict[str, Any]:
    """Run the rows, append the record to ``out`` (default: the repo's
    ``BENCH_torch_kernels.json``) and return it."""
    if os.path.join(ROOT, "src") not in sys.path:
        sys.path.insert(0, os.path.join(ROOT, "src"))
    import torch

    from repro_torch.utils import resolve_device

    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    rows = run_rows(quick, dev)
    record = {
        "bench": "kernel_bench", "quick": quick,
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu"),
        "torch": torch.__version__, "cuda": torch.version.cuda,
        "nvidia_smi": _smi() if dev.type == "cuda" else None,
        "commit": commit or _git_commit() or "unknown",
        "created": datetime.datetime.now(datetime.timezone.utc).isoformat(
            timespec="seconds"),
        "rows": rows,
    }
    path = out or os.path.join(ROOT, "BENCH_torch_kernels.json")
    records = []
    if os.path.exists(path):
        with open(path) as f:
            records = json.load(f)
    records.append(record)
    with open(path, "w") as f:
        json.dump(records, f, indent=1)
        f.write("\n")
    return record


def _cli() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--full", action="store_true",
                    help="the reference's full shapes (default: quick)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu, the plain-path smoke test")
    ap.add_argument("--out", default=None,
                    help="the JSON list to append to (default: "
                         "BENCH_torch_kernels.json at the repo root)")
    ap.add_argument("--commit", default=None,
                    help="commit to record where the tree has no git")
    args = ap.parse_args()
    rec = main(quick=not args.full, device=args.device, out=args.out,
               commit=args.commit)
    print(f"kernel_bench on {rec['device']} ({rec['nvidia_smi']}), torch "
          f"{rec['torch']}, commit {rec['commit']}")
    print("kernel,shape,ms,ms_min,ms_max,plain_ms,bound_ms,bound_by,"
          "library_ms,max_abs_err,tol")
    for r in rec["rows"]:
        lib = "" if r["library_ms"] is None else f"{r['library_ms']:.5f}"
        print(f"{r['name']},{r['shape']},{r['ms']:.5f},{r['ms_min']:.5f},"
              f"{r['ms_max']:.5f},{r['plain_ms']:.5f},{r['bound_ms']:.6f},"
              f"{r['bound_by']},{lib},{r['max_abs_err']:.3g},{r['tol']:g}")
    bad = check(rec)
    for b in bad:
        print(f"kernel_bench: FAILED: {b}", file=sys.stderr)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(_cli())
