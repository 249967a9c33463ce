#!/usr/bin/env python3
"""grad_quant (the int8 error-feedback kernel) per call, at leaf sizes of
the personalisation path, on one card.

    python3 benchmarks_torch/grad_quant_bench.py [--device cpu]

For each size, bf16 g and a float32 residual, cycled over 4 buffer sets
(4 x 41 MB at the largest leaf, past the 50 MB L2), timed two ways:

- ``ops_ms``: through ``kernels.ops.grad_quant``, as
  ``optim.compress.int8_compress`` calls it for each leaf: the wrapper's
  checks, its three allocations, the ctypes call and the launch; with
  ``ops_host_ms``, the host's time to issue one such call;
- ``entry_ms``: the C entry ``grad_quant_fwd`` alone on preallocated
  outputs, the launch as ``chip_smoke.py`` times it (null on the CPU).

Each is the median of 5 trials of CUDA events around enough calls to pass
2 ms, with its spread.  Sizes: 1,536 (a vector leaf), 4,096 (the kernel
bench's row), 262,144, 6,881,280 (the personalisation path's largest
leaf, qwen2-1.5b's d_model x d_ff / 2, ``chip_smoke.py``'s ``GQ_LEAF``)
and twice that.  Prints one line a size and, last, one JSON object with
``nvidia-smi``'s name and power limit.  It uses only ``ops.grad_quant``
and the C entry, so a copy of this file in another checkout's
``benchmarks_torch/`` measures that tree; run two trees alternately in one
call to compare them.  ``--device cpu`` times the plain version as a
smoke test, no speed claim.  Imports nothing of JAX or of the JAX package.
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
from typing import Any, Dict, Optional, Sequence

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZES = (1536, 4096, 262_144, 1536 * 4480, 2 * 1536 * 4480)
SETS = 4
SCRATCH_FLOATS = 2 + 1024  # the most scratch any version of the entry reads


def _nvidia_smi() -> Optional[str]:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip() or None
    except (OSError, subprocess.SubprocessError):
        return None


def _timer(dev):
    import torch

    def run(fn, trials: int = 5):
        """(median, min, max ms a call, median host ms to issue a call)."""
        def once(n):
            if dev.type == "cuda":
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                t0 = time.perf_counter()
                for _ in range(n):
                    fn()
                host = time.perf_counter() - t0
                end.record()
                end.synchronize()
                return start.elapsed_time(end) / n, 1e3 * host / n
            t0 = time.perf_counter()
            for _ in range(n):
                fn()
            ms = 1e3 * (time.perf_counter() - t0) / n
            return ms, ms

        fn()  # warm-up (and the build, at the first call of a process)
        inner = max(1, math.ceil(2.0 / max(once(1)[0], 1e-4)))
        per = [once(inner) for _ in range(trials)]
        dev_ms = [p[0] for p in per]
        return (statistics.median(dev_ms), min(dev_ms), max(dev_ms),
                statistics.median(p[1] for p in per))
    return run


def main(device: str = "cuda", sizes: Sequence[int] = SIZES
         ) -> Dict[str, Any]:
    """Time every size and return the record (also printed)."""
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import torch

    from repro_torch.kernels import grad_quant as GQ
    from repro_torch.kernels import ops

    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device (pass --device cpu for the smoke)")
    gen = torch.Generator(device=dev).manual_seed(0)
    timed = _timer(dev)
    rows = []
    for n in sizes:
        sets = [((0.01 * torch.randn(n, generator=gen, device=dev)
                  ).bfloat16(),
                 0.001 * torch.randn(n, generator=gen, device=dev))
                for _ in range(SETS)]
        it = [0]

        def next_set():
            it[0] = (it[0] + 1) % SETS
            return sets[it[0]]

        ops_ms, ops_lo, ops_hi, host_ms = timed(
            lambda: ops.grad_quant(*next_set()))
        entry = None
        if dev.type == "cuda":
            fn = GQ._entry()
            q = torch.empty(n, dtype=torch.int8, device=dev)
            e_out = torch.empty(n, device=dev)
            scratch = torch.empty(SCRATCH_FLOATS, device=dev)
            stream = torch.cuda.current_stream(dev).cuda_stream

            def run_entry():
                g, err = next_set()
                rc = fn(g.data_ptr(), err.data_ptr(), q.data_ptr(),
                        e_out.data_ptr(), scratch.data_ptr(),
                        n, 1, stream)
                if rc:
                    raise RuntimeError(f"grad_quant_fwd: cudaError {rc}")

            entry = timed(run_entry)
        row = {"n": n, "ops_ms": ops_ms, "ops_ms_min": ops_lo,
               "ops_ms_max": ops_hi, "ops_host_ms": host_ms,
               "entry_ms": None if entry is None else entry[0],
               "entry_ms_min": None if entry is None else entry[1],
               "entry_ms_max": None if entry is None else entry[2]}
        print(f"[grad_quant] n={n}: ops.grad_quant {ops_ms:.4f} ms "
              f"({ops_lo:.4f}-{ops_hi:.4f}; host issues one in "
              f"{host_ms:.4f} ms), C entry "
              + ("n/a" if entry is None else
                 f"{entry[0]:.4f} ms ({entry[1]:.4f}-{entry[2]:.4f})"),
              flush=True)
        rows.append(row)
        del sets
    rec = {"bench": "grad_quant", "device": (torch.cuda.get_device_name(dev)
                                             if dev.type == "cuda" else "cpu"),
           "nvidia_smi": _nvidia_smi() if dev.type == "cuda" else None,
           "torch": torch.__version__, "rows": rows}
    print(json.dumps(rec), flush=True)
    return rec


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    main(ap.parse_args().device)
