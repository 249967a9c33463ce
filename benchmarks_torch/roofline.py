"""The roofline table of the port's dry-run cells: the twin of
``benchmarks/roofline.py``.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --both-meshes --out results/dryrun_torch
    PYTHONPATH=src python -m repro_torch.launch.reanalyze --dir results/dryrun_torch
    python benchmarks_torch/roofline.py --dir results/dryrun_torch

Terms per (arch x shape) cell, from ``repro_torch.launch.dryrun``'s op
counts on the meta device, split evenly over the mesh's chips and set
against one H100's published peaks (NVIDIA's data sheet, SXM, 700 W):
  t_compute = FLOPs/device / peak FLOP/s of the model's dtype
              (989 TFLOP/s bf16, 67 TFLOP/s float32)
  t_memory  = bytes/device / HBM bandwidth (3.35 TB/s)
The collective term is blank: the port counts no collective.  The
dominant of the two, MODEL_FLOPS = 6·N_active·D, the useful-compute ratio
MODEL_FLOPS / FLOPs, and the roofline fraction: the useful work (the
sparse-ideal FLOPs of a train cell, else MODEL_FLOPS) at the bf16 peak
over the step's bound max(t_compute, t_memory).  These are counts over
spec peaks, not measurements.
"""
from __future__ import annotations

import argparse
import glob
import json
import os
from typing import Dict, List

BF16_PEAK = 989e12  # FLOP/s, one H100 SXM, dense


def load_cells(dirpath: str = "results/dryrun_torch") -> List[Dict]:
    cells = []
    for path in sorted(glob.glob(os.path.join(dirpath, "*.json"))):
        with open(path) as f:
            cells.append(json.load(f))
    return cells


def table(dirpath: str = "results/dryrun_torch",
          mesh: str = "16x16") -> List[str]:
    rows = [
        "arch,shape,mesh,t_compute_ms,t_memory_ms,t_collective_ms,"
        "bottleneck,model_flops_ratio,roofline_frac,status"
    ]
    for c in load_cells(dirpath):
        if c.get("mesh") != mesh:
            continue
        head = f"{c['arch']},{c['shape']},{c['mesh']}"
        if "skipped" in c:
            rows.append(f"{head},,,,,,,SKIP:{c['skipped']}")
            continue
        if "error" in c:
            rows.append(f"{head},,,,,,,ERROR")
            continue
        tc = c["t_compute_s"] * 1e3
        tm = c["t_memory_s"] * 1e3
        mf = c.get("sparse_ideal_flops") or c.get("model_flops_total", 0)
        t_useful = mf / c["n_chips"] / BF16_PEAK
        t_step = max(tc, tm) / 1e3
        frac = (t_useful / t_step) if t_step else 0.0
        rows.append(
            f"{head},{tc:.2f},{tm:.2f},,{c['bottleneck']},"
            f"{c.get('model_flops_ratio', 0):.3f},{frac:.3f},ok")
    return rows


def main(dirpath: str = "results/dryrun_torch") -> List[str]:
    out = table(dirpath)
    done = sum(1 for r in out[1:] if r.endswith(",ok"))
    skipped = sum(1 for r in out[1:] if ",SKIP" in r)
    out.append(f"# cells ok={done} skipped={skipped} (single-pod)")
    mp = [r for r in table(dirpath, mesh="2x16x16")[1:]
          if r.endswith(",ok") or ",SKIP" in r]
    out.append(f"# multi-pod cells recorded={len(mp)}")
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="results/dryrun_torch")
    for line in main(ap.parse_args().dir):
        print(line)
