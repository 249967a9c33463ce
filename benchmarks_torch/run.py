"""Entry point of the port's paper-table benches: one module per paper
table or figure, the twin of ``benchmarks/run.py``.

    python -m benchmarks_torch.run [--full] [--only NAME] [--device cpu]
        [--out BENCH_torch_paper_tables.json] [--tree SHA]

Prints each table's CSV block and a ``name,us_per_call,derived`` summary,
and appends one record per table to ``BENCH_torch_paper_tables.json``
(ROADMAP's Bench trajectory convention): the bench, torch's version, the
device's name, ``nvidia-smi``'s name and power limit on a card, the
commit (from git, null in a copy without it) and, with ``--tree``, the
measured tree's ``git write-tree`` hash, the seconds and the table's
lines.  Runs on the card unless
``--device cpu`` is given (a correctness smoke test there, no speed
claim).  A failing table fails the run.
"""
from __future__ import annotations

import argparse
import datetime
import importlib
import json
import os
import subprocess
import sys
import time
from typing import List, Optional

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCHES = [
    ("memory_compute_table", "Table 2: backward memory & MACs"),
    ("latency_breakdown", "Tables 9/10: latency breakdown"),
    ("accuracy_table", "Table 1: accuracy vs baselines"),
    ("criterion_ablation", "Table 3: criterion ablation"),
    ("channel_selection", "Fig 4/6b: channel selection"),
    ("meta_training_effect", "Fig 6a: meta-training effect"),
    ("layer_analysis", "Fig 3: per-layer contribution"),
]


def _git_commit() -> Optional[str]:
    try:
        out = subprocess.run(["git", "rev-parse", "HEAD"], cwd=ROOT,
                             capture_output=True, text=True, timeout=30)
    except OSError:
        return None
    return out.stdout.strip() or None


def _smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def append_record(record: dict, path: str) -> None:
    records = []
    if os.path.exists(path):
        with open(path) as f:
            records = json.load(f)
    records.append(record)
    with open(path, "w") as f:
        json.dump(records, f, indent=1)
        f.write("\n")


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--only", default=None)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=os.path.join(
        ROOT, "BENCH_torch_paper_tables.json"))
    ap.add_argument("--tree", default=None,
                    help="the measured tree's `git write-tree` hash, for a "
                         "copy without git")
    args = ap.parse_args(argv)
    if os.path.join(ROOT, "src") not in sys.path:
        sys.path.insert(0, os.path.join(ROOT, "src"))
    import torch

    from repro_torch.utils import resolve_device

    dev = resolve_device(args.device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    head = {"quick": not args.full,
            "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                       else "cpu"),
            "torch": torch.__version__, "cuda": torch.version.cuda,
            "nvidia_smi": _smi() if dev.type == "cuda" else None,
            "commit": _git_commit(), "tree": args.tree}
    summary, failed = ["name,us_per_call,derived"], 0
    for name, desc in BENCHES:
        if args.only and args.only != name:
            continue
        print(f"\n=== {name}: {desc} ===", flush=True)
        mod = importlib.import_module(f"benchmarks_torch.{name}")
        t0 = time.perf_counter()
        try:
            lines = mod.main(quick=not args.full, device=args.device)
        except Exception as e:  # keep the other tables running
            failed += 1
            print(f"[bench] {name} FAILED: {type(e).__name__}: {e}")
            summary.append(f"{name},{(time.perf_counter() - t0)*1e6:.0f},"
                           f"FAILED:{type(e).__name__}")
            continue
        dt = time.perf_counter() - t0
        for line in lines:
            print(line)
        append_record({"bench": name, **head, "seconds": dt,
                       "created": datetime.datetime.now(
                           datetime.timezone.utc).isoformat(
                               timespec="seconds"),
                       "lines": lines}, args.out)
        derived = lines[-1].replace(",", ";") if lines else ""
        summary.append(f"{name},{dt*1e6:.0f},{derived}")
    print("\n=== summary ===")
    for line in summary:
        print(line)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
