"""The harness: finds the cell, its configuration, its traffic mix and its
metrics' readers by name, runs the mix's driver, judges the outputs and
prints the contract's last line."""
from __future__ import annotations

import argparse
import importlib.util
import json
import math
import os
import sys
from typing import Any, Callable, Dict, List, Optional

from . import inputs

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def spec() -> dict:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def cell_metrics(bench: dict, workload: str, trace: bool) -> List[dict]:
    """The metrics this cell reports in this kind of run: end-to-end ones
    without the trace, per-layer ones with it, each where its
    ``workloads`` name the cell (or everywhere without the key; a
    per-layer metric then wherever its ``moves`` metric is reported)."""
    e2e = [m for m in bench["end_to_end"]
           if workload in m.get("workloads", [workload])]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if workload in m.get("workloads", [workload])
            and ("workloads" in m or m["moves"] in names)]


def reader(name: str) -> Callable[[dict], Optional[float]]:
    """``metrics/<name>.py``'s ``read(record)``."""
    path = os.path.join(inputs.ROOT, "metrics", f"{name}.py")
    spec_ = importlib.util.spec_from_file_location(
        f"port_bench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec_)
    spec_.loader.exec_module(mod)
    return mod.read


def driver(kind: str):
    return importlib.import_module(f"port_bench.drivers.{kind}")


def forbidden_modules(names: Optional[List[str]] = None) -> List[str]:
    """The forbidden top-level names among ``names`` (the loaded modules
    by default), compared whole: ``repro_torch`` is not ``repro``."""
    names = list(sys.modules) if names is None else names
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def judge(checks: Dict[str, Dict[str, float]]) -> bool:
    """Every compared number finite and within its limit."""
    return bool(checks) and all(
        isinstance(c["value"], (int, float)) and math.isfinite(c["value"])
        and c["value"] <= c["limit"] for c in checks.values())


def limits_for(workload: str) -> Dict[str, float]:
    return inputs.load_json("limits", f"{workload}.json")["limits"]


def parse(argv: List[str]) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="port_bench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv: List[str], t0: float) -> int:
    args = parse(argv)
    bench = spec()
    cells = {w["name"]: w for w in bench["workloads"]}
    if args.workload not in cells:
        print(f"unknown workload {args.workload!r}", file=sys.stderr)
        return 2
    cell = cells[args.workload]
    import torch

    if (not torch.cuda.is_available()
            or torch.cuda.device_count() < cell["chips"]):
        print(f"{args.workload} needs {cell['chips']} NVIDIA card(s); "
              f"torch sees {torch.cuda.device_count()}", file=sys.stderr)
        return 3
    ctx = Context(args, cell, torch.device("cuda", 0), t0)
    rec = driver(ctx.mix["kind"]).run(ctx)
    return finish(ctx, rec, bench)


class Context:
    """What a driver needs: the run's arguments, the cell's configuration
    and mix, the device, the process's start, and the limits."""

    def __init__(self, args, cell: dict, device, t0: float):
        self.workload = cell["name"]
        self.seed = int(args.seed)
        self.seconds = float(args.seconds)
        self.trace = bool(args.trace)
        self.config = inputs.load_json("configs", f"{cell['config']}.json")
        self.sizes = inputs.Sizes(self.config["arch"])
        self.mix = inputs.load_json("traffic", f"{cell['traffic']}.json")
        self.device = device
        self.t0 = t0
        self.limits = limits_for(cell["name"])


def finish(ctx: Context, rec: Dict[str, Any], bench: dict) -> int:
    """Read the cell's metrics from the run's record, guard the imports,
    print the comparisons and the result's line."""
    found = forbidden_modules()
    if found:
        print(f"the run loaded {found}: the port's benchmark may import "
              "none of " + ", ".join(FORBIDDEN), file=sys.stderr)
        return 4
    metrics = {}
    for m in cell_metrics(bench, ctx.workload, ctx.trace):
        v = reader(m["name"])(rec)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    checks = rec["checks"]
    device = {"platform": "gpu", "kind": rec["device_kind"], "count": 1,
              "memory_peak_bytes": int(rec["peak_bytes"])}
    line: Dict[str, Any] = {
        "correct": judge(checks) and rec["failed"] == 0
        and rec["attempted"] > 0 and set(checks) == set(ctx.limits),
        "attempted": rec["attempted"], "failed": rec["failed"],
        "metrics": metrics, "device": device}
    if ctx.trace and rec.get("trace"):
        tr = rec["trace"]
        device["busy_s"] = tr["busy_s"]
        device["window_s"] = tr["window_s"]
        line["breakdown"] = {"device_ops": tr["device_ops"],
                             "idle_gaps": tr["idle_gaps"]}
    if "window" in rec:  # what the window held: counts, not metrics
        line["window"] = rec["window"]
    line["checks"] = checks
    for name, c in checks.items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0
