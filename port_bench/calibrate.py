"""Readings that the limits of ``limits/<cell>.json`` are set from, on the
card at an adaptation cell's own size: for each seed, the program's gaps
against the float32 reference and, on the first ``--controls`` seeds,
the control's (the reference in the program's place with its products
in e4m3: the precision below the configuration's bf16) and the planted
half-batch fault's (the reference with its loss over half the query
rows, in the program's place).  Each side's gaps go through the harness's
own ``bench.judge`` under the cell's limits as the file holds them, and
its verdict is printed beside them.

    python3 port_bench/calibrate.py --workload <cell> --seeds 1,2,3 \\
        [--controls 3] [--out FILE]
    python3 port_bench/calibrate.py --workload <cell> --rejudge FILE

A seed needs no window: the check task alone, through the window's own
``adapt`` call.  A state left unchanged reads 1 by the measure (its
change is zero) and needs no run.  ``--rejudge`` judges the lines of an
earlier ``--out`` again under the limits the file holds now.  Prints one
JSON line a seed."""
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIDES = ("program", "control", "half_batch")


def verdicts(rec, limits):
    """``bench.judge`` of each side's gaps under ``limits``."""
    from port_bench import bench

    return {side: bench.judge({k: {"value": rec[side][k], "limit": v}
                               for k, v in limits.items()})
            for side in SIDES if side in rec}


def adapt_seed(ctx, controls: bool):
    import torch

    from port_bench.drivers import adapt as DA
    from port_bench.drivers import common as C
    from port_bench.reference import adapt as RA
    from port_bench.reference import ssm_lm as R

    api, session, profile, params = DA.build(ctx)
    mix, sz, dev = ctx.mix, ctx.sizes, ctx.device
    task = C.task_of(api, DA.traffic.episode(mix, sz.vocab, ctx.seed,
                                             DA.CHECK_TASK), mix["way"], "c")
    prog = DA.program_check(api, session, task, profile, mix["iters"],
                            mix["adam"]["b1"], dev)
    del session
    C.release(dev)
    ep = DA.episode_tensors(task, dev)
    steps = len(prog["losses"])
    ref = DA.readings(params, sz, ep, mix, prog["units"], steps)
    out = {"program": DA.gaps(prog, ref),
           "losses": {"program": prog["losses"], "reference": ref["losses"]}}
    if controls:
        fp8 = R.Prec("fp8")
        ctl_scores = RA.fisher(params, sz, ep, mix["max_way"],
                               prec=fp8).cpu()
        ctl_units = RA.topk_units(ctl_scores, prog["units"])
        ctl = DA.readings(params, sz, ep, mix, ctl_units, steps, prec=fp8,
                          scores=ctl_scores)
        ref_c = DA.readings(params, sz, ep, mix, ctl_units, steps,
                            scores=ref["scores"])
        out["control"] = DA.gaps(ctl, ref_c)
        out["losses"]["control"] = ctl["losses"]
        half = DA.readings(params, sz, ep, mix, prog["units"], steps,
                           scores=ref["scores"], drop_half=True)
        out["half_batch"] = DA.gaps(half, ref)
        out["losses"]["half_batch"] = half["losses"]
    out["policy"] = {"horizon": prog["horizon"],
                     "units": [(l, len(h)) for l, h in prog["units"]]}
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    return out


def main(argv):
    import argparse

    sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
    from port_bench import bench

    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--controls", type=int, default=None,
                    help="run the control and the fault on this many of "
                    "the first seeds (default: all)")
    ap.add_argument("--out", default=None)
    ap.add_argument("--rejudge", default=None)
    a = ap.parse_args(argv)
    limits = bench.limits_for(a.workload)
    if a.rejudge:
        with open(a.rejudge) as f:
            for line in f:
                rec = json.loads(line)
                print(json.dumps({"seed": rec["seed"],
                                  "correct": verdicts(rec, limits)}))
        return 0
    import torch

    cell = {w["name"]: w for w in bench.spec()["workloads"]}[a.workload]
    seeds = [int(s) for s in a.seeds.split(",")]
    n_ctl = len(seeds) if a.controls is None else a.controls
    for i, seed in enumerate(seeds):
        args = argparse.Namespace(seed=seed, seconds=0.0, trace=0)
        ctx = bench.Context(args, cell, torch.device("cuda", 0),
                            time.perf_counter())
        t = time.perf_counter()
        res = adapt_seed(ctx, i < n_ctl)
        res.update(correct=verdicts(res, limits), seed=seed,
                   workload=a.workload,
                   seconds=round(time.perf_counter() - t, 1))
        line = json.dumps(res)
        print(line, flush=True)
        if a.out:
            with open(a.out, "a") as f:
                f.write(line + "\n")
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
