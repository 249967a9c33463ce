"""Recompute dry-run cells from their saved op tables (no new count): the
port of ``repro.launch.reanalyze``.

    PYTHONPATH=src python -m repro_torch.launch.reanalyze --dir results/dryrun_torch

Each cell's terms (FLOPs, bytes, their even split, the roofline times and
the bottleneck) are recomputed from ``<dir>/ops/<tag>.json.gz``, the op
table :mod:`.dryrun` saved in place of the JAX package's HLO text.  Train
cells also get the *sparse-ideal* FLOPs: the least work the TinyTrain step
needs (the forward everywhere, dX through the backprop span and dW for the
selected channels, by the paper's cost model), the denominator of the
useful-compute fraction in the roofline table.
"""
from __future__ import annotations

import argparse
import glob
import gzip
import json
import os

from .. import configs
from ..core.backbones import lm_backbone
from ..core.criterion import policy_backward_macs
from ..models.api import SHAPES_BY_NAME
from .dryrun import analyse, dryrun_policy


def sparse_ideal_flops(arch: str, shape) -> float:
    """2x(fwd MACs + policy backward MACs) for the dry-run policy."""
    cfg = configs.get_config(arch)
    bb = lm_backbone(cfg, tokens_per_batch=1, batch_size=1)
    per_token = sum(c.macs for c in bb.unit_costs) + cfg.d_model * cfg.vocab
    tokens = shape.global_batch * shape.seq_len
    fwd = per_token * tokens
    policy = dryrun_policy(cfg)
    sel = {(u.layer, u.kind): u.n_channels for u in policy.units}
    costs = [
        type(c)(c.layer, c.kind, c.n_channels, c.n_params,
                c.macs * tokens, c.act_in_bytes, c.dx_macs * tokens)
        for c in bb.unit_costs
    ]
    bwd = policy_backward_macs(costs, sel, policy.horizon)
    return 2.0 * (fwd + bwd)


def reanalyze(path: str, ops_dir: str) -> bool:
    """Rewrite the cell at ``path`` from its op table; False (and nothing
    written) for a skipped or failed cell or one without a table."""
    with open(path) as f:
        rec = json.load(f)
    if "skipped" in rec or "error" in rec:
        return False
    tag = os.path.splitext(os.path.basename(path))[0]
    ops_path = os.path.join(ops_dir, tag + ".json.gz")
    if not os.path.exists(ops_path):
        return False
    with gzip.open(ops_path, "rt") as f:
        counts = json.load(f)
    rec.update(analyse(counts, rec["n_chips"],
                     configs.get_config(rec["arch"]).dtype))
    if rec["flops_total"]:
        rec["model_flops_ratio"] = rec["model_flops_total"] / rec["flops_total"]
    shape = SHAPES_BY_NAME[rec["shape"]]
    if shape.kind == "train":
        rec["sparse_ideal_flops"] = sparse_ideal_flops(rec["arch"], shape)
    with open(path, "w") as f:
        json.dump(rec, f, indent=2, default=str)
    return True


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="results/dryrun_torch")
    args = ap.parse_args(argv)
    ops_dir = os.path.join(args.dir, "ops")
    n = 0
    for path in sorted(glob.glob(os.path.join(args.dir, "*.json"))):
        if reanalyze(path, ops_dir):
            n += 1
            print(f"[reanalyze] {os.path.basename(path)}")
    print(f"[reanalyze] updated {n} cells")


if __name__ == "__main__":
    main()
