"""Multi-pod dry run: the port of ``repro.launch.dryrun``.

Plans every (architecture x input shape) cell on the production meshes
and records its memory and cost terms for the roofline table
(``benchmarks_torch/roofline.py``):

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma-2b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --both-meshes --out results/dryrun_torch

The JAX package lowers and compiles each cell for 256 or 512 fake CPU
devices and reads XLA's analyses.  The port has no compiler and no SPMD
partitioner, so it runs the cell's step once on the **meta device**:
tensors of shape and dtype only, which allocate nothing and compute
nothing (the counterpart of ``jax.eval_shape`` and ``lower``), on any
machine and with no card.  :func:`~.op_analysis.analyse_ops` counts the
step's aten ops at the cell's full global shape; every kernel entry runs
its plain version on meta (a hand-written kernel is invisible to an op
count).  The record keeps the JAX record's keys, with these differences:

- ``flops_total``, ``bytes_total`` and ``peak_live_bytes`` are the
  step's totals; the per-device ``flops``, ``bytes``, ``bytes_floor`` and
  ``temp_size_in_bytes`` are those totals over ``n_chips`` (``"split":
  "even"``), where XLA's per-partition counts include replicated work;
- argument, output and alias bytes per device are exact, from the
  :class:`~..dist.sharding.ShardingRules` shard shapes;
- no collective is counted (``collective_bytes`` and ``t_collective_s``
  are None) and ``bottleneck`` is taken over compute and memory;
- the op table goes to ``<out>/ops/<tag>.json.gz`` in place of the HLO;
- a decode cell counts the MoE's capped expert queues, as the JAX
  cell does (``build_decode_step``; the serving engine runs them
  drop-free);
- ``--opt rowmoe`` is recorded with no effect: the port's MoE runs every
  expert over every row and has no dispatch placement to change.

Peaks are one H100's published rates (NVIDIA's data sheet, SXM, dense):
``PEAK_FLOPS`` by the model's dtype and ``HBM_BW``.  Cells are skipped
where the JAX package skips them (``shape_applicable``).  Nothing here
changes the process's environment.
"""
from __future__ import annotations

import argparse
import gzip
import json
import os
import time
import traceback
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from .. import configs
from ..core.backbones import lm_backbone
from ..core.policy import SelectedUnit, SparseUpdatePolicy
from ..core.sparse import _value_and_grad
from ..dist.sharding import ShardingRules
from ..models import transformer as T
from ..models.api import (ArchConfig, SHAPES_BY_NAME, ShapeConfig,
                          shape_applicable)
from ..optim import adam, apply_updates
from ..utils import named_tree_map, tree_leaves
from .mesh import make_production_mesh
from .op_analysis import analyse_ops

# one H100 (SXM, 700 W): dense tensor-core peaks by dtype, and HBM3
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
HBM_BW = 3.35e12  # B/s

META = torch.device("meta")


def _div_heads(cfg: ArchConfig, mesh) -> bool:
    tp = mesh.shape.get("model", 1)
    if cfg.family in ("ssm", "hybrid"):
        return cfg.n_ssm_heads % tp == 0
    return cfg.n_heads % tp == 0


# ---------------------------------------------------------------------------
# Static dry-run policy: representative TinyTrain selection
# ---------------------------------------------------------------------------


def dryrun_policy(cfg: ArchConfig, *, layer_frac: float = 0.25,
                  channel_ratio: float = 0.25,
                  align: int = 16) -> SparseUpdatePolicy:
    """Representative policy: last ``layer_frac`` of layers, every unit,
    ``channel_ratio`` of channels with shard-aligned strided indices.
    (Real deployments compute this from the Fisher probe; the dry run
    needs a static stand-in with the same cost structure.)"""
    bb = lm_backbone(cfg, tokens_per_batch=1, batch_size=1)
    h = int(cfg.n_layers * (1 - layer_frac))
    units = []
    for c in bb.unit_costs:
        if c.layer < h:
            continue
        k = max(1, int(c.n_channels * channel_ratio))
        if c.n_channels % align == 0 and k >= align:
            k = (k // align) * align
            per = c.n_channels // align
            kper = k // align
            idx = np.concatenate([
                np.arange(kper) + s * per for s in range(align)
            ])
        else:
            idx = np.arange(k)
        units.append(SelectedUnit(c.layer, c.kind,
                                  tuple(int(i) for i in np.sort(idx))))
    return SparseUpdatePolicy(horizon=h, units=tuple(units),
                              meta={"source": "dryrun_static"})


# ---------------------------------------------------------------------------
# Input specs (meta tensors; never allocated)
# ---------------------------------------------------------------------------


def input_specs(cfg: ArchConfig,
                shape: ShapeConfig) -> Dict[str, torch.Tensor]:
    """The cell's batch as meta tensors."""
    b, s = shape.global_batch, shape.seq_len
    dt = T.torch_dtype(cfg)

    def empty(shp, dtype):
        return torch.empty(shp, dtype=dtype, device=META)

    if shape.kind in ("train", "prefill"):
        specs = {}
        s_txt = s
        if cfg.family == "vlm":
            s_txt = s - cfg.n_img_tokens
            specs["image_embeds"] = empty(
                (b, cfg.n_img_tokens, cfg.img_embed_dim), dt)
        if cfg.is_encoder_decoder:
            specs["frames"] = empty((b, cfg.enc_len, cfg.d_model), dt)
        specs["tokens"] = empty((b, s_txt), torch.int32)
        if shape.kind == "train":
            specs["labels"] = empty((b, s_txt), torch.int32)
        return specs
    # decode: one new token with a seq_len KV cache
    specs = {"tokens": empty((b, 1), torch.int32)}
    if cfg.is_encoder_decoder:
        specs["enc_out"] = empty((b, cfg.enc_len, cfg.d_model), dt)
    return specs


def cache_specs(cfg: ArchConfig, shape: ShapeConfig) -> Dict[str, Any]:
    return T.init_caches(cfg, shape.global_batch, shape.seq_len,
                         device=META)


# ---------------------------------------------------------------------------
# Step builders
# ---------------------------------------------------------------------------


def build_train_step(cfg: ArchConfig, policy: SparseUpdatePolicy,
                     logit_chunk: int = 128):
    """(step, opt): step(params, deltas, opt_state, batch) -> (deltas,
    opt_state, loss), one Adam update of the deltas under autograd (the
    chunked attention's scores recomputed in the backward, as under
    ``jax.checkpoint``)."""
    opt = adam(1e-4, state_dtype=torch.bfloat16)

    def step(params, deltas, opt_state, batch):
        def f(d):
            return T.lm_loss(cfg, params, batch, deltas=d, plan=policy,
                             logit_chunk=logit_chunk)

        loss, g = _value_and_grad(f, deltas)
        upd, opt_state = opt.update(g, opt_state, deltas)
        return apply_updates(deltas, upd), opt_state, loss

    return step, opt


def build_prefill_step(cfg: ArchConfig):
    @torch.no_grad()
    def step(params, batch):
        x, positions, enc_out = T.build_inputs(cfg, params, batch)
        h, _ = T.forward_hidden(cfg, params, x, positions, enc_out=enc_out)
        return T.unembed(cfg, params, h[:, -1:])

    return step


def build_decode_step(cfg: ArchConfig):
    """The decode cell's step: one token a slot through
    ``decode_step`` at its default, the MoE's capped queue (``drop_free``
    False, as the JAX dry run's step counts it), not the serving
    engine's drop-free one."""

    @torch.no_grad()
    def step(params, batch, caches, pos):
        return T.decode_step(cfg, params, batch["tokens"], caches, pos,
                             enc_out=batch.get("enc_out"))

    return step


# ---------------------------------------------------------------------------
# Analysis
# ---------------------------------------------------------------------------


def analyse(counts: Dict[str, Any], n_chips: int, dtype: str,
            ops_path: Optional[str] = None) -> Dict[str, Any]:
    """A record's cost terms from an op count (:func:`analyse_ops`'s
    result or its saved table): totals, their even split over ``n_chips``
    and the roofline times over one H100's peaks.  The table is written
    to ``ops_path`` (gzip JSON) when given."""
    if ops_path:
        with gzip.open(ops_path, "wt") as f:
            json.dump(counts, f)
    ops = counts["ops"].values()
    flops = float(sum(r["flops"] for r in ops))
    bts = float(sum(r["bytes"] for r in ops))
    floor = float(counts["bytes_floor"])
    out: Dict[str, Any] = {
        "split": "even",
        "flops_total": flops, "bytes_total": bts,
        "bytes_floor_total": floor,
        "peak_live_bytes": float(counts["peak_live_bytes"]),
        "temp_size_in_bytes": int(counts["peak_live_bytes"] // n_chips),
        "flops": flops / n_chips, "bytes": bts / n_chips,
        "bytes_floor": floor / n_chips,
        "collective_bytes": None, "collectives": {},
    }
    out["t_compute_s"] = out["flops"] / PEAK_FLOPS[dtype]
    out["t_memory_s"] = out["bytes"] / HBM_BW
    out["t_memory_floor_s"] = out["bytes_floor"] / HBM_BW
    out["t_collective_s"] = None
    tms = {"compute": out["t_compute_s"], "memory": out["t_memory_s"]}
    out["bottleneck"] = max(tms, key=tms.get)
    return out


def count(fn: Callable, args: Tuple) -> Tuple[Any, Dict[str, Any]]:
    """Run ``fn(*args)`` under the op counters: (its result, the count)."""
    box = []

    def run(*a):
        box.append(fn(*a))
        return box[0]

    counts = analyse_ops(run, *args)
    return box[0], counts


def model_flops(cfg: ArchConfig, shape: ShapeConfig) -> float:
    """6·N_active·D reference (forward+backward for train; 2·N·D serve)."""
    bb = lm_backbone(cfg, tokens_per_batch=1, batch_size=1)
    per_token = sum(c.macs for c in bb.unit_costs)  # active MACs/token
    per_token += cfg.d_model * cfg.vocab  # unembed
    tokens = shape.global_batch * (shape.seq_len if shape.kind == "train" else
                                   (shape.seq_len if shape.kind == "prefill"
                                    else 1))
    mult = 6 if shape.kind == "train" else 2
    return mult * per_token * tokens


def _device_bytes(rules: ShardingRules, tree: Any, specs: Any) -> int:
    """Bytes of ``tree`` on one device under ``specs`` (a spec a leaf)."""
    return int(sum(tree_leaves(named_tree_map(
        lambda _, x, s: int(np.prod(rules.shard_shape(s, x.shape)))
        * x.element_size(), tree, specs))))


def _replicated(tree: Any) -> Any:
    return named_tree_map(lambda _, x: (None,) * x.dim(), tree)


# ---------------------------------------------------------------------------
# One cell
# ---------------------------------------------------------------------------


def run_cell(arch: str, shape_name: str, *, multi_pod: bool,
             opts: Tuple[str, ...] = (),
             policy_kw: Optional[Dict[str, Any]] = None,
             ops_path: Optional[str] = None,
             verbose: bool = True,
             counts: Optional[Dict[Any, Any]] = None) -> Dict[str, Any]:
    """One cell's record (see the module docstring).  ``counts``, a dict
    the caller keeps across cells, reuses the op count of a cell that
    differs only in its mesh: the step, and so its count, does not depend
    on the mesh (both production meshes have 16-way 'model', so the
    sequence-parallel choice is the same)."""
    cfg = configs.get_config(arch)
    shape = SHAPES_BY_NAME[shape_name]
    ok, reason = shape_applicable(cfg, shape)
    rec: Dict[str, Any] = {
        "arch": arch, "shape": shape_name,
        "mesh": "2x16x16" if multi_pod else "16x16",
        "opts": list(opts),
    }
    if not ok:
        rec["skipped"] = reason
        return rec

    mesh = make_production_mesh(multi_pod=multi_pod, devices=[META])
    n_chips = mesh.size
    # 'sp': sequence parallelism for archs whose heads don't divide TP
    sp = "sp" in opts and not _div_heads(cfg, mesh) and shape.kind != "decode"
    rules = ShardingRules(cfg, mesh, seq_parallel=sp)
    rec["seq_parallel"] = sp
    if "rowmoe" in opts:
        rec["ignored_opts"] = ["rowmoe"]

    params = T.init_params(cfg, None, device=META)
    params_sh = rules.params(params)
    batch = input_specs(cfg, shape)
    batch_sh = rules.batch(batch)
    # batch=1 long-context cells: replicate batch, shard caches on seq
    batch1 = shape.global_batch % rules.dp_size != 0
    if batch1:
        batch_sh = _replicated(batch)

    if shape.kind == "train":
        policy = dryrun_policy(cfg, **(policy_kw or {}))
        # SP: the CE chunk loop would slice the sharded seq dim; disable
        bb = lm_backbone(cfg, tokens_per_batch=1, batch_size=1)
        deltas = bb.init_deltas(policy, META)
        step, opt = build_train_step(cfg, policy,
                                     logit_chunk=0 if sp else 128)
        opt_state = opt.init(deltas)
        args = (params, deltas, opt_state, batch)
        arg_sh = (params_sh, rules.deltas(deltas),
                  rules.opt_state(opt_state), batch_sh)
        donated = (1, 2)
        rec["policy_units"] = len(policy.units)
    elif shape.kind == "prefill":
        step = build_prefill_step(cfg)
        args, arg_sh, donated = (params, batch), (params_sh, batch_sh), ()
    else:  # decode
        caches = cache_specs(cfg, shape)
        pos = torch.empty((shape.global_batch,), dtype=torch.int32,
                          device=META)
        step = build_decode_step(cfg)
        args = (params, batch, caches, pos)
        arg_sh = (params_sh, batch_sh,
                  rules.caches(caches, seq_sharded=batch1), (None,))
        donated = (2,)

    key = (arch, shape_name, sp, repr(sorted((policy_kw or {}).items())))
    t1 = time.perf_counter()
    if counts is not None and key in counts:
        out, cnt = counts[key]
        rec["count_reused"] = True
    else:
        out, cnt = count(step, args)
        if counts is not None:
            counts[key] = (out, cnt)
    rec["count_s"] = round(time.perf_counter() - t1, 2)
    cost = analyse(cnt, n_chips, cfg.dtype, ops_path=ops_path)

    if shape.kind == "train":
        out_sh = (arg_sh[1], arg_sh[2], ())
    else:
        logits = out if shape.kind == "prefill" else out[0]
        lsh = (_replicated({"x": logits}) if batch1
               else rules.batch({"x": logits}))["x"]
        out_sh = lsh if shape.kind == "prefill" else (lsh, arg_sh[2])
    rec["argument_size_in_bytes"] = _device_bytes(rules, list(args),
                                                  list(arg_sh))
    rec["output_size_in_bytes"] = _device_bytes(rules, out, out_sh)
    rec["alias_size_in_bytes"] = sum(
        _device_bytes(rules, args[i], arg_sh[i]) for i in donated)
    rec.update(cost)
    rec["n_chips"] = n_chips
    mf = model_flops(cfg, shape)
    rec["model_flops_total"] = mf
    if rec["flops_total"]:
        rec["model_flops_ratio"] = mf / rec["flops_total"]
    if verbose:
        print(f"[dryrun] {arch} x {shape_name} x {rec['mesh']}: "
              f"count {rec['count_s']}s bottleneck={rec['bottleneck']}")
        print(f"  memory: args={rec['argument_size_in_bytes']/1e9:.2f}GB "
              f"temp={rec['temp_size_in_bytes']/1e9:.2f}GB "
              f"out={rec['output_size_in_bytes']/1e9:.2f}GB (per device)")
        print(f"  cost: flops/dev={rec['flops']:.3e} "
              f"bytes/dev={rec['bytes']:.3e} (even split)")
    return rec


def cell_tag(arch: str, shape: str, multi_pod: bool, suffix: str = "") -> str:
    return f"{arch}__{shape}__{'2x16x16' if multi_pod else '16x16'}{suffix}"


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", type=str, default=None)
    ap.add_argument("--shape", type=str, default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", type=str, default="results/dryrun_torch")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--opt", type=str, default="",
                    help="comma list of optimizations: sp,rowmoe")
    ap.add_argument("--tag-suffix", type=str, default="")
    args = ap.parse_args(argv)
    opts = tuple(o for o in args.opt.split(",") if o)

    ops_dir = os.path.join(args.out, "ops")
    os.makedirs(ops_dir, exist_ok=True)
    archs = configs.lm_arch_ids() if (args.all or not args.arch) else [args.arch]
    shapes = list(SHAPES_BY_NAME) if (args.all or not args.shape) else [args.shape]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    counts: Dict[Any, Any] = {}
    t0 = time.perf_counter()
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                tag = cell_tag(arch, shape, mp, args.tag_suffix)
                path = os.path.join(args.out, tag + ".json")
                if args.skip_existing and os.path.exists(path):
                    print(f"[dryrun] skip existing {tag}")
                    continue
                try:
                    rec = run_cell(arch, shape, multi_pod=mp, opts=opts,
                                   ops_path=os.path.join(ops_dir,
                                                         tag + ".json.gz"),
                                   counts=counts)
                except Exception as e:  # a failed cell is recorded, not fatal
                    rec = {"arch": arch, "shape": shape,
                           "mesh": "2x16x16" if mp else "16x16",
                           "error": f"{type(e).__name__}: {e}",
                           "traceback": traceback.format_exc()[-4000:]}
                    print(f"[dryrun] FAIL {tag}: {rec['error']}")
                with open(path, "w") as f:
                    json.dump(rec, f, indent=2, default=str)
    print(f"[dryrun] wall {time.perf_counter() - t0:.1f}s")


if __name__ == "__main__":
    main()
