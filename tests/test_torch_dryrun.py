"""The port's planning tools against the JAX package's: ``launch/dryrun.py``
(the dry-run policy, the 6·N·D reference, the input specs and the skip set
for every architecture x shape cell), ``launch/reanalyze.py``'s
sparse-ideal FLOPs, and a whole cell on the meta device: its record's keys,
its per-device argument bytes from the ``ShardingRules`` shard shapes,
full-config cells of qwen2-1.5b and mamba2-1.3b counted without allocating
(kernel entries on meta take their plain versions and count no launch),
``main`` over both meshes (the second mesh reuses the first one's count),
a ``reanalyze`` round trip and the roofline table.  Neither package's dry
run may leave ``XLA_FLAGS`` changed."""
import gzip
import json
import os

import jax
import numpy as np
import pytest
import torch

from benchmarks_torch import roofline
from repro import configs as jconfigs
from repro.models.api import SHAPES_BY_NAME as JSHAPES
from repro.models.api import shape_applicable as jshape_applicable
from repro_torch import configs
from repro_torch.dist import ShardingRules
from repro_torch.kernels import ops
from repro_torch.launch import dryrun, reanalyze
from repro_torch.models.api import SHAPES, SHAPES_BY_NAME, ShapeConfig
from repro_torch.utils import named_tree_map

XLA_FLAGS_AT_IMPORT = os.environ.get("XLA_FLAGS")
CELLS = [(a, s.name) for a in configs.lm_arch_ids() for s in SHAPES]
# the production shapes' names at smoke size: batches that split over 16
# and 32 data positions, and a batch of one
SMOKE_SHAPES = {
    "train_4k": ShapeConfig("train_4k", 32, 32, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 64, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 64, 32, "decode"),
    "long_500k": ShapeConfig("long_500k", 128, 1, "decode"),
}
# the JAX record's keys, less XLA's own (compile times, the once-counted
# cost analysis, the generated code's size)
JAX_KEYS = {"arch", "shape", "mesh", "opts", "seq_parallel",
            "argument_size_in_bytes", "output_size_in_bytes",
            "temp_size_in_bytes", "alias_size_in_bytes", "flops", "bytes",
            "bytes_floor", "t_memory_floor_s", "collective_bytes",
            "collectives", "t_compute_s", "t_memory_s", "t_collective_s",
            "bottleneck", "n_chips", "model_flops_total",
            "model_flops_ratio"}
PORT_KEYS = {"flops_total", "bytes_total", "bytes_floor_total",
             "peak_live_bytes", "split", "count_s"}


@pytest.fixture(scope="module")
def jdry():
    """The JAX dry run and reanalyze modules, imported without keeping the
    dry run's process-wide ``XLA_FLAGS`` (512 host devices for every later
    JAX start in this worker and its subprocesses)."""
    saved = os.environ.get("XLA_FLAGS")
    from repro.launch import dryrun as jd
    from repro.launch import reanalyze as jr
    if saved is None:
        os.environ.pop("XLA_FLAGS", None)
    else:
        os.environ["XLA_FLAGS"] = saved
    assert os.environ.get("XLA_FLAGS") == saved
    return jd, jr


@pytest.fixture
def smoke(monkeypatch):
    """run_cell, main and reanalyze at the smoke configs and shapes."""
    monkeypatch.setattr(configs, "get_config", configs.get_reduced)
    monkeypatch.setattr(dryrun, "SHAPES_BY_NAME", SMOKE_SHAPES)
    monkeypatch.setattr(reanalyze, "SHAPES_BY_NAME", SMOKE_SHAPES)


# -- equal to the JAX package for every cell ---------------------------------


@pytest.mark.parametrize("arch", configs.lm_arch_ids())
def test_policy_and_references_equal_the_jax_dry_run(jdry, arch):
    jd, jr = jdry
    jcfg, cfg = jconfigs.get_config(arch), configs.get_config(arch)
    jpol, pol = jd.dryrun_policy(jcfg), dryrun.dryrun_policy(cfg)
    assert pol.horizon == jpol.horizon
    assert [(u.layer, u.kind, u.channels) for u in pol.units] == [
        (u.layer, u.kind, u.channels) for u in jpol.units]
    assert pol.meta == jpol.meta
    kw = dict(layer_frac=0.5, channel_ratio=0.5, align=8)
    assert [(u.layer, u.kind, u.channels)
            for u in dryrun.dryrun_policy(cfg, **kw).units] == [
        (u.layer, u.kind, u.channels)
        for u in jd.dryrun_policy(jcfg, **kw).units]
    for s in SHAPES:
        js = JSHAPES[s.name]
        assert dryrun.model_flops(cfg, s) == jd.model_flops(jcfg, js)
        assert reanalyze.sparse_ideal_flops(arch, s) == \
            jr.sparse_ideal_flops(arch, js)
        want = {k: (tuple(v.shape), str(v.dtype))
                for k, v in jd.input_specs(jcfg, js).items()}
        got = {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
               for k, v in dryrun.input_specs(cfg, s).items()}
        assert got == want and all(
            v.is_meta for v in dryrun.input_specs(cfg, s).values())


@pytest.mark.parametrize("arch,shape", CELLS)
def test_the_skip_set_is_the_jax_package(arch, shape):
    ok, reason = jshape_applicable(jconfigs.get_config(arch), JSHAPES[shape])
    if ok:
        assert dryrun.shape_applicable(configs.get_config(arch),
                                       SHAPES_BY_NAME[shape]) == (True, "")
        return
    rec = dryrun.run_cell(arch, shape, multi_pod=False, verbose=False)
    assert rec == {"arch": arch, "shape": shape, "mesh": "16x16",
                   "opts": [], "skipped": reason}


# -- a cell on the meta device -----------------------------------------------


def device_bytes(rules, tree, specs):
    out = []
    named_tree_map(lambda _, x, s: out.append(
        int(np.prod(rules.shard_shape(s, x.shape))) * x.element_size()),
        tree, specs)
    return sum(out)


@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("shape", list(SMOKE_SHAPES))
def test_a_cell_records_the_jax_keys_and_shard_bytes(smoke, shape,
                                                      multi_pod):
    arch = "qwen2-1.5b" if shape != "long_500k" else "mamba2-1.3b"
    rec = dryrun.run_cell(arch, shape, multi_pod=multi_pod, verbose=False)
    keys = JAX_KEYS | PORT_KEYS | (
        {"policy_units"} if shape == "train_4k" else set())
    assert keys <= set(rec) and "error" not in rec
    n = 512 if multi_pod else 256
    assert rec["n_chips"] == n and rec["split"] == "even"
    assert rec["flops"] == rec["flops_total"] / n
    assert rec["bytes"] == rec["bytes_total"] / n
    assert rec["collective_bytes"] is None and rec["t_collective_s"] is None
    assert rec["bottleneck"] in ("compute", "memory")
    assert rec["model_flops_ratio"] == (rec["model_flops_total"]
                                        / rec["flops_total"])
    # the argument bytes on one device, from the rules' shard shapes
    cfg, s = configs.get_config(arch), SMOKE_SHAPES[shape]
    mesh = dryrun.make_production_mesh(multi_pod=multi_pod, devices=["meta"])
    r = ShardingRules(cfg, mesh)
    params = dryrun.T.init_params(cfg, None, device="meta")
    batch = dryrun.input_specs(cfg, s)
    want = device_bytes(r, params, r.params(params))
    if s.global_batch % r.dp_size:
        want += sum(v.numel() * v.element_size() for v in batch.values())
    else:
        want += device_bytes(r, batch, r.batch(batch))
    if s.kind == "train":
        pol = dryrun.dryrun_policy(cfg)
        d = dryrun.lm_backbone(cfg, tokens_per_batch=1,
                               batch_size=1).init_deltas(pol, "meta")
        o = dryrun.build_train_step(cfg, pol)[1].init(d)
        want += (device_bytes(r, d, r.deltas(d))
                 + device_bytes(r, o, r.opt_state(o)))
        assert rec["alias_size_in_bytes"] == (
            device_bytes(r, d, r.deltas(d)) + device_bytes(r, o,
                                                           r.opt_state(o)))
        assert rec["policy_units"] == len(pol.units)
    elif s.kind == "decode":
        c = dryrun.cache_specs(cfg, s)
        cb = device_bytes(r, c, r.caches(c, seq_sharded=s.global_batch == 1))
        want += cb + 4 * s.global_batch
        assert rec["alias_size_in_bytes"] == cb
    assert rec["argument_size_in_bytes"] == want
    assert 0 < rec["output_size_in_bytes"]


def test_full_configs_count_on_meta_without_a_launch():
    """qwen2-1.5b's decode_32k and mamba2-1.3b's long_500k and train_4k at
    their published configs and global shapes: counted on the meta device
    (mamba2 through the SSD scan's plain chunked form), allocating
    nothing, launching no kernel."""
    def launches():
        return [ops.flash_attention_cached.launches,
                ops.flash_attention_paged.launches, ops.fisher.launches,
                ops.ssd_scan.launches, ops.ssd_scan.bwd_launches]

    before = launches()
    for arch, shape in (("qwen2-1.5b", "decode_32k"),
                        ("mamba2-1.3b", "long_500k"),
                        ("mamba2-1.3b", "train_4k")):
        rec = dryrun.run_cell(arch, shape, multi_pod=False, verbose=False)
        assert "error" not in rec and rec["flops_total"] > 0, (arch, shape)
        assert rec["model_flops_ratio"] > 0
    assert rec["policy_units"] == 12  # every SSD layer past the horizon
    assert launches() == before


def test_kernel_entries_take_meta_to_their_plain_versions():
    before = (ops.flash_attention_cached.launches, ops.ssd_scan.launches,
              ops.fisher.launches)
    q = torch.empty((2, 3, 4, 8), device="meta")
    kv = torch.empty((2, 16, 2, 8), device="meta")
    lens = torch.empty((2,), dtype=torch.int32, device="meta")
    out = ops.flash_attention_cached(q, kv, kv, q_offset=lens, kv_len=lens)
    assert out.is_meta and out.shape == q.shape
    x = torch.empty((1, 8, 2, 4), device="meta")
    y, st = ops.ssd_scan(x, torch.empty((1, 8, 2), device="meta"),
                         torch.empty((2,), device="meta"),
                         torch.empty((1, 8, 3), device="meta"),
                         torch.empty((1, 8, 3), device="meta"), chunk=4)
    assert y.is_meta and y.shape == x.shape and st.shape == (1, 2, 4, 3)
    a = torch.empty((4, 5, 6), device="meta")
    assert ops.fisher(a, a).shape == (6,)
    assert (ops.flash_attention_cached.launches, ops.ssd_scan.launches,
            ops.fisher.launches) == before


# -- main, reanalyze, the roofline table -------------------------------------


def test_main_reanalyze_and_the_roofline_table(smoke, tmp_path, jdry):
    env = dict(os.environ)
    out = str(tmp_path / "cells")
    dryrun.main(["--arch", "qwen2-1.5b", "--both-meshes", "--out", out])
    assert dict(os.environ) == env  # the port's dry run sets nothing
    dryrun.main(["--arch", "mamba2-1.3b", "--shape", "long_500k", "--out",
                 out, "--opt", "sp,rowmoe", "--tag-suffix", "_opt"])
    tags = sorted(os.listdir(out))
    assert len(tags) == 2 * 4 + 1 + 1  # cells, the opt cell, ops/
    recs = {t: json.load(open(os.path.join(out, t))) for t in tags
            if t.endswith(".json")}
    single = recs["qwen2-1.5b__train_4k__16x16.json"]
    multi = recs["qwen2-1.5b__train_4k__2x16x16.json"]
    assert multi.get("count_reused") and not single.get("count_reused")
    assert multi["flops_total"] == single["flops_total"]
    assert multi["flops"] == single["flops"] / 2
    assert recs["qwen2-1.5b__long_500k__16x16.json"]["skipped"]
    opt = recs["mamba2-1.3b__long_500k__16x16_opt.json"]
    assert opt["opts"] == ["sp", "rowmoe"] and opt["ignored_opts"] == [
        "rowmoe"] and opt["seq_parallel"] is False  # decode: no SP
    with gzip.open(os.path.join(out, "ops",
                                "qwen2-1.5b__train_4k__16x16.json.gz"),
                   "rt") as f:
        table = json.load(f)
    assert sum(r["flops"] for r in table["ops"].values()) == \
        single["flops_total"]
    assert table["ops"]["mm"]["count"] > 0

    # reanalyze: the same terms from the tables, sparse-ideal FLOPs added
    reanalyze.main(["--dir", out])
    again = {t: json.load(open(os.path.join(out, t))) for t in recs}
    for t, rec in recs.items():
        if "skipped" in rec:
            assert again[t] == rec
            continue
        for k in ("flops", "bytes", "bytes_floor", "t_compute_s",
                  "t_memory_s", "bottleneck", "model_flops_ratio"):
            assert again[t][k] == rec[k], (t, k)
        assert ("sparse_ideal_flops" in again[t]) == ("train_4k" in t)
    assert again["qwen2-1.5b__train_4k__16x16.json"][
        "sparse_ideal_flops"] == reanalyze.sparse_ideal_flops(
            "qwen2-1.5b", SMOKE_SHAPES["train_4k"])

    rows = roofline.table(out)
    assert rows[0] == ("arch,shape,mesh,t_compute_ms,t_memory_ms,"
                       "t_collective_ms,bottleneck,model_flops_ratio,"
                       "roofline_frac,status")
    ok = [r for r in rows[1:] if r.endswith(",ok")]
    assert len(ok) == 4 and any(",SKIP:" in r for r in rows)
    assert all(r.split(",")[5] == "" for r in ok)  # no collective term
    summary = roofline.main(out)
    assert summary[-2] == "# cells ok=4 skipped=1 (single-pod)"
    assert summary[-1] == "# multi-pod cells recorded=4"


def test_nothing_here_changed_xla_flags(jdry):
    """Runs last, after the module's JAX imports and dry runs: the variable
    is what it was when the module was collected."""
    assert os.environ.get("XLA_FLAGS") == XLA_FLAGS_AT_IMPORT
