"""The port's paper-table benches (``benchmarks_torch/``) on the CPU:
``memory_compute_table``'s rows equal the JAX package's ``method_costs``
for every paper CNN (pure arithmetic), and every other twin runs at its
smallest setting (2 meta-training episodes, 2 fine-tune steps, one target
domain, its cache under pytest's tmp_path) and gives its table's header
and rows; ``run`` appends a record under ROADMAP's Bench trajectory
convention."""
import json
import pathlib
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmarks import memory_compute_table as jtable  # noqa: E402
from benchmarks_torch import (  # noqa: E402
    accuracy_table, channel_selection, common, criterion_ablation,
    latency_breakdown, layer_analysis, memory_compute_table,
    meta_training_effect, run,
)

SMALL = dict(device="cpu", meta_episodes=2, iters=2, domains=("glyphs",),
             episodes_per_domain=1)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def cache(tmp_path_factory):
    return str(tmp_path_factory.mktemp("meta_cache"))


@pytest.mark.parametrize("arch", sorted(jtable.EDGE_CNNS))
def test_memory_compute_rows_equal_reference(arch):
    assert memory_compute_table.method_costs(arch) == jtable.method_costs(arch)


def test_meta_train_caches(cache):
    bb, p = common.meta_train("tiny", episodes=2, device="cpu",
                              cache_dir=cache)
    bb2, q = common.meta_train("tiny", episodes=2, device="cpu",
                               cache_dir=cache)
    assert len(list(pathlib.Path(cache).glob("meta_torch_tiny_2_0_*.pt"))) == 1
    for a, b in zip(p, q):
        assert all(torch.equal(a[k], b[k]) for k in a)
    init = bb.init(torch.Generator().manual_seed(0))
    assert not torch.equal(init[0]["w"], p[0]["w"])  # two updates moved it


TABLES = [
    (accuracy_table, "arch,method,glyphs,avg,train_s",
     len(accuracy_table.METHODS)),
    (channel_selection, "channel_mode,glyphs,avg",
     len(channel_selection.MODES)),
    (criterion_ablation, "variant,avg_accuracy",
     len(criterion_ablation.VARIANTS)),
    (latency_breakdown, "method,fisher_s,train_s,total_s,fisher_pct,"
     "steps_per_sec,host_transfers", 2),
    (meta_training_effect, "method,no_meta_acc,meta_acc,gain_pp",
     len(meta_training_effect.METHODS)),
    (layer_analysis, "layer,block,kind,gain_pp,gain_per_kparam,"
     "gain_per_mmac", 2),
]


@pytest.mark.parametrize("mod, header, rows", TABLES,
                         ids=[m.__name__.split(".")[-1] for m, _, _ in TABLES])
def test_twin_prints_its_table(mod, header, rows, cache):
    kw = dict(SMALL, cache_dir=cache)
    if mod is layer_analysis:
        kw = dict(device="cpu", meta_episodes=2, iters=2, max_layers=2,
                  cache_dir=cache)
    lines = mod.main(**kw)
    body = [x for x in lines if not x.startswith("#")]
    assert body[0] == header
    assert len(body) == 1 + rows
    assert all(x.count(",") == header.count(",") for x in body)


def test_run_appends_a_record(tmp_path, capsys):
    out = tmp_path / "BENCH_torch_paper_tables.json"
    rc = run.main(["--only", "memory_compute_table", "--device", "cpu",
                   "--out", str(out), "--tree", "test"])
    assert rc == 0
    text = capsys.readouterr().out
    assert "arch,method,mem_MB,mem_ratio,backward_MACs_M,mac_ratio" in text
    recs = json.loads(out.read_text())
    assert len(recs) == 1
    rec = recs[0]
    assert rec["bench"] == "memory_compute_table"
    assert rec["device"] == "cpu" and rec["torch"] == torch.__version__
    assert rec["tree"] == "test" and "commit" in rec
    assert len(rec["lines"]) == 1 + 3 * 5
