"""The port's kernel bench (``benchmarks_torch/kernel_bench.py``) as a
CPU smoke test at the reference's quick shapes: every row of
``benchmarks/kernel_bench.py`` (its ``fisher_xla_ref`` as the ``fisher``
row's plain column) plus ``ssd_scan_bwd``, each with its time, spread,
plain time, bound and error within tolerance, appended as one record per
run under ROADMAP's Bench trajectory convention."""
import importlib.util
import json
import pathlib

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
ROWS = ["fisher", "flash_attention", "ssd_scan", "ssd_scan_bwd",
        "cached_flash_contig_decode", "cached_flash_paged_decode",
        "cached_flash_contig_prefill8", "cached_flash_paged_prefill8",
        "page_read_fp", "page_read_int8_unpack", "grad_quant"]


@pytest.fixture(scope="module")
def bench():
    spec = importlib.util.spec_from_file_location(
        "kernel_bench", ROOT / "benchmarks_torch" / "kernel_bench.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def run(bench, tmp_path_factory):
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    out = tmp_path_factory.mktemp("bench") / "BENCH_torch_kernels.json"
    try:
        rec = bench.main(quick=True, device="cpu", out=str(out),
                         commit="test")
    finally:
        torch.set_num_threads(before)
    return rec, out


def test_rows_are_the_references_and_agree(bench, run):
    rec, _ = run
    assert [r["name"] for r in rec["rows"]] == ROWS
    assert bench.check(rec) == []
    for r in rec["rows"]:
        assert r["ms_min"] <= r["ms"] <= r["ms_max"] and r["trials"] >= 5
        assert r["plain_ms"] > 0 and r["bound_ms"] > 0
        assert r["bound_by"] in ("bytes", "operations")
    lib = {r["name"] for r in rec["rows"] if r["library_ms"] is not None}
    assert lib == {"fisher", "flash_attention", "cached_flash_contig_decode",
                   "cached_flash_paged_decode", "cached_flash_contig_prefill8",
                   "cached_flash_paged_prefill8"}


def test_record_carries_the_convention_fields(bench, run):
    rec, out = run
    assert set(bench.RECORD_FIELDS) <= set(rec)
    assert rec["device"] == "cpu" and rec["nvidia_smi"] is None
    assert rec["torch"] == torch.__version__ and rec["commit"] == "test"
    assert json.loads(out.read_text()) == [json.loads(json.dumps(rec))]


def test_check_flags_missing_fields_and_errors(bench, run):
    rec, _ = run
    broken = dict(rec, rows=[dict(r) for r in rec["rows"]])
    del broken["commit"]
    broken["rows"][1]["max_abs_err"] = 1.0
    del broken["rows"][2]["bound_ms"]
    bad = bench.check(broken)
    assert "record lacks commit" in bad
    assert any(b.startswith("row flash_attention: error") for b in bad)
    assert "row ssd_scan lacks bound_ms" in bad


def test_attention_pairs_count_the_band():
    spec = importlib.util.spec_from_file_location(
        "kernel_bench_pairs", ROOT / "benchmarks_torch" / "kernel_bench.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert mod.attention_pairs(4, 4, True, 0) == 10
    assert mod.attention_pairs(4, 4, False, 0) == 16
    assert mod.attention_pairs(4, 4, True, 2) == 7
    assert mod.attention_pairs(2, 10, True, 0, q_offset=5, kv_len=7) == 13
