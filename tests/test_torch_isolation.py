"""The port installs on a machine that has only torch: nothing under
``src/repro_torch``, in ``benchmarks_torch/`` or in ``chip_smoke.py``
imports ``jax`` or the JAX package ``repro``."""
import ast
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
FILES = (sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
         + sorted((ROOT / "benchmarks_torch").glob("*.py"))
         + [ROOT / "chip_smoke.py"])
BANNED = ("jax", "jaxlib", "repro")


def imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_scan_covers_the_package():
    names = {p.name for p in FILES}
    assert {"engine.py", "layers.py", "ops.py", "chip_smoke.py",
            "fisher.py", "session.py", "flash_paged.py", "paging.py",
            "serve_profile.py", "adapt_profile.py", "grad_quant.py",
            "personalise.py", "compress.py", "ssm.py",
            "ssd_scan.py", "flash_aligned.py", "kernel_bench.py",
            "edge_cnn.py", "pipeline.py", "baselines.py", "common.py",
            "run.py", "accuracy_table.py", "memory_compute_table.py",
            "criterion_ablation.py", "channel_selection.py",
            "latency_breakdown.py", "layer_analysis.py",
            "meta_training_effect.py"} <= names


@pytest.mark.parametrize("path", FILES,
                         ids=[str(p.relative_to(ROOT)) for p in FILES])
def test_no_jax_or_reference_imports(path):
    bad = sorted({m for m in imported_roots(path) if m in BANNED})
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"
