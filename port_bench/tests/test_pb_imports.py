"""What the benchmark may import, and that BENCHMARK.json finds every file
it names.  Module names are compared whole, by their top-level part:
``repro_torch`` is the port, ``repro`` the JAX package."""
import ast
import json
import os
import re

import pb_smoke

from port_bench import inputs

BENCH = inputs.ROOT
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
# the yardstick: these import nothing of the port either
NO_PORT = ("reference", "flops.py", "work.py", "traffic.py", "peaks.py",
           "compare.py", "inputs.py", "trace.py")


def _sources():
    for d, _, files in os.walk(BENCH):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def _imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_no_jax_anywhere():
    seen = {}
    for path in _sources():
        bad = set(_imports(path)) & FORBIDDEN
        if bad:
            seen[os.path.relpath(path, BENCH)] = sorted(bad)
    assert not seen


def test_the_yardstick_imports_nothing_of_the_port():
    for path in _sources():
        rel = os.path.relpath(path, BENCH)
        if rel.startswith(NO_PORT):
            assert "repro_torch" not in set(_imports(path)), rel


def test_the_guard_compares_whole_names():
    from port_bench import bench

    assert "repro_torch" not in bench.FORBIDDEN
    assert set(bench.FORBIDDEN) == FORBIDDEN
    assert bench.forbidden_modules(["repro_torch.api", "numpy"]) == []
    assert bench.forbidden_modules(["repro.core", "jaxlib.xla", "flax"]) == [
        "flax", "jaxlib", "repro"]


NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_benchmark_json_finds_its_files():
    with open(os.path.join(pb_smoke.ROOT, "BENCHMARK.json")) as f:
        b = json.load(f)
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["port_bench"] and 1 <= b["run_seconds"] <= 51
    cfgs = {c["name"]: c for c in b["configs"]}
    e2e = {m["name"] for m in b["end_to_end"]}
    assert "setup_s" in e2e
    for c in b["configs"]:
        assert NAME.match(c["name"])
        assert os.path.exists(os.path.join(pb_smoke.ROOT, c["file"]))
        cf = inputs.load_json("configs", f"{c['name']}.json")
        assert cf["reduced"] == c["reduced"] and cf["source"] == c["source"]
    for w in b["workloads"]:
        assert NAME.match(w["name"]) and w["config"] in cfgs
        assert w["chips"] == 1 and len(w["why"]) <= 200
        inputs.load_json("traffic", f"{w['traffic']}.json")
        assert inputs.load_json("limits", f"{w['name']}.json")["limits"]
    names = set()
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["name"] not in names
        names.add(m["name"])
        assert os.path.exists(os.path.join(BENCH, "metrics",
                                           f"{m['name']}.py")), m["name"]
        assert m["better"] in ("lower", "higher")
    for m in b["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in b["per_layer"]:
        assert m["moves"] in e2e
        for w in m["workloads"]:  # each listed cell reports what it moves
            cell_e2e = [x["name"] for x in b["end_to_end"]
                        if w in x.get("workloads", [w])]
            assert m["moves"] in cell_e2e, (m["name"], w)
