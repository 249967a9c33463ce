"""The port's public surface against the JAX package's, read with ``ast``
(neither package is imported, so the test is cheap and leaves
``XLA_FLAGS`` alone).

For every module of ``src/repro`` (one case each), every public name has
a counterpart in the port's module at the same relative path, or stands
in one of two tables:

- ``RENAMED`` maps a JAX entry to the port's, which must exist;
- ``ABSENT`` maps a JAX entry to the one-line reason the port does not
  have it, and the port must really lack it, so the table cannot go stale.

A JAX module's public names are the top-level functions, classes and
assigned names that do not start with ``_``, and the names it re-exports:
``from .x import name`` in a package ``__init__`` or on a line marked
``noqa: F401``.  A public class's public methods and constructor
parameters (``__init__``'s, or a dataclass's fields) count, and so does
every parameter of a public function or method that both packages have.
In the port any top-level binding counts, imports included.

Entries are ``"path"`` (a whole module), ``"path::name"``,
``"path::Class.method"`` and ``"path::function(param)"``.
"""
import ast
import pathlib

import pytest

SRC = pathlib.Path(__file__).resolve().parents[1] / "src"
JAX, PORT = SRC / "repro", SRC / "repro_torch"

_PALLAS = ("a Pallas TPU kernel: its hand-written CUDA kernel sits behind "
           "the port's kernels/ops.py entry of the same job")
_TILING = ("a Pallas tiling or interpret-mode argument; the CUDA kernel "
           "plans its own launch")
_COLLECTIVE = ("the dry run's collective term reads TPU interconnect "
               "constants and compiled SPMD HLO; the port has neither")
_HLO_ARG = ("a compiled XLA executable or a path of saved HLO; the port "
            "counts aten ops and saves its op table through ops_path / "
            "ops_dir")
_PER_BLOCK = ("a per-block random initialiser: the port draws whole stacks "
              "in init_params, and the reference's weights cross through "
              "bridge.py")

RENAMED = {
    "kernels/ops.py::paged_flash_attention":
        "kernels/ops.py::flash_attention_paged",
    # the cached block prefill is an entry of its own in the port
    "kernels/ops.py::flash_attention(q_offset)":
        "kernels/ops.py::flash_attention_cached(q_offset)",
    "kernels/ops.py::flash_attention(kv_len)":
        "kernels/ops.py::flash_attention_cached(kv_len)",
    "checkpoint/manager.py::CheckpointManager.restore(shardings)":
        "checkpoint/manager.py::CheckpointManager.restore(devices)",
    "checkpoint/manager.py::CheckpointManager.restore_latest(shardings)":
        "checkpoint/manager.py::CheckpointManager.restore_latest(devices)",
    # a JAX PRNG key in, an explicit torch.Generator in the port
    "models/transformer.py::init_params(key)":
        "models/transformer.py::init_params(generator)",
    "models/ssm.py::ssd_init(key)": "models/ssm.py::ssd_init(generator)",
    "models/edge_cnn.py::cnn_init(key)":
        "models/edge_cnn.py::cnn_init(generator)",
    "core/baselines.py::tinytl_adapter_init(key)":
        "core/baselines.py::tinytl_adapter_init(generator)",
}

ABSENT = {
    "kernels/fisher.py::fisher_pallas": _PALLAS,
    "kernels/flash_attention.py::flash_attention_pallas": _PALLAS,
    "kernels/flash_attention.py::flash_attention_paged_pallas": _PALLAS,
    "kernels/grad_quant.py::grad_quant_pallas": _PALLAS,
    "kernels/ssd_scan.py::ssd_scan_pallas": _PALLAS,
    "kernels/flash_attention.py::NEG_INF":
        "the Pallas kernels' mask fill; the CUDA kernels' is NEG_INIT in "
        "csrc/flash_block.cuh",
    "kernels/ops.py::fisher(block_d)": _TILING,
    "kernels/ops.py::fisher(block_c)": _TILING,
    "kernels/ops.py::fisher(interpret)": _TILING,
    "kernels/ops.py::fisher_auto(block_d)": _TILING,
    "kernels/ops.py::fisher_auto(block_c)": _TILING,
    "kernels/ops.py::fisher_tapgrads(block_c)": _TILING,
    "kernels/ops.py::flash_attention(block_q)": _TILING,
    "kernels/ops.py::flash_attention(block_k)": _TILING,
    "kernels/ops.py::flash_attention(interpret)": _TILING,
    "kernels/ops.py::paged_flash_attention(block_q)": _TILING,
    "kernels/ops.py::paged_flash_attention(interpret)": _TILING,
    "kernels/ops.py::paged_flash_attention(causal)":
        "kernel 4 is causal only: every paged read is a causal block "
        "prefill or decode step, as in the JAX engine",
    "kernels/ops.py::ssd_scan(interpret)": _TILING,
    "kernels/ops.py::grad_quant(block)": _TILING,
    "kernels/ops.py::grad_quant(interpret)": _TILING,
    "launch/hlo_analysis.py":
        "parses XLA's HLO text; the port has no compiler and counts the "
        "step's aten ops in launch/op_analysis.py (analyse_ops)",
    "launch/dryrun.py::ICI_BW": _COLLECTIVE,
    "launch/dryrun.py::ICI_LINKS": _COLLECTIVE,
    "launch/dryrun.py::COLLECTIVE_RE": _COLLECTIVE,
    "launch/dryrun.py::SHAPE_RE": _COLLECTIVE,
    "launch/dryrun.py::DTYPE_BYTES": _COLLECTIVE,
    "launch/dryrun.py::collective_bytes": _COLLECTIVE,
    "launch/dryrun.py::analyse(compiled)": _HLO_ARG,
    "launch/dryrun.py::analyse(hlo_path)": _HLO_ARG,
    "launch/dryrun.py::run_cell(hlo_path)": _HLO_ARG,
    "launch/reanalyze.py::reanalyze(hlo_dir)": _HLO_ARG,
    "dist/context.py::constrain":
        "an SPMD sharding constraint; the port has no SPMD partitioner "
        "(the dry run records --opt rowmoe in ignored_opts)",
    "serving/engine.py::ServeEngine.scan_ticks":
        "the compiled lax.scan chunk; the port's chunk is host-issued "
        "predicated ticks, and a CUDA graph of it is ROADMAP item 11.2",
    "serving/engine.py::ServeEngine.scan_compiles":
        "counts scan_ticks' compiles; the port compiles no chunk program",
    "serving/faults.py::FaultConfig(nan_loss_steps)":
        "the port's adapt loop takes nan_loss_steps as its own argument "
        "(adapt_task, TinyTrainSession.adapt)",
    "utils.py::key_iter":
        "a stream of JAX PRNG keys; the port takes explicit torch.Generators",
    "models/layers.py::dense_init": _PER_BLOCK,
    "models/layers.py::embed_init": _PER_BLOCK,
    "models/layers.py::norm_init": _PER_BLOCK,
    "models/layers.py::mlp_init": _PER_BLOCK,
    "models/layers.py::attention_init": _PER_BLOCK,
    "models/layers.py::mla_init": _PER_BLOCK,
    "models/layers.py::moe_init": _PER_BLOCK,
}


# -- reading a module ---------------------------------------------------------


def _params(fn: ast.AST) -> list:
    a = fn.args
    return [x.arg for x in a.posonlyargs + a.args + a.kwonlyargs
            if x.arg not in ("self", "cls")]


def _ctor(cls: ast.ClassDef):
    for m in cls.body:
        if isinstance(m, ast.FunctionDef) and m.name == "__init__":
            return _params(m)
    if any("dataclass" in ast.unparse(d) for d in cls.decorator_list):
        return [m.target.id for m in cls.body
                if isinstance(m, ast.AnnAssign)
                and isinstance(m.target, ast.Name)]
    return None


def _is_module(path: pathlib.Path, node: ast.ImportFrom, name: str) -> bool:
    """``from .x import name`` binds a submodule rather than a value."""
    pkg = path.parent
    for _ in range(node.level - 1):
        pkg = pkg.parent
    base = pkg.joinpath(*node.module.split(".")) if node.module else pkg
    return (base / f"{name}.py").exists() or (base / name).is_dir()


def surface(path: pathlib.Path, port: bool = False) -> dict:
    """Qualified name -> its parameters (None for a plain value): the
    public top-level names, re-exports, and each public class's methods
    and constructor (``Class`` -> its parameters).  ``port`` counts every
    top-level binding, imports included."""
    text = path.read_text()
    lines = text.splitlines()
    out = {}
    for n in ast.parse(text).body:
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef)):
            out[n.name] = _params(n)
        elif isinstance(n, ast.ClassDef):
            out[n.name] = _ctor(n)
            for m in n.body:
                if (isinstance(m, (ast.FunctionDef, ast.AsyncFunctionDef))
                        and not m.name.startswith("_")):
                    out[f"{n.name}.{m.name}"] = _params(m)
        elif isinstance(n, ast.Assign):
            for t in n.targets:
                for x in (t.elts if isinstance(t, ast.Tuple) else [t]):
                    if isinstance(x, ast.Name):
                        out[x.id] = None
        elif isinstance(n, ast.AnnAssign) and isinstance(n.target, ast.Name):
            out[n.target.id] = None
        elif isinstance(n, (ast.Import, ast.ImportFrom)) and port:
            for a in n.names:
                out[(a.asname or a.name).split(".")[0]] = None
        elif isinstance(n, ast.ImportFrom) and n.level:
            marked = any("noqa: F401" in lines[i]
                         for i in range(n.lineno - 1, n.end_lineno))
            if path.name == "__init__.py" or marked:
                for a in n.names:
                    if not _is_module(path, n, a.name):
                        out[a.asname or a.name] = None
    if port:
        return out
    return {k: v for k, v in out.items()
            if not any(p.startswith("_") for p in k.split("."))}


MODULES = sorted(str(p.relative_to(JAX)) for p in JAX.rglob("*.py"))


def _split(entry: str):
    """``"path::qual(param)"`` -> (path, qual or None, param or None)."""
    path, _, rest = entry.partition("::")
    qual, _, param = rest.partition("(")
    return path, qual or None, param.rstrip(")") or None


def _exists(root: pathlib.Path, entry: str, port: bool) -> bool:
    path, qual, param = _split(entry)
    if not (root / path).exists():
        return False
    if qual is None:
        return True
    names = surface(root / path, port=port)
    if qual not in names:
        return False
    return param is None or param in (names[qual] or [])


def gaps(rel: str) -> list:
    """Every JAX public name and parameter of module ``rel`` that the port
    lacks and neither table accounts for, and every table entry of the
    module that does not hold."""
    out = []

    def accounted(entry: str) -> bool:
        if entry in RENAMED:
            if not _exists(PORT, RENAMED[entry], port=True):
                out.append(f"{entry}: renamed to {RENAMED[entry]}, "
                           "which the port lacks")
            return True
        if entry in ABSENT:
            if _exists(PORT, entry, port=True):
                out.append(f"{entry}: listed as absent ({ABSENT[entry]}) "
                           "but the port has it")
            return True
        return False

    if accounted(rel):
        return out
    if not (PORT / rel).exists():
        return [f"{rel}: no port module"]
    want, have = surface(JAX / rel), surface(PORT / rel, port=True)
    for qual, params in want.items():
        entry = f"{rel}::{qual}"
        target = qual
        if entry in RENAMED:
            accounted(entry)
            target = _split(RENAMED[entry])[1]
        elif accounted(entry):
            continue
        elif qual not in have:
            if "." in qual and qual.split(".")[0] not in have:
                continue  # the class itself is reported
            out.append(f"{entry}: missing")
            continue
        if target not in have:
            continue
        for p in params or []:
            if p in (have[target] or []):
                if f"{entry}({p})" in ABSENT:
                    accounted(f"{entry}({p})")
                continue
            if not accounted(f"{entry}({p})"):
                out.append(f"{entry}({p}): missing parameter")
    return out


@pytest.mark.parametrize("rel", MODULES)
def test_port_module_has_the_public_surface(rel):
    assert gaps(rel) == []


def test_every_table_entry_names_a_jax_entry():
    """A table entry of a name the JAX package no longer has is stale."""
    stale = [e for e in list(RENAMED) + list(ABSENT)
             if not _exists(JAX, e, port=False)]
    assert stale == []
    assert all(reason.strip() for reason in ABSENT.values())


def test_a_new_jax_name_is_caught(tmp_path):
    """A public function added to a JAX module, absent from the port and
    from both tables, is reported (the check is run on copies)."""
    jax_mod, port_mod = tmp_path / "repro" / "utils.py", tmp_path / "port.py"
    jax_mod.parent.mkdir()
    jax_mod.write_text((JAX / "utils.py").read_text()
                       + "\n\ndef new_helper(x, *, scale=1):\n    return x\n")
    port_mod.write_text((PORT / "utils.py").read_text())
    want, have = surface(jax_mod), surface(port_mod, port=True)
    assert "new_helper" in want and "new_helper" not in have
    assert want["new_helper"] == ["x", "scale"]
