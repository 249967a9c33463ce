"""Build the port's CUDA sources with ``nvcc`` at first use and load them.

Each ``csrc/<name>.cu`` has a plain C interface and compiles on its own,
for ``sm_90a``, into ``build/repro_torch/lib<name>-<hash>.so`` at the root
of the checkout (a directory ``.gitignore`` lists); the library is then
loaded with ``ctypes``.  The hash covers the source and the flags, so an
edited source never loads a stale library.  ``build_all`` starts one
``nvcc`` per source, all at once.

Nothing here runs at import: the CPU tests import every module on
machines that have no ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, List, Tuple

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parents[1] / "build" / "repro_torch"
SOURCES = ("flash_cached", "fisher", "flash_paged", "grad_quant", "ssd_scan")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: Dict[str, ctypes.CDLL] = {}
# name -> (seconds spent in nvcc, ptxas report); empty when loaded from disk
BUILD_LOG: Dict[str, Tuple[float, str]] = {}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (looked on PATH and in $CUDA_HOME/bin, "
                       "default /usr/local/cuda/bin)")


def _target(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{tag}.so"


def _start(name: str) -> Tuple[subprocess.Popen, Path, Path, float]:
    out = _target(name)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out, time.perf_counter()


def _finish(name: str, job: Tuple[subprocess.Popen, Path, Path, float]) -> None:
    proc, tmp, out, t0 = job
    log, _ = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
    os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
    BUILD_LOG[name] = (time.perf_counter() - t0, log)


def build_all(names: Tuple[str, ...] = SOURCES) -> List[str]:
    """Compile every source whose library is missing, one ``nvcc`` each,
    all started together.  Returns the names that were compiled."""
    jobs = {n: _start(n) for n in names if not _target(n).exists()}
    for n, job in jobs.items():
        _finish(n, job)
    return list(jobs)


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    lib = _LIBS.get(name)
    if lib is None:
        if not _target(name).exists():
            _finish(name, _start(name))
        lib = ctypes.CDLL(str(_target(name)))
        _LIBS[name] = lib
    return lib
