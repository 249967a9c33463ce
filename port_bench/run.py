"""Run one cell of BENCHMARK.json once and print the result's line.

    python3 port_bench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout, on a machine with the cell's NVIDIA cards.
See port_bench/README.md for the line it prints."""
import time

T0 = time.perf_counter()  # set-up runs from here, before any import

import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _pin_caches() -> None:
    """Every build and kernel cache at a fixed path inside the checkout,
    so the first run of a cell builds and later runs find it built; no
    library this process loads reaches for JAX."""
    build = os.path.join(ROOT, "build", "port_bench")
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
        os.environ[var] = os.path.join(build, sub)
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


if __name__ == "__main__":
    _pin_caches()
    sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
    from port_bench import bench  # noqa: E402

    sys.exit(bench.main(sys.argv[1:], T0))
