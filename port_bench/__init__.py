"""The port's benchmark: one cell of ``BENCHMARK.json`` a run.

``python3 port_bench/run.py --workload <name> --seed <n> --seconds <s>
--trace <0|1>`` from the root of a checkout; README.md says the rest.
Nothing here imports ``jax``, ``jaxlib`` or the JAX package, and the
reference (``reference/``), the work counts (``flops.py``, ``work.py``)
and the traffic generator import nothing of the port either.
"""
