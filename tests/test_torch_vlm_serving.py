"""The port's VLM serving (paligemma) on the CPU against the JAX engine, on
paligemma-smoke (an 8-token image prefix fed as placeholder tokens whose
embeddings each tick swaps for the request's pinned rows): greedy and
sampled streams and outcomes identical across the eager loop, fused B1
and fused B8 on contiguous, paged, int8 and pressured caches and equal to
the JAX engine's, each request projected once through preemption, the
prefix reaching every decode, the prefix counted in the request's budget,
the submit guard, the runs' pages priced and reported (the checks live in
``encdec_serving_twins.py``)."""
from encdec_serving_twins import *  # noqa: F401,F403  (the shared checks)

ARCH = "paligemma-3b"
