"""The port's encoder-decoder serving (whisper) on the CPU against the JAX
engine, on whisper-smoke (cross-attention over each request's 16-frame
encoder output): greedy and sampled streams and outcomes identical across
the eager loop, fused B1 and fused B8 on contiguous, paged, int8 and
pressured caches and equal to the JAX engine's, each request encoded once
through preemption, the conditioning reaching every decode, the refusal to
decode without the encoder's output, the submit guard, the runs' pages
priced and reported (the checks live in ``encdec_serving_twins.py``)."""
from encdec_serving_twins import *  # noqa: F401,F403  (the shared checks)

ARCH = "whisper-base"
