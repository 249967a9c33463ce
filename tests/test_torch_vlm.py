"""The port's VLM family (paligemma) on the CPU against the JAX package's,
on paligemma-smoke (3 gemma layers, d_model 64, 4 query heads of 16 over
one KV head, an 8-token image prefix from 32-wide patch embeddings,
float32) with the JAX weights bridged across: the parameter tree
(``img_proj``), unit costs and tap groups, the image prefix
``build_inputs`` lays ahead of the tokens, ``lm_loss`` on the tokens past
the prefix, pooled features over prefix and tokens, tap gradients, the
probe's scores, TinyTrain's policy, losses, deltas, fold and folded
streams, the remat option and ``logit_chunk`` (the checks live in
``encdec_twins.py``)."""
from encdec_twins import *  # noqa: F401,F403  (the shared checks)

ARCH = "paligemma-3b"
