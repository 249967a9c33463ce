"""The port's encoder-decoder family (whisper) on the CPU against the JAX
package's, on whisper-smoke (2 encoder and 2 decoder layers, d_model 64,
4 heads of 16, 16 frames, float32) with the JAX weights bridged across:
the parameter tree, unit costs and tap groups (a cross-attention
``xattn`` unit and tap group a decoder layer), ``encode``, ``lm_loss``,
pooled features and tap gradients, the probe's scores, TinyTrain's
policy, losses, deltas, fold and folded streams, the remat option and
``logit_chunk`` (the checks live in ``encdec_twins.py``)."""
from encdec_twins import *  # noqa: F401,F403  (the shared checks)

ARCH = "whisper-base"
