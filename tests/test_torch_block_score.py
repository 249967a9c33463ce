"""The port's token-batch scoring (``TinyTrainSession.score_stream`` on
``EpisodeStepCache.block_score``) on the CPU against the JAX package's,
with the JAX weights bridged across: the mean next-token NLL of each
sequence at rtol/atol 5e-5 (the JAX test's tolerance,
``tests/test_api.py::TestBlockScoring``), at sequence lengths that tile
the block (32) and leave a ragged tail (27), on qwen2-smoke, on
mamba2-smoke, and on qwen2-smoke with a 16-token sliding window (the
rolling cache); each other family gives what the JAX package gives:
scores (hybrid, moe, vlm) or the same exception (encoder-decoder).  Within
the port: one host fetch a call, one scorer a block size, and the
reference's ``ValueError``s."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core.backbones import lm_backbone as jlm_backbone
from repro.core.session import TinyTrainSession as JSession
from repro_torch import api, bridge, configs
from repro_torch.core import adapt as telemetry
from repro_torch.core.backbones import lm_backbone
from repro_torch.core.session import TinyTrainSession

BLOCK = 8
N = 4
# (arch, config overrides, sequence lengths)
CASES = {
    "dense": ("qwen2-1.5b", {}, (32, 27)),
    "window": ("qwen2-1.5b", {"sliding_window": 16}, (32, 27)),
    "ssm": ("mamba2-1.3b", {}, (32, 27)),
    "hybrid": ("zamba2-1.2b", {}, (27,)),
    "moe": ("mixtral-8x7b", {}, (27,)),
    "mla": ("deepseek-v3-671b", {}, (27,)),
    "vlm": ("paligemma-3b", {}, (27,)),
    "audio": ("whisper-base", {}, (27,)),
}


def tokens(vocab, seq):
    return np.random.default_rng(seq).integers(
        0, vocab, size=(N, seq)).astype(np.int32)


def sessions(arch, overrides):
    """The JAX session (weights from seed 0) and the port's on the bridged
    weights."""
    jcfg = dataclasses.replace(jconfigs.get_reduced(arch), **overrides)
    tcfg = dataclasses.replace(configs.get_reduced(arch), **overrides)
    js = JSession(jlm_backbone(jcfg, 128, N), max_way=4, seed=0)
    tp = bridge.params_from_numpy(
        tcfg, jax.tree_util.tree_map(np.asarray, js.params), device="cpu")
    return js, TinyTrainSession(lm_backbone(tcfg, 128, N), tp, max_way=4,
                                device="cpu")


def score(session, toks):
    """Scores, or the exception's type and message."""
    try:
        return session.score_stream(toks, block=BLOCK)
    except Exception as e:  # noqa: BLE001 - compared across packages
        return type(e).__name__, str(e)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def ref():
    """Every case scored by both packages, once per module."""
    out = {}
    for case, (arch, overrides, seqs) in CASES.items():
        js, ts = sessions(arch, overrides)
        for seq in seqs:
            toks = tokens(js.backbone.cfg.vocab, seq)
            out[case, seq] = (score(js, toks), score(ts, toks))
        if case == "dense":
            out["session"] = ts
    return out


@pytest.mark.parametrize("case,seq", [(c, s) for c, (_, _, seqs)
                                      in CASES.items() for s in seqs])
def test_scores_match_reference(ref, case, seq):
    want, got = ref[case, seq]
    if isinstance(want, tuple):  # the reference raises: so must the port
        assert got == want
        return
    assert isinstance(got, np.ndarray), got
    assert got.shape == (N,) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=5e-5, atol=5e-5)


def test_one_fetch_a_call_and_one_scorer_a_block(ref):
    session = ref["session"]
    toks = tokens(session.backbone.cfg.vocab, 32)
    first = session.score_stream(toks, block=BLOCK)
    telemetry.reset_host_sync_count()
    again = session.score_stream(toks, block=BLOCK)
    assert telemetry.host_sync_count() == 1
    np.testing.assert_array_equal(first, again)
    assert list(session.step_cache._block_scores) == [BLOCK]
    # a folded copy scores through params=; the session's own weights
    # score the same as passing them
    np.testing.assert_array_equal(
        session.score_stream(toks, block=BLOCK, params=session.params), first)
    # one block covering the whole sequence: the same scores to rounding
    np.testing.assert_allclose(session.score_stream(toks, block=64), first,
                               rtol=5e-5, atol=5e-5)
    assert sorted(session.step_cache._block_scores) == [BLOCK, 64]


def test_reference_errors(ref):
    session = ref["session"]
    with pytest.raises(ValueError, match="block must be >= 1"):
        session.step_cache.block_score(0)
    with pytest.raises(ValueError, match="at least 2 tokens"):
        session.score_stream(np.zeros((2, 1), np.int32), block=BLOCK)
    cnn = api.TinyTrainSession(api.backbone("tiny-cnn", in_res=16,
                                            batch_size=4), max_way=4,
                               device="cpu")
    with pytest.raises(ValueError, match="LM token-batch"):
        cnn.step_cache.block_score(BLOCK)
