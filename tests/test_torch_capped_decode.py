"""The port's capped MoE decode step on the CPU against the JAX package's
default one, on mixtral-smoke (4 experts top-2, a sliding window) and
deepseek-smoke (MLA, a dense-head layer, 8 experts top-2 with a shared
expert), f32, with the JAX weights bridged across.

``decode_step(drop_free=False)`` runs the capped expert queues,
``max(4, int(1.25 · B · top_k / E))`` slots over the B tokens of a step,
as ``repro.models.transformer.decode_step`` does by default: three steps
of 16 slots give the JAX logits to 1e-5 with assignments dropped (the
count is asserted above 0).  The serving engine's programs keep the
drop-free queue (``drop_free=True``): every MoE dispatch of an engine run
has a queue as long as its row of tokens."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import transformer as JT
from repro_torch import bridge, configs
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.serving import Request, ServeEngine

ARCHS = ("mixtral-8x7b", "deepseek-v3-671b")
TOL = dict(rtol=1e-5, atol=1e-5)  # tests/test_torch_moe.py's
B, STEPS, MAX_LEN = 16, 3, 8


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def queues(monkeypatch):
    """Every MoE dispatch's (tokens a row, queue length, kept choices,
    choices) through ``layers._queue_slots``."""
    seen = []
    real = L._queue_slots

    def spy(sel, e, cap):
        slot, keep, flat = real(sel, e, cap)
        seen.append((sel.shape[-2], cap, int(keep.sum()), keep.numel()))
        return slot, keep, flat

    monkeypatch.setattr(L, "_queue_slots", spy)
    return seen


def tokens(vocab):
    rng = np.random.default_rng(11)
    return [rng.integers(0, vocab, (B, 1)).astype(np.int32)
            for _ in range(STEPS)]


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    """(cfg, port params, the JAX default decode's logits a step): one
    module-scoped JAX run a model."""
    jcfg = jconfigs.get_reduced(request.param)
    jparams = JT.init_params(jcfg, jax.random.PRNGKey(0))
    caches = JT.init_caches(jcfg, B, MAX_LEN)
    want = []
    for t, tok in enumerate(tokens(jcfg.vocab)):
        lg, caches = JT.decode_step(jcfg, jparams, jnp.asarray(tok), caches,
                                    jnp.full((B,), t, jnp.int32))
        want.append(np.asarray(lg))
    cfg = configs.get_reduced(request.param)
    params = bridge.params_from_numpy(
        cfg, jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    return cfg, params, want


def test_capped_decode_matches_the_jax_default(model, queues):
    cfg, params, want = model
    caches = T.init_caches(cfg, B, MAX_LEN, device="cpu")
    for t, tok in enumerate(tokens(cfg.vocab)):
        got, caches = T.decode_step(cfg, params, torch.from_numpy(tok).long(),
                                    caches, torch.full((B,), t),
                                    drop_free=False)
        np.testing.assert_allclose(got.numpy(), want[t], **TOL)
    cap = max(4, int(cfg.capacity_factor * B * cfg.top_k / cfg.n_experts))
    assert queues and all(n == B and c == cap for n, c, _, _ in queues)
    dropped = sum(total - kept for _, _, kept, total in queues)
    assert dropped > 0, "the seed drops no assignment: nothing is tested"


def test_drop_free_decode_differs_where_the_cap_drops(model):
    cfg, params, want = model
    caches = T.init_caches(cfg, B, MAX_LEN, device="cpu")
    tok = torch.from_numpy(tokens(cfg.vocab)[0]).long()
    free, _ = T.decode_step(cfg, params, tok, caches, torch.zeros(B),
                            drop_free=True)
    assert not np.allclose(free.numpy(), want[0], **TOL)


def test_engine_programs_run_drop_free(model, queues):
    cfg, params, _ = model
    rng = np.random.default_rng(3)
    reqs = [Request(uid=i, prompt=rng.integers(
        0, cfg.vocab, size=n).astype(np.int32), max_new=3)
        for i, n in enumerate((3, 6, 5, 2))]
    eng = ServeEngine(cfg, params, slots=4, max_len=16, chunk=4,
                      prefill_block=4, device="cpu")
    assert all(r.outcome == "done" for r in eng.run(reqs))
    assert queues and all(c == n for n, c, _, _ in queues)
    assert all(kept == total for _, _, kept, total in queues)
