"""The port's ``chunked_attention`` (``repro_torch.models.layers``) on the
CPU against the JAX package's, in float32 within 1e-5: causal and not,
with a sliding window, a GQA group, MLA's value dim != qk dim, and chunk
sizes that do not divide the sequence (``_pick`` takes the largest divisor
below the target); its gradient under autograd, where each query chunk is
recomputed in the backward; and the switch points of cache-free
attention, which must fall exactly where the JAX package's do
(``S·Sk > 1024²`` for self- and cross-attention, ``S² > 4096²`` for
MLA), or float32 rounding would differ on one side of them."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import layers as JL
from repro_torch import configs
from repro_torch.models import layers as L

TOL = dict(rtol=1e-5, atol=1e-5)

# (B, Sq, Sk, H, Hkv, D, Dv, causal, window, q_chunk, kv_chunk)
CASES = {
    "causal": (2, 12, 12, 4, 4, 16, 16, True, 0, 4, 6),
    "cross": (2, 6, 10, 4, 4, 16, 16, False, 0, 3, 4),
    "window-gqa": (1, 16, 16, 8, 2, 16, 16, True, 5, 4, 8),
    "mla-dv": (2, 9, 9, 4, 4, 24, 16, True, 0, 3, 3),
    "ragged-chunks": (1, 15, 21, 4, 1, 8, 8, False, 0, 4, 8),
}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _inputs(case, seed=0):
    b, sq, sk, h, hkv, d, dv = case[:7]
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, sq, h, d)).astype(np.float32),
            rng.standard_normal((b, sk, hkv, d)).astype(np.float32),
            rng.standard_normal((b, sk, hkv, dv)).astype(np.float32))


@pytest.mark.parametrize("name", list(CASES))
def test_chunked_attention_matches_reference(name):
    case = CASES[name]
    causal, window, qc, kc = case[7:]
    q, k, v = _inputs(case)
    want = np.asarray(JL.chunked_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        window=window, q_chunk=qc, kv_chunk=kc))
    got = L.chunked_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), causal=causal,
                              window=window, q_chunk=qc, kv_chunk=kc)
    assert got.shape == want.shape == (case[0], case[1], case[3], case[6])
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    # and the plain masked attention computes the same function
    if case[5] == case[6]:
        plain = L.dot_attention(torch.from_numpy(q), torch.from_numpy(k),
                                torch.from_numpy(v), causal=causal,
                                window=window)
        np.testing.assert_allclose(got.numpy(), plain.numpy(), **TOL)


@pytest.mark.parametrize("name", ["causal", "window-gqa", "mla-dv"])
def test_chunked_attention_gradient_matches_reference(name):
    """Autograd through the recomputed chunks equals ``jax.grad`` of the
    reference (its ``jax.checkpoint``-ed scan), for q, k and v."""
    case = CASES[name]
    causal, window, qc, kc = case[7:]
    q, k, v = _inputs(case, seed=1)
    w = np.random.default_rng(2).standard_normal(
        (case[0], case[1], case[3], case[6])).astype(np.float32)

    def jloss(q_, k_, v_):
        out = JL.chunked_attention(q_, k_, v_, causal=causal, window=window,
                                   q_chunk=qc, kv_chunk=kc)
        return jnp.sum(out * w)

    want = jax.grad(jloss, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = L.chunked_attention(tq, tk, tv, causal=causal, window=window,
                              q_chunk=qc, kv_chunk=kc)
    got = torch.autograd.grad((out * torch.from_numpy(w)).sum(),
                              (tq, tk, tv))
    for g, wg in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(wg), **TOL)


@pytest.mark.parametrize("name", ["causal", "window-gqa", "mla-dv"])
def test_chunked_attention_gradient_under_torch_func(name):
    """Under ``torch.func.grad`` (the fleet fine-tune's transform, which
    refuses the checkpoint) the chunks keep their scores and the gradient
    still equals ``jax.grad`` of the reference."""
    case = CASES[name]
    causal, window, qc, kc = case[7:]
    q, k, v = _inputs(case, seed=3)
    w = np.random.default_rng(4).standard_normal(
        (case[0], case[1], case[3], case[6])).astype(np.float32)

    def jloss(q_, k_, v_):
        out = JL.chunked_attention(q_, k_, v_, causal=causal, window=window,
                                   q_chunk=qc, kv_chunk=kc)
        return jnp.sum(out * w)

    def tloss(q_, k_, v_):
        out = L.chunked_attention(q_, k_, v_, causal=causal, window=window,
                                  q_chunk=qc, kv_chunk=kc)
        return (out * torch.from_numpy(w)).sum()

    want = jax.grad(jloss, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    got = torch.func.grad(tloss, argnums=(0, 1, 2))(
        *(torch.from_numpy(a) for a in (q, k, v)))
    for g, wg in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(wg), **TOL)


def test_remat_recomputes_or_refuses_under_torch_func():
    """``remat`` gives ``fn``'s value and gradient under autograd and its
    value under ``no_grad``; under a ``torch.func`` transform, which
    refuses the checkpoint, it raises instead of keeping every activation
    unasked."""
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (3, 4)).astype(np.float32))

    def fn(t):
        return torch.tanh(t) * t

    with torch.no_grad():
        np.testing.assert_array_equal(L.remat(fn, x).numpy(), fn(x).numpy())
    xr = x.clone().requires_grad_()
    g = torch.autograd.grad(L.remat(fn, xr).sum(), xr)[0]
    xp = x.clone().requires_grad_()
    np.testing.assert_array_equal(
        g.numpy(), torch.autograd.grad(fn(xp).sum(), xp)[0].numpy())
    assert not L.under_func_transform()
    with pytest.raises(RuntimeError, match="torch.func"):
        torch.func.grad(lambda t: L.remat(fn, t).sum())(x)


def test_adapt_many_refuses_a_remat_override():
    """The fleet fine-tune runs under ``torch.func``: a remat policy
    override is refused with ``ValueError`` before any work, not run with
    its activations kept."""
    from repro_torch import api
    from repro_torch.core.policy import SelectedUnit, SparseUpdatePolicy

    bb = api.backbone("qwen2-1.5b", preset="smoke")
    session = api.TinyTrainSession(bb, max_way=5, device="cpu")
    remat = SparseUpdatePolicy(
        horizon=1, units=(SelectedUnit(layer=1, kind="mlp", channels=(0, 1)),),
        meta={"remat": True})
    with pytest.raises(ValueError, match="remat"):
        session.adapt_many([], api.JETSON_NANO, policy_override=remat)


def test_chunk_sizes_are_the_largest_divisors():
    """whisper's 1500 frames at the default targets give chunks of 500 and
    750, as the reference's ``_pick`` does."""
    assert (L._pick(1500, 512), L._pick(1500, 1024)) == (500, 750)
    assert L._pick(1025, 512) == 205 and L._pick(7, 4) == 1
    assert L._pick(64, 512) == 64


@pytest.mark.parametrize("limit,rows,chunked", [
    (1024 * 1024, (1024, 1024), False), (1024 * 1024, (1024, 1025), True),
    (4096 * 4096, (4096, 4096), False), (4096 * 4096, (4096, 4097), True)])
def test_switch_points(monkeypatch, limit, rows, chunked):
    """``_cache_free_attention`` takes the chunked path exactly past its
    limit (the shapes are stand-ins: only the rule runs)."""
    calls = []
    monkeypatch.setattr(L, "chunked_attention",
                        lambda *a, **k: calls.append("chunked"))
    monkeypatch.setattr(L, "dot_attention",
                        lambda *a, **k: calls.append("dot"))
    q = torch.empty((1, rows[0], 1, 1))
    k = torch.empty((1, rows[1], 1, 1))
    L._cache_free_attention(q, k, k, causal=True, limit=limit)
    assert calls == ["chunked" if chunked else "dot"]


@pytest.mark.parametrize("kind", ["self", "cross", "mla"])
def test_each_path_passes_the_reference_limit(monkeypatch, kind):
    """Self- and cross-attention switch at 1024², MLA at 4096²: the limit
    each cache-free path hands to the switch."""
    seen = []
    real = L._cache_free_attention

    def spy(q, k, v, *, causal, window=0, limit=1024 * 1024):
        seen.append((limit, causal))
        return real(q, k, v, causal=causal, window=window, limit=limit)

    monkeypatch.setattr(L, "_cache_free_attention", spy)
    arch = "deepseek-v3-671b" if kind == "mla" else "whisper-base"
    cfg = configs.get_reduced(arch)
    from repro_torch.models import transformer as T

    params = T.init_params(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    lp = {k: v[0] for k, v in params["stacks"]["g0"]["attn"].items()}
    x = torch.randn(1, 5, cfg.d_model)
    pos = torch.arange(5)[None]
    if kind == "mla":
        L.mla_apply(lp, x, cfg, positions=pos)
        assert seen == [(4096 * 4096, True)]
    elif kind == "cross":
        L.attention_apply(lp, x, cfg, positions=pos,
                          cross_hidden=torch.randn(1, 7, cfg.d_model))
        assert seen == [(1024 * 1024, False)]
    else:
        L.attention_apply(lp, x, cfg, positions=pos, causal=False)
        assert seen == [(1024 * 1024, False)]


@pytest.mark.parametrize("sq", [1024, 1025])
def test_attention_apply_either_side_of_the_switch(sq):
    """whisper-smoke's non-causal self-attention at S = 1024 (S² = 1024²:
    the plain path) and 1025 (chunked, chunks of 205): the port's output
    equals the reference's on both sides."""
    jcfg = jconfigs.get_reduced("whisper-base")
    cfg = configs.get_reduced("whisper-base")
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    rng = np.random.default_rng(5)
    d = cfg.d_model
    p = {n: (rng.standard_normal((d, d)) / np.sqrt(d)).astype(np.float32)
         for n in ("wq", "wk", "wv", "wo")}
    x = rng.standard_normal((1, sq, d)).astype(np.float32)
    pos = np.arange(sq)[None]
    want, _ = JL.attention_apply({n: jnp.asarray(w) for n, w in p.items()},
                                 jnp.asarray(x), jcfg,
                                 positions=jnp.asarray(pos), causal=False)
    got, _ = L.attention_apply({n: torch.from_numpy(w) for n, w in p.items()},
                               torch.from_numpy(x), cfg,
                               positions=torch.from_numpy(pos), causal=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
