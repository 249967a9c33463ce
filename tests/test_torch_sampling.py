"""The port's sampled decoding on the CPU against the JAX package's: the
Threefry keys and bits of ``serving.prng`` equal ``jax.random``'s word for
word, its Gumbel noise is within float32 ``log`` rounding of
``jax.random.gumbel``, and the engine's ``_pick`` draws the JAX engine's
tokens on seeded logit batches (temperatures 0.7 and 1.3, top-k 0, 1 and
8, ties at the k-th value).  Sampled streams on qwen2-smoke and
mamba2-smoke, with the JAX weights bridged across, equal the JAX engine's
in the eager loop, fused at prefill blocks 1 and 8 and on a paged cache,
and differ from greedy ones; a greedy tick issues no sampler op; two
engines dispatched in turn and then drained give ``run()``'s streams with
one sync per chunk each; and an engine evacuated mid-run hands its
orphans to a fresh engine that finishes the unbroken sampled streams."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import transformer as JT
from repro.serving import Request as JRequest
from repro.serving import ServeEngine as JServeEngine
from repro_torch import bridge, configs
from repro_torch.serving import Request, ServeEngine
from repro_torch.serving import prng

ARCHS = ("qwen2-1.5b", "mamba2-1.3b")
# the reference's schedule-invariance settings (tests/test_serve_scan.py)
SAMPLED = dict(slots=2, max_len=32, temperature=0.7, top_k=8, sample_seed=11)
MODES = {"eager": dict(fused=False), "fused_b1": dict(prefill_block=1),
         "fused_b8": dict(prefill_block=8),
         "paged": dict(kv_paging=True, kv_page_size=8)}
PICKS = [(t, k) for t in (0.7, 1.3) for k in (0, 1, 8)]


def prompts_for(vocab):
    rng = np.random.default_rng(5)
    return [rng.integers(0, vocab, size=int(rng.integers(3, 12)))
            .astype(np.int32) for _ in range(4)]


def make(cls, prompts, **kw):
    return [cls(uid=i, prompt=p.copy(), max_new=5, **kw)
            for i, p in enumerate(prompts)]


def logit_batch(seed, rows=96, vocab=256):
    """Logits on a coarse grid (many ties, at the k-th value too), sids
    from -1 to 49 and token indices up to 1000."""
    rng = np.random.default_rng(seed)
    lg = (np.round(rng.standard_normal((rows, vocab)) * 2) / 2).astype(
        np.float32)
    sid = rng.integers(-1, 50, rows).astype(np.int32)
    tok = rng.integers(0, 1000, rows).astype(np.int32)
    return lg, sid, tok


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def ref():
    """The JAX engine's sampled and greedy streams, once per module, the
    JAX engine's draws on the logit batches, and the bridged weights."""
    out = {}
    for arch in ARCHS:
        jcfg = jconfigs.get_reduced(arch)
        jp = JT.init_params(jcfg, jax.random.PRNGKey(0))
        cfg = configs.get_reduced(arch)
        tp = bridge.params_from_numpy(
            cfg, jax.tree_util.tree_map(np.asarray, jp), device="cpu")
        prompts = prompts_for(jcfg.vocab)
        runs = {}
        cases = {"sampled": {}}
        if jcfg.family != "ssm":
            cases["paged"] = MODES["paged"]
        for name, kw in cases.items():
            eng = JServeEngine(jcfg, jp, **SAMPLED, **kw)
            runs[name] = [list(r.out) for r in eng.run(make(JRequest,
                                                             prompts))]
        eng = JServeEngine(jcfg, jp, slots=2, max_len=32, prefill_block=1)
        runs["greedy"] = [list(r.out) for r in eng.run(make(JRequest,
                                                            prompts))]
        out[arch] = (cfg, tp, prompts, runs)
    draws = {}
    for t, k in PICKS:
        ns = type("Engine", (), dict(temperature=t, top_k=k,
                                     _sample_key=jax.random.PRNGKey(11)))()
        pick = jax.jit(lambda lg, s, i, ns=ns: JServeEngine._pick(ns, lg, s,
                                                                 i))
        lg, sid, tok = logit_batch(int(10 * t) + k)
        draws[t, k] = np.asarray(pick(lg, sid, tok))
    out["draws"] = draws
    return out


@pytest.mark.parametrize("sid", [-1, 0, 49])
@pytest.mark.parametrize("seed", [0, 11, 2 ** 31 - 1, -1, -7, 2 ** 32 + 5])
def test_keys_and_bits_equal_jax(seed, sid):
    toks = [0, 1, 7, 1000, 2 ** 31 - 1]
    want_keys = np.stack([np.asarray(jax.random.key_data(
        jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(seed),
                                              jnp.int32(sid)),
                           jnp.int32(t))), np.int64) for t in toks])
    keys = prng.fold_in(prng.fold_in(prng.key(seed).expand(len(toks), 2),
                                     torch.full((len(toks),), sid)),
                        torch.tensor(toks))
    assert np.array_equal(keys.numpy(), want_keys)
    got = prng.bits(keys, 1000).numpy()
    for row, t in zip(got, toks):
        k = jax.random.fold_in(jax.random.fold_in(
            jax.random.PRNGKey(seed), jnp.int32(sid)), jnp.int32(t))
        assert np.array_equal(row, np.asarray(jax.random.bits(k, (1000,)),
                                              np.int64))


@pytest.mark.parametrize("seed", [0, 11, 2 ** 31 - 1])
def test_gumbel_within_float32_log_rounding_of_jax(seed):
    keys = prng.fold_in(prng.key(seed).expand(4, 2), torch.arange(4))
    got = prng.gumbel(keys, 4096).numpy()
    for j in range(4):
        k = jax.random.fold_in(jax.random.PRNGKey(seed), jnp.int32(j))
        want = np.asarray(jax.random.gumbel(k, (4096,)))
        assert np.abs(got[j] - want).max() <= 1e-6


@pytest.mark.parametrize("temperature,top_k", PICKS)
def test_pick_draws_equal_jax_engine(ref, temperature, top_k):
    cfg, tp, _, _ = ref[ARCHS[0]]
    eng = ServeEngine(cfg, tp, slots=2, max_len=32, temperature=temperature,
                      top_k=top_k, sample_seed=11, device="cpu")
    lg, sid, tok = logit_batch(int(10 * temperature) + top_k)
    if top_k:
        # the grid makes ties at the k-th value common: they stay candidates
        kth = -np.sort(-lg, axis=-1)[:, top_k - 1]
        assert ((lg == kth[:, None]).sum(-1) > 1).mean() > 0.25
    got = eng._pick(torch.from_numpy(lg), torch.from_numpy(sid),
                    torch.from_numpy(tok)).numpy()
    assert np.array_equal(got, ref["draws"][temperature, top_k])


def test_greedy_pick_is_argmax_and_issues_no_sampler_op(ref, monkeypatch):
    """At temperature 0 the pick is the first maximum and no PRNG op runs
    in a whole serve."""
    cfg, tp, prompts, runs = ref[ARCHS[0]]

    def refuse(*a, **k):
        raise AssertionError("a greedy tick drew a sample")

    for name in ("fold_in", "bits", "uniform", "gumbel", "threefry2x32"):
        monkeypatch.setattr(prng, name, refuse)
    eng = ServeEngine(cfg, tp, slots=2, max_len=32, prefill_block=1,
                      device="cpu")
    assert [list(r.out) for r in eng.run(make(Request, prompts))] == \
        runs["greedy"]


# the ssm family has no paged cache yet (ROADMAP item 12.2)
@pytest.mark.parametrize("arch,mode", [
    (a, m) for a in ARCHS for m in MODES
    if not (a == "mamba2-1.3b" and m == "paged")])
def test_sampled_streams_equal_jax_engine(ref, arch, mode):
    cfg, tp, prompts, runs = ref[arch]
    eng = ServeEngine(cfg, tp, device="cpu", **SAMPLED, **MODES[mode])
    reqs = eng.run(make(Request, prompts))
    assert all(r.outcome == "done" for r in reqs)
    want = runs["paged" if mode == "paged" else "sampled"]
    assert [list(r.out) for r in reqs] == want
    assert want != runs["greedy"]  # sampling samples
    rep = eng.last_run_report
    assert rep["host_syncs"] == rep["chunks"]


def test_interleaved_engines_give_run_streams(ref):
    """The fused split across two engines: each dispatches a chunk before
    either drains, and each books only its own fetch."""
    cfg, tp, prompts, runs = ref[ARCHS[0]]
    engines = [ServeEngine(cfg, tp, device="cpu", chunk=4, **SAMPLED,
                           **kw) for kw in ({}, MODES["paged"])]
    reqs = [make(Request, prompts) for _ in engines]
    for eng, rs in zip(engines, reqs):
        for r in rs:
            eng.submit(r)
        eng.fused_begin()
    while any(e.has_work() for e in engines):
        handles = [e.fused_dispatch() for e in engines]
        for e, h in zip(engines, handles):
            if h is not None:
                e.fused_drain(h)
    for eng, rs, want in zip(engines, reqs, (runs["sampled"],
                                             runs["paged"])):
        eng.fused_finish()
        assert [list(r.out) for r in rs] == want
        rep = eng.last_run_report
        assert rep["host_syncs"] == rep["chunks"] > 1


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "eager"])
def test_evacuated_orphans_finish_unbroken_streams(ref, fused):
    """Evacuate mid-run: the orphans come back in submission order, some
    with tokens already drawn, and a fresh engine fed only the orphans
    finishes every stream as the unbroken run draws it."""
    cfg, tp, prompts, runs = ref[ARCHS[0]]
    eng = ServeEngine(cfg, tp, device="cpu", chunk=2, fused=fused,
                      **SAMPLED)
    reqs = make(Request, prompts)
    for r in reqs:
        eng.submit(r)
    if fused:
        eng.fused_begin()
    while not (any(r.outcome for r in reqs)
               and any(r.out and not r.outcome for r in reqs)):
        eng.fused_drain(eng.fused_dispatch()) if fused else eng.step()
    orphans = eng.evacuate()
    assert orphans == [r for r in reqs if r.outcome is None]
    assert any(r.out for r in orphans) and not eng.has_work()
    assert any(r.outcome == "done" for r in reqs)
    fresh = ServeEngine(cfg, tp, device="cpu", fused=fused, **SAMPLED)
    fresh.run(orphans)
    assert [list(r.out) for r in reqs] == runs["sampled"]
    assert all(r.outcome == "done" for r in reqs)
