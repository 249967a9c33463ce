"""Shared serving checks of the port's encoder-decoder and VLM families
against the JAX engine, imported by ``test_torch_encdec_serving.py``
(whisper-smoke: cross-attention over each request's encoder output) and
``test_torch_vlm_serving.py`` (paligemma-smoke: an 8-token image prefix
swapped in by position), each of which names its ``ARCH``; the JAX
weights are bridged across.  The twins of ``tests/test_serve_scan.py``'s
encoder section.  Greedy and sampled
streams and outcomes are identical across the eager loop, fused B1 and
fused B8, on contiguous, paged, int8 and pressured caches (preemption and
requeue), and equal to the JAX engine's; every request is encoded exactly
once whatever its preemptions; the encoder's conditioning reaches every
decode (two feature sets, two teacher-forced oracles); a decoder layer
with cross-attention refuses to run without an encoder output; the
submit guard types its rejections; the run is priced and reported in
pages; every fused run makes one host sync a chunk."""
import jax
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import transformer as JT
from repro.serving import Request as JRequest
from repro.serving import ServeEngine as JServeEngine
from repro_torch import bridge, configs
from repro_torch.models import transformer as T
from repro_torch.serving import Request, ServeEngine

__all__ = [
    "one_thread", "model",
    "test_streams_match_across_loops_and_the_jax_engine",
    "test_encoder_conditioning_reaches_every_decode",
    "test_no_xattn_decode_is_unreachable",
    "test_submit_enc_feats_guard",
    "test_prefix_and_runs_are_priced_and_reported",
]

PROMPT_LENS = (3, 5, 8, 9, 17)
BASE = dict(slots=3, max_len=40, chunk=4)
PAGED = dict(BASE, kv_paging=True, kv_page_size=4)
LAYOUTS = {
    "contiguous": BASE,
    "paged": PAGED,
    "int8": dict(PAGED, kv_int8=True),
    # 18 pages for 3 slots: runs (whisper 4 pages, paligemma 2) plus KV
    # stall and preempt the youngest resident
    "pressured": dict(PAGED, page_budget=18),
}
LOOPS = {"b8": {}, "b1": dict(prefill_block=1), "eager": dict(fused=False)}


def streams(reqs):
    return [(list(r.out), r.outcome) for r in reqs]


def requests(make, cfg, max_new=6, seed=11):
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, cfg.vocab, n).astype(np.int32)
               for n in PROMPT_LENS]
    feats = [rng.standard_normal(cfg.enc_feats_shape).astype(np.float32)
             for _ in PROMPT_LENS]
    return [make(uid=i, prompt=p, max_new=max_new, enc_feats=f)
            for i, (p, f) in enumerate(zip(prompts, feats))]


class CountingDict(dict):
    """The engine's rid -> encoded rows map, counting insertions: each one
    is an encoder run (or an image projection) of one request."""

    def __init__(self):
        super().__init__()
        self.encodes = []

    def __setitem__(self, rid, rows):
        self.encodes.append(rid)
        super().__setitem__(rid, rows)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def model(request):
    """The module's arch: the JAX config and weights, the port's config
    and the same weights bridged across."""
    arch = request.module.ARCH
    jcfg = jconfigs.get_reduced(arch)
    jp = JT.init_params(jcfg, jax.random.PRNGKey(0))
    cfg = configs.get_reduced(arch)
    tp = bridge.params_from_numpy(
        cfg, jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    return jcfg, jp, cfg, tp


def port_run(cfg, tp, kw, max_new=6):
    eng = ServeEngine(cfg, tp, device="cpu", **kw)
    eng._enc_rows = CountingDict()
    reqs = requests(Request, cfg, max_new)
    eng.run(reqs)
    if kw.get("fused", True):
        rep = eng.last_run_report
        assert rep["host_syncs"] == rep["chunks"]
    return eng, reqs


@pytest.mark.parametrize("sampled", [False, True], ids=["greedy", "sampled"])
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_streams_match_across_loops_and_the_jax_engine(model, layout,
                                                       sampled):
    """Eager == fused B1 == fused B8 == the JAX engine's, per layout; each
    request encoded once, the engine's encoded rows released at the end.
    The pressured layout preempts and requeues, and there the loops part
    (the eager loop preempts at other ticks, as the JAX package's does):
    each loop equals its own JAX twin."""
    jcfg, jp, cfg, tp = model
    kw = dict(LAYOUTS[layout])
    pressured = layout == "pressured"
    max_new = 8 if pressured else 6
    if sampled:
        kw.update(temperature=0.7, top_k=8, sample_seed=11)
    got, want = {}, {}
    for loop, extra in LOOPS.items():
        if pressured or not want:
            je = JServeEngine(jcfg, jp, **kw, **extra)
            want[loop] = streams(je.run(requests(JRequest, jcfg, max_new)))
        eng, reqs = port_run(cfg, tp, dict(kw, **extra), max_new)
        got[loop] = streams(reqs)
        assert got[loop] == want.get(loop, want["b8"]), loop
        assert sorted(eng._enc_rows.encodes) == list(range(len(reqs))), loop
        assert not eng._enc_rows  # every request ended: its rows went
        if pressured:
            assert sum(r.preempts for r in reqs) > 0, loop
    if not pressured:
        assert got["b8"] == got["b1"] == got["eager"]
        assert all(o == "done" for _, o in want["b8"])


def test_encoder_conditioning_reaches_every_decode(model):
    """Served greedy streams equal the teacher-forced oracle through the
    training path (``build_inputs`` + ``forward_hidden``, conditioned by
    construction) for two feature sets whose next-token logits differ, on
    the eager and fused loops; the oracle equals the JAX package's."""
    jcfg, jp, cfg, tp = model
    key = "frames" if cfg.is_encoder_decoder else "image_embeds"
    rng = np.random.default_rng(3)
    prompt = rng.integers(0, cfg.vocab, size=5).astype(np.int32)
    fa, fb = (rng.standard_normal(cfg.enc_feats_shape).astype(np.float32)
              for _ in range(2))

    def logits(toks, f):
        batch = {"tokens": torch.from_numpy(np.asarray(toks, np.int32)[None]),
                 key: torch.from_numpy(f[None])}
        x, positions, enc_out = T.build_inputs(cfg, tp, batch)
        h, _ = T.forward_hidden(cfg, tp, x, positions, enc_out=enc_out)
        return T.unembed(cfg, tp, h)[0, -1]

    def oracle(f, n=4):
        toks = list(map(int, prompt))
        for _ in range(n):
            toks.append(int(torch.argmax(logits(toks, f))))
        return toks[len(prompt):]

    assert float((logits(prompt, fa) - logits(prompt, fb)).abs().max()) > 1e-3
    for f in (fa, fb):
        want = oracle(f)
        jbatch = {"tokens": prompt[None], key: f[None]}
        x, positions, enc_out = JT.build_inputs(jcfg, jp, jbatch)
        h, _, _ = JT.forward_hidden(jcfg, jp, x, positions, enc_out=enc_out)
        np.testing.assert_allclose(
            logits(prompt, f).detach().numpy(),
            np.asarray(JT.unembed(jcfg, jp, h)[0, -1]), rtol=1e-5, atol=1e-5)
        for fused in (False, True):
            eng = ServeEngine(cfg, tp, slots=1, max_len=32, fused=fused,
                              device="cpu")
            r = Request(uid=0, prompt=prompt.copy(), max_new=4, enc_feats=f)
            eng.run([r])
            assert r.done and r.out == want


def test_no_xattn_decode_is_unreachable(model):
    """A whisper decoder layer refuses to run without the encoder's
    output rather than skip its cross-attention, in the plain forward and
    in a serving step; a vlm layer has no cross-attention to refuse."""
    _, _, cfg, tp = model
    x = T.embed_tokens(cfg, tp, torch.zeros((1, 4), dtype=torch.long))
    if not cfg.is_encoder_decoder:
        h, _ = T.forward_hidden(cfg, tp, x, torch.arange(4)[None])
        assert torch.isfinite(h).all()
        return
    with pytest.raises(ValueError, match="refusing to silently skip"):
        T.forward_hidden(cfg, tp, x, torch.arange(4)[None])
    caches = T.init_caches(cfg, 1, 8, device="cpu")
    with pytest.raises(ValueError, match="refusing to silently skip"):
        T.decode_step(cfg, tp, torch.zeros((1, 1), dtype=torch.long),
                      caches, torch.zeros(1, dtype=torch.long))


def test_submit_enc_feats_guard(model):
    """Typed rejections: no ``enc_feats`` on an encoder config
    (``missing_enc_feats``, in ``submit`` and shed by ``run``), features on
    a decoder-only config (``unexpected_enc_feats``); features of the
    wrong shape raise, as the JAX engine's do."""
    rng = np.random.default_rng(0)
    _, _, cfg, tp = model
    eng = ServeEngine(cfg, tp, slots=1, max_len=24, device="cpu")
    bad = Request(uid=0, prompt=np.asarray([1, 2, 3], np.int32), max_new=2)
    assert eng.submit(bad) == (False, "missing_enc_feats")
    assert bad.outcome == "rejected" and not eng.queue
    bad2 = Request(uid=1, prompt=np.asarray([1, 2], np.int32), max_new=2)
    good = Request(uid=2, prompt=np.asarray([1, 2], np.int32), max_new=2,
                   enc_feats=rng.standard_normal(
                       cfg.enc_feats_shape).astype(np.float32))
    eng.run([bad2, good])
    assert bad2.outcome == "rejected" and bad2.out == [] and good.done
    assert eng.last_run_report["outcomes"]["rejected"] == 1
    with pytest.raises(ValueError, match="encoder geometry"):
        eng.submit(Request(uid=3, prompt=np.asarray([1], np.int32),
                           max_new=1, enc_feats=np.zeros((3, 5), np.float32)))
    qcfg = configs.get_reduced("qwen2-1.5b")
    qp = T.init_params(qcfg, torch.Generator().manual_seed(0), device="cpu")
    eng = ServeEngine(qcfg, qp, slots=1, max_len=16, device="cpu")
    stray = Request(uid=0, prompt=np.asarray([1, 2], np.int32), max_new=2,
                    enc_feats=np.zeros((4, 8), np.float32))
    assert eng.submit(stray) == (False, "unexpected_enc_feats")


def test_prefix_and_runs_are_priced_and_reported(model):
    """paligemma's prefix counts against the request's budget; a run's
    pages count in the admission check and in ``memory_report``
    (``enc_run_bytes`` as the JAX engine reports it)."""
    jcfg, jp, cfg, tp = model
    E = cfg.enc_feats_shape[0] if cfg.family == "vlm" else cfg.enc_len
    feats = np.zeros(cfg.enc_feats_shape, np.float32)
    eng = ServeEngine(cfg, tp, device="cpu", **PAGED)
    if cfg.family == "vlm":
        with pytest.raises(ValueError, match="cannot fit"):
            eng.submit(Request(uid=0, prompt=np.ones(40 - E - 1, np.int32),
                               max_new=1, enc_feats=feats))
    small = ServeEngine(cfg, tp, device="cpu", **dict(PAGED, page_budget=11))
    with pytest.raises(ValueError, match="encoder-run pages"):
        small.submit(Request(uid=0, prompt=np.ones(3, np.int32), max_new=1,
                             enc_feats=feats))
    for kw in (BASE, PAGED):
        # one chunk in, three streams resident
        eng = ServeEngine(cfg, tp, device="cpu", **kw)
        eng.run(requests(Request, cfg), max_ticks=kw["chunk"])
        je = JServeEngine(jcfg, jp, **kw)
        je.run(requests(JRequest, jcfg), max_ticks=kw["chunk"])
        got, want = eng.memory_report(), je.memory_report()
        assert got["resident_streams"] == 3
        for k in ("resident_streams", "enc_tokens", "enc_run_bytes",
                  "enc_arena_bytes", "enc_pages_per_stream", "pages_in_use",
                  "kv_cache_bytes"):
            assert got.get(k) == want.get(k), k
        assert got["enc_tokens"] == E and got["enc_run_bytes"] > 0
