"""The port's eager serving loop (``ServeEngine(fused=False)``) on the CPU
against the JAX package's, with the JAX weights (and deltas) bridged
across: the parity matrix of ``tests/test_serve_scan.py`` and
``tests/test_paging.py``.  On contiguous and paged caches, under page
pressure with requeues, with two personalised users resident, with folded
deltas and on mamba2-smoke, greedy and sampled, the eager loop, the fused
engine at prefill block 1 and at block 8 give the same streams, outcomes
and preemptions as each other and as the JAX engine's eager loop; under
page pressure, where the two loops preempt on different ticks, each equals
its own JAX twin and every stream that finishes is the same in all.  Also
the twins of the reference's eager regression tests: a freed slot admits
in the tick that freed it, ``max_ticks`` budgets each call, truncation is
signalled, and eager ticks refuse to interleave with a fused run."""
import jax
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core import lm_backbone as jlm_backbone
from repro.core.policy import SelectedUnit as JUnit
from repro.core.policy import SparseUpdatePolicy as JPolicy
from repro.models import transformer as JT
from repro.serving import DeltaSet as JDeltaSet
from repro.serving import Request as JRequest
from repro.serving import ServeEngine as JServeEngine
from repro.serving import fold_deltas as jfold_deltas
from repro_torch import bridge, configs
from repro_torch.core.backbones import lm_backbone
from repro_torch.core.policy import SelectedUnit, SparseUpdatePolicy
from repro_torch.models import overlay as OV
from repro_torch.serving import DeltaSet, Request, ServeEngine

SMALL = dict(slots=2, max_len=24, chunk=8)
# half the fixed-stripe pages (4 slots x 4 pages of 8 rows): growth runs
# the pool dry and the youngest stream is preempted and requeued
PRESSURE = dict(slots=4, max_len=32, chunk=8, kv_paging=True,
                kv_page_size=8, page_budget=8)
CASES = {
    "contiguous": ("qwen2-1.5b", SMALL, dict(n=5)),
    "paged": ("qwen2-1.5b", dict(SMALL, kv_paging=True, kv_page_size=4),
              dict(n=5)),
    "pressure": ("qwen2-1.5b", PRESSURE, dict(n=8, hi=9, max_new=16)),
    "personalised": ("qwen2-1.5b", SMALL, dict(n=4, users=2)),
    "folded": ("qwen2-1.5b", SMALL, dict(n=4)),
    "mamba2": ("mamba2-1.3b", SMALL, dict(n=5)),
}
SAMPLING = {"greedy": {}, "sampled": dict(temperature=0.7, top_k=8,
                                          sample_seed=11)}
ENGINES = {"eager": dict(fused=False), "fused_b1": dict(prefill_block=1),
           "fused_b8": dict(prefill_block=8)}


def covering_policy(bb, unit_cls, policy_cls):
    """One unit of every kind the backbone exposes (first and last
    channel), as the reference tests build it."""
    units, seen = [], set()
    for c in reversed(bb.unit_costs):
        if c.kind not in seen:
            units.append(unit_cls(c.layer, c.kind,
                                  tuple(sorted({0, c.n_channels - 1}))))
            seen.add(c.kind)
    units.sort(key=lambda u: (u.layer, u.kind))
    return policy_cls(horizon=0, units=tuple(units))


def rand_deltas(jbb, policy, seed, scale):
    deltas = jbb.init_deltas(policy)
    leaves, treedef = jax.tree_util.tree_flatten(deltas)
    keys = jax.random.split(jax.random.PRNGKey(seed), len(leaves))
    leaves = [np.asarray(jax.random.normal(k, x.shape, x.dtype) * scale)
              for k, x in zip(keys, leaves)]
    return jax.tree_util.tree_unflatten(treedef, leaves)


def make(cls, vocab, n, lo=3, hi=8, max_new=4, users=None):
    rng = np.random.default_rng(1)
    return [cls(uid=i % users if users else i,
                prompt=rng.integers(0, vocab, size=int(rng.integers(lo, hi)))
                .astype(np.int32), max_new=max_new) for i in range(n)]


def streams(reqs):
    return [(list(r.out), r.outcome, r.preempts) for r in reqs]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def ref():
    """The JAX engine's eager streams of every case, once per module, and
    the port's weights, policy and deltas bridged from the JAX ones."""
    models, out = {}, {}
    for arch in ("qwen2-1.5b", "mamba2-1.3b"):
        jcfg = jconfigs.get_reduced(arch)
        jp = JT.init_params(jcfg, jax.random.PRNGKey(0))
        cfg = configs.get_reduced(arch)
        tp = bridge.params_from_numpy(
            cfg, jax.tree_util.tree_map(np.asarray, jp), device="cpu")
        models[arch] = (jcfg, jp, cfg, tp)
    jcfg, jp, cfg, tp = models["qwen2-1.5b"]
    jbb = jlm_backbone(jcfg, tokens_per_batch=32, batch_size=2)
    jpolicy = covering_policy(jbb, JUnit, JPolicy)
    jdeltas = {0: rand_deltas(jbb, jpolicy, 3, 0.5),
               1: rand_deltas(jbb, jpolicy, 4, 0.5)}
    jfolded = jfold_deltas(jcfg, jp, jdeltas[0], jpolicy)
    policy = covering_policy(lm_backbone(cfg, 32, 2), SelectedUnit,
                             SparseUpdatePolicy)
    deltas = {u: bridge.tree_from_numpy(d, device="cpu")
              for u, d in jdeltas.items()}
    folded = OV.fold_deltas(cfg, tp, deltas[0], policy)
    for case, (arch, kw, req_kw) in CASES.items():
        jcfg, jp, _, _ = models[arch]
        jkw = dict(kw)
        if case == "personalised":
            jkw["personalise"] = jpolicy
        # the eager loop and the fused engine schedule preemptions on
        # different ticks, so under pressure each has its own twin
        engines = ENGINES if case == "pressure" else {"eager": ENGINES[
            "eager"]}
        for samp, skw in SAMPLING.items():
            for name, ekw in engines.items():
                eng = JServeEngine(jcfg, jfolded if case == "folded" else jp,
                                   **jkw, **ekw, **skw)
                if case == "personalised":
                    for uid, d in jdeltas.items():
                        eng.swap_deltas(uid,
                                        JDeltaSet.from_policy(jpolicy, d))
                reqs = make(JRequest, jcfg.vocab, **req_kw)
                out[case, samp, name] = (streams(eng.run(reqs)),
                                         eng.last_run_report["outcomes"])
    return models, policy, deltas, folded, out


def port_engine(ref, case, **kw):
    models, policy, deltas, folded, _ = ref
    arch, ekw, _ = CASES[case]
    _, _, cfg, tp = models[arch]
    eng = ServeEngine(cfg, folded if case == "folded" else tp, device="cpu",
                      personalise=policy if case == "personalised" else None,
                      **{**ekw, **kw})
    if case == "personalised":
        for uid, d in deltas.items():
            eng.swap_deltas(uid, DeltaSet.from_policy(policy, d))
    return eng


@pytest.mark.parametrize("samp", list(SAMPLING))
@pytest.mark.parametrize("case", list(CASES))
def test_eager_equals_fused_and_reference(ref, case, samp):
    """Under pressure the eager loop preempts on other ticks than the
    fused engine, as in the JAX package: each equals its JAX twin in
    streams, outcomes and preemptions, and every stream that finishes is
    the same in all three."""
    models, _, _, _, out = ref
    cfg = models[CASES[case][0]][2]
    runs = {}
    for name, kw in ENGINES.items():
        eng = port_engine(ref, case, **kw, **SAMPLING[samp])
        reqs = make(Request, cfg.vocab, **CASES[case][2])
        runs[name] = streams(eng.run(reqs))
        rep = eng.last_run_report
        want, tally = out[case, samp, name if case == "pressure" else
                          "eager"]
        assert runs[name] == want and rep["outcomes"] == tally, name
        if name == "eager":
            # one tick a chunk; a read of the picked tokens every tick,
            # and of the free pages when a paged tick prices admission
            # or growth
            assert rep["chunks"] == rep["ticks"] == eng.ticks
            if eng.spec is None:
                assert rep["host_syncs"] == rep["chunks"]
            else:
                assert rep["host_syncs"] > rep["chunks"]
        else:
            assert rep["host_syncs"] == rep["chunks"]
    if case == "pressure":
        assert all(any(p for _, _, p in run) for run in runs.values())
        for a, b, c in zip(*runs.values()):
            if a[1] == b[1] == c[1] == "done":
                assert a[0] == b[0] == c[0]
    else:
        assert runs["eager"] == runs["fused_b1"] == runs["fused_b8"]
        assert all(o == "done" for _, o, _ in runs["eager"])


def test_eager_admits_immediately_after_eviction(ref):
    """A slot freed in a tick takes queued work in the same tick, as the
    fused tick's admission at its top leaves it."""
    eng = port_engine(ref, "contiguous", slots=1, max_len=32, fused=False)
    r1 = Request(uid=0, prompt=np.asarray([1, 2], np.int32), max_new=1)
    r2 = Request(uid=1, prompt=np.asarray([3], np.int32), max_new=1)
    eng.submit(r1)
    eng.submit(r2)
    while not r1.done:
        eng.step()
    assert eng.slots[0].req is r2
    assert not eng.queue


@pytest.mark.parametrize("fused", [False, True], ids=["eager", "fused"])
def test_run_budget_is_per_call(ref, fused):
    """``run(max_ticks=...)`` budgets the call, not the engine's
    lifetime."""
    models = ref[0]
    cfg = models["qwen2-1.5b"][2]
    eng = port_engine(ref, "contiguous", max_len=32, fused=fused)
    rng = np.random.default_rng(0)

    def batch():
        return [Request(uid=i, prompt=rng.integers(0, cfg.vocab, size=int(
            rng.integers(3, 8))).astype(np.int32), max_new=4)
            for i in range(6)]

    eng.run(batch())
    first = eng.ticks
    assert first > 10
    second = batch()
    eng.run(second, max_ticks=first + 5)
    assert all(r.done for r in second)
    assert eng.ticks > first


@pytest.mark.parametrize("fused", [False, True], ids=["eager", "fused"])
def test_length_eviction_sets_truncated(ref, fused):
    cfg = ref[0]["qwen2-1.5b"][2]
    eng = port_engine(ref, "contiguous", slots=1, max_len=12, chunk=4,
                      fused=fused)
    rng = np.random.default_rng(0)
    r = Request(uid=0, prompt=rng.integers(0, cfg.vocab, size=6)
                .astype(np.int32), max_new=100)
    done = Request(uid=1, prompt=rng.integers(0, cfg.vocab, size=3)
                   .astype(np.int32), max_new=2)
    eng.run([r, done])
    assert r.done and r.truncated and r.outcome == "truncated"
    # tokens emitted at positions 6 to max_len - 1 after a 6-token prefill
    assert len(r.out) == 6
    assert done.done and not done.truncated and len(done.out) == 2


def test_eager_and_fused_refuse_to_interleave(ref):
    cfg = ref[0]["qwen2-1.5b"][2]
    eng = port_engine(ref, "contiguous", chunk=2)
    reqs = make(Request, cfg.vocab, n=4)
    for r in reqs:
        eng.submit(r)
    eng.fused_begin()
    eng.fused_drain(eng.fused_dispatch())
    with pytest.raises(RuntimeError, match="fused run in flight"):
        eng.step()
    eager = port_engine(ref, "contiguous", fused=False)
    eager.submit(make(Request, cfg.vocab, n=1)[0])
    eager.step()
    with pytest.raises(RuntimeError, match="eager slots busy"):
        eager.fused_begin()
