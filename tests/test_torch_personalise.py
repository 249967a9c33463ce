"""The port's per-slot personalisation on the CPU against the JAX
package's, on qwen2-smoke in f32 with the JAX weights and deltas bridged
across: the twins of ``tests/test_personalise.py``'s dense cases.

Two users' delta sets resident at once give streams equal to each user's
folded serving copy in the port and to the JAX engine's ``personalise=``
streams, at prefill blocks 1 and 8, on contiguous and paged caches; an
unknown user serves the base model; a hot swap mid-run changes only the
swapped user's later tokens; a preempted and requeued stream resumes with
the same deltas; deltas sent to an engine without personalisation are
rejected with a typed reason; and the ``Personaliser`` closed loop
(adapt_many -> int8 error-feedback exchange -> hot swap) runs the JAX
package's rounds, users, deferrals, payload bytes, swapped rows and
streams."""
import jax
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core import TinyTrainSession as JSession
from repro.core import lm_backbone as jlm_backbone
from repro.core.policy import SelectedUnit as JUnit
from repro.core.policy import SparseUpdatePolicy as JPolicy
from repro.models import transformer as JT
from repro.models.api import ArchConfig as JArchConfig
from repro.serving import DeltaSet as JDeltaSet
from repro.serving import Personaliser as JPersonaliser
from repro.serving import Request as JRequest
from repro.serving import ServeEngine as JServeEngine
from repro_torch import api, bridge, configs
from repro_torch.core import adapt as telemetry
from repro_torch.core.backbones import lm_backbone
from repro_torch.core.policy import SelectedUnit, SparseUpdatePolicy
from repro_torch.models import layers as L
from repro_torch.models import overlay as OV
from repro_torch.models.api import ArchConfig
from repro_torch.serving import (
    DeltaSet, Personaliser, Request, ServeEngine,
)

ENGINE = dict(slots=2, max_len=24, chunk=8)
MODES = {"block1": dict(prefill_block=1), "block8": dict(prefill_block=8),
         "paged_block1": dict(prefill_block=1, kv_paging=True,
                              kv_page_size=4),
         "paged_block8": dict(prefill_block=8, kv_paging=True,
                              kv_page_size=4)}
# half the fixed-stripe pages (4 slots x 4 pages of 8 rows): growth runs
# the pool dry and the youngest stream is preempted and requeued
PRESSURE = dict(slots=4, max_len=32, chunk=8, kv_paging=True,
                kv_page_size=8)


def covering_policy(bb, unit_cls, policy_cls):
    """One unit of every kind the backbone exposes (first + last channel),
    as the reference test builds it."""
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


def prompts_for(vocab, seed, n=4, lo=3, hi=8):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=int(rng.integers(lo, hi)))
            .astype(np.int32) for _ in range(n)]


def make(cls, prompts, max_new=4, users=2):
    return [cls(uid=i % users, prompt=p.copy(), max_new=max_new)
            for i, p in enumerate(prompts)]


def streams(reqs):
    return [(list(r.out), r.outcome) for r in reqs]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def ref():
    """The JAX engine's personalised streams, once per module, and the
    port's weights, policy and two users' deltas bridged from it."""
    jcfg = jconfigs.get_reduced("qwen2-1.5b")
    jparams = JT.init_params(jcfg, jax.random.PRNGKey(0))
    jbb = jlm_backbone(jcfg, tokens_per_batch=32, batch_size=2)
    jpolicy = covering_policy(jbb, JUnit, JPolicy)
    jdeltas = {0: rand_deltas(jbb, jpolicy, 3, 0.5),
               1: rand_deltas(jbb, jpolicy, 4, 0.5)}
    prompts = prompts_for(jcfg.vocab, 2)
    out = {"prompts": prompts, "streams": {}}
    for mode, kw in MODES.items():
        eng = JServeEngine(jcfg, jparams, personalise=jpolicy,
                           **ENGINE, **kw)
        for uid, d in jdeltas.items():
            eng.swap_deltas(uid, JDeltaSet.from_policy(jpolicy, d))
        out["streams"][mode] = streams(eng.run(make(JRequest, prompts)))
    p8 = prompts_for(jcfg.vocab, 1, n=8, lo=3, hi=9)
    out["p8"] = p8
    for what, kw in (("pressure", dict(page_budget=8)), ("roomy", {})):
        eng = JServeEngine(jcfg, jparams, personalise=jpolicy, **PRESSURE,
                           **kw)
        for uid, d in jdeltas.items():
            eng.swap_deltas(uid, JDeltaSet.from_policy(jpolicy, d))
        reqs = make(JRequest, p8, max_new=16)
        eng.run(reqs)
        out[what] = [(list(r.out), r.outcome, r.preempts) for r in reqs]

    cfg = configs.get_reduced("qwen2-1.5b")
    params = bridge.params_from_numpy(
        cfg, jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    policy = covering_policy(lm_backbone(cfg, 32, 2), SelectedUnit,
                             SparseUpdatePolicy)
    assert [(u.layer, u.kind, u.channels) for u in policy.units] == \
        [(u.layer, u.kind, u.channels) for u in jpolicy.units]
    deltas = {u: bridge.tree_from_numpy(d, device="cpu")
              for u, d in jdeltas.items()}
    return cfg, params, policy, deltas, out


def personalised(cfg, params, policy, deltas, **kw):
    eng = ServeEngine(cfg, params, personalise=policy, device="cpu", **kw)
    for uid, d in deltas.items():
        assert eng.swap_deltas(uid, DeltaSet.from_policy(policy, d)) == 0
    return eng


@pytest.mark.parametrize("mode", list(MODES))
def test_overlay_matches_folded_oracle_and_reference(ref, mode):
    cfg, params, policy, deltas, out = ref
    kw = dict(ENGINE, **MODES[mode])
    eng = personalised(cfg, params, policy, deltas, **kw)
    got = streams(eng.run(make(Request, out["prompts"])))
    assert all(o == "done" for _, o in got)
    assert got == out["streams"][mode]
    per_user = {}
    for uid, d in deltas.items():
        folded = ServeEngine(cfg, OV.fold_deltas(cfg, params, d, policy),
                             device="cpu", **kw)
        per_user[uid] = streams(folded.run(make(Request, out["prompts"])))
    assert got == [per_user[i % 2][i] for i in range(len(got))]
    base = streams(ServeEngine(cfg, params, device="cpu", **kw).run(
        make(Request, out["prompts"])))
    assert base != got  # the deltas change what is served


@pytest.mark.parametrize("block", [1, 8])
def test_unknown_user_serves_base_model(ref, block):
    cfg, params, policy, _, out = ref
    kw = dict(ENGINE, prefill_block=block)
    pers = ServeEngine(cfg, params, personalise=policy, device="cpu", **kw)
    plain = ServeEngine(cfg, params, device="cpu", **kw)
    reqs = [Request(uid=10 + i, prompt=p, max_new=4)
            for i, p in enumerate(out["prompts"])]
    want = [Request(uid=10 + i, prompt=p, max_new=4)
            for i, p in enumerate(out["prompts"])]
    assert streams(pers.run(reqs)) == streams(plain.run(want))


def test_hot_swap_mid_run_changes_only_swapped_user(ref):
    cfg, params, policy, deltas, out = ref
    fresh = {k: {kk: {n: -3 * t for n, t in v.items()}
                 for kk, v in d.items()} for k, d in deltas[0].items()}
    prompts = out["prompts"][:2]
    chunk = 4

    def run_once(swap_mid):
        eng = personalised(cfg, params, policy, deltas, slots=2, max_len=40,
                           chunk=chunk, prefill_block=4)
        reqs = [Request(uid=i, prompt=p, max_new=16)
                for i, p in enumerate(prompts)]
        eng.run(reqs, max_ticks=2 * chunk, chunk=chunk)
        prefix = [list(r.out) for r in reqs]
        if swap_mid:
            before = telemetry.host_sync_count()
            assert eng.swap_deltas(0, DeltaSet.from_policy(policy, fresh)) == 1
            assert telemetry.host_sync_count() == before  # no host read
        while not all(r.done for r in reqs):
            eng.run([], max_ticks=chunk, chunk=chunk)
        return prefix, [list(r.out) for r in reqs]

    prefix_a, want = run_once(swap_mid=False)
    prefix_b, got = run_once(swap_mid=True)
    assert prefix_a == prefix_b
    n0 = len(prefix_a[0])
    assert 0 < n0 < 16
    assert got[0][:n0] == want[0][:n0]  # the swapped user's prefix stays
    assert got[0] != want[0]            # ... and later tokens change
    assert got[1] == want[1]            # the other user is untouched


def test_preempt_requeue_reattaches_delta_set(ref):
    """At half the pages streams are preempted and requeued; each resumes
    with its own user's deltas, so every stream equals the unpressured
    personalised run's, and both equal the JAX engine's."""
    cfg, params, policy, deltas, out = ref
    runs = {}
    for what, kw in (("pressure", dict(page_budget=8)), ("roomy", {})):
        eng = personalised(cfg, params, policy, deltas, **PRESSURE, **kw)
        reqs = make(Request, out["p8"], max_new=16)
        eng.run(reqs)
        runs[what] = [(list(r.out), r.outcome, r.preempts) for r in reqs]
        assert runs[what] == out[what]
    assert sum(p for _, _, p in runs["pressure"]) >= 1
    assert [s for s, _, _ in runs["pressure"]] == \
        [s for s, _, _ in runs["roomy"]]


def test_typed_reject_and_validation(ref):
    cfg, params, policy, deltas, out = ref
    ds = DeltaSet.from_policy(policy, deltas[0])
    prompt = out["prompts"][0]
    plain = ServeEngine(cfg, params, device="cpu", **ENGINE)
    stray = Request(uid=0, prompt=prompt.copy(), max_new=2, delta_set=ds)
    assert plain.submit(stray) == (False, "unexpected_delta_set")
    assert stray.outcome == "rejected" and stray.terminal
    shed = Request(uid=0, prompt=prompt.copy(), max_new=2, delta_set=ds)
    plain.run([shed])
    assert shed.outcome == "rejected"
    assert plain.last_run_report["outcomes"] == {"rejected": 1}
    with pytest.raises(RuntimeError, match="personalise"):
        plain.swap_deltas(0, ds)

    pers = ServeEngine(cfg, params, personalise=policy, device="cpu",
                       **ENGINE)
    bad = DeltaSet(deltas=ds.deltas,
                   channels={lk: {k: np.zeros((7,), np.int64) for k in kinds}
                             for lk, kinds in ds.channels.items()})
    with pytest.raises(ValueError, match="channels"):
        pers.swap_deltas(0, bad)
    first = next(iter(ds.deltas))
    gutted = DeltaSet(
        deltas={lk: v for lk, v in ds.deltas.items() if lk != first},
        channels={lk: v for lk, v in ds.channels.items() if lk != first})
    with pytest.raises(ValueError, match="missing unit"):
        pers.swap_deltas(0, gutted)
    with pytest.raises(ValueError, match="missing unit"):
        pers.submit(Request(uid=0, prompt=prompt.copy(), max_new=2,
                            delta_set=gutted))
    pers.swap_deltas(0, ds)
    pers.swap_deltas(0, None)  # back to the base model
    assert 0 not in pers._user_deltas


def test_memory_report_counts_the_arena(ref):
    cfg, params, policy, deltas, _ = ref
    eng = personalised(cfg, params, policy, deltas, **ENGINE)
    rep = eng.memory_report()
    per_slot = sum(t.numel() * t.element_size() for d in deltas[0].values()
                   for pack in d.values() for t in pack.values())
    per_slot += sum(8 * u.n_channels for u in policy.units)  # int64 idx
    assert rep["delta_arena_bytes"] == ENGINE["slots"] * per_slot
    assert rep["delta_bytes_per_stream"] == per_slot
    assert rep["params_bytes_folded_copy"] > 10 * per_slot


def test_slot_params_is_the_fold_per_slot(ref):
    """Per-slot effective weights equal a folded copy's weights exactly,
    a zero row is the base weights, bmm of broadcast weights equals the
    shared product, and kinds of later slices raise naming item 9."""
    cfg, params, policy, deltas, _ = ref
    for u in policy.units:
        d_stack = {n: torch.stack([deltas[0][f"L{u.layer}"][u.kind][n],
                                   torch.zeros_like(
                                       deltas[0][f"L{u.layer}"][u.kind][n])])
                   for n in deltas[0][f"L{u.layer}"][u.kind]}
        idx = torch.tensor([u.channels, u.channels])
        lp = {k: v[u.layer] for k, v in params["stacks"]["g0"][u.kind].items()}
        eff = OV.slot_params(cfg, u.kind, lp, d_stack, idx)
        folded = OV.fold_deltas(cfg, params, deltas[0], policy)
        for n in d_stack:
            assert torch.equal(eff[n][0],
                               folded["stacks"]["g0"][u.kind][n][u.layer])
            assert torch.equal(eff[n][1], lp[n])
            x = torch.randn(2, 3, eff[n].shape[1])
            assert torch.equal(L.bmm(x, lp[n].expand(2, *lp[n].shape)),
                               x @ lp[n])
    with pytest.raises(NotImplementedError, match="item 9"):
        OV.slot_params(cfg, "moe", {}, {}, torch.zeros((2, 1),
                                                       dtype=torch.int64))


def test_delta_set_keeps_tensors():
    t = torch.ones(2, 3)
    ds = DeltaSet(deltas={"L0": {"mlp": {"w_up": t, "w_down": np.ones(
        (3, 2), np.float32)}}}, channels={"L0": {"mlp": [0, 2, 4]}})
    assert ds.deltas["L0"]["mlp"]["w_up"] is not None
    assert isinstance(ds.deltas["L0"]["mlp"]["w_down"], torch.Tensor)
    assert ds.channels["L0"]["mlp"].dtype == torch.int64


# ---------------------------------------------------------------------------
# The Personaliser closed loop against the JAX package's
# ---------------------------------------------------------------------------

TINY = dict(name="t", family="dense", n_layers=2, d_model=32, vocab=64,
            n_heads=2, n_kv_heads=2, head_dim=16, d_ff=64, dtype="float32")
LOOP_ENGINE = dict(slots=2, max_len=32, chunk=4, prefill_block=4)
LOOP = dict(iters=2, min_streams=2, seq=16, refresh_cap=1)


def loop_requests(cls, users=3):
    rng = np.random.default_rng(5)
    return [cls(uid=i % users, prompt=rng.integers(0, 64, size=5)
                .astype(np.int32), max_new=5) for i in range(9)]


def wave2(cls):
    rng = np.random.default_rng(6)
    return [cls(uid=i % 3, prompt=rng.integers(0, 64, size=5)
                .astype(np.int32), max_new=4) for i in range(4)]


@pytest.fixture(scope="module")
def loop():
    """The JAX Personaliser's run, once per module, and the port's on the
    bridged weights: three users, at most one refreshed per window."""
    jcfg = JArchConfig(**TINY).validate()
    jparams = JT.init_params(jcfg, jax.random.PRNGKey(0))
    jbb = jlm_backbone(jcfg, tokens_per_batch=32, batch_size=2)
    jpolicy = covering_policy(jbb, JUnit, JPolicy)
    jeng = JServeEngine(jcfg, jparams, personalise=jpolicy, **LOOP_ENGINE)
    jpers = JPersonaliser(JSession(jbb, jparams, seed=0), jeng, jpolicy,
                          **LOOP)
    jreqs = loop_requests(JRequest)
    jrep = jpers.run_online(jreqs)
    jw2 = wave2(JRequest)
    jeng.run(jw2)

    cfg = ArchConfig(**TINY).validate()
    params = bridge.params_from_numpy(
        cfg, jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    bb = lm_backbone(cfg, tokens_per_batch=32, batch_size=2)
    policy = covering_policy(bb, SelectedUnit, SparseUpdatePolicy)
    eng = ServeEngine(cfg, params, personalise=policy, device="cpu",
                      **LOOP_ENGINE)
    pers = Personaliser(api.TinyTrainSession(bb, params, seed=0), eng,
                        policy, **LOOP)
    reqs = loop_requests(Request)
    rep = pers.run_online(reqs)
    w2 = wave2(Request)
    eng.run(w2)
    return dict(jrep=jrep, jreqs=jreqs, jw2=jw2, jpers=jpers, rep=rep,
                reqs=reqs, w2=w2, pers=pers)


REFRESH_KEYS = ("round", "users", "deferred_users", "window",
                "resident_rows_swapped", "payload_bytes_f32",
                "payload_bytes_wire", "payload_ratio", "wire_serialized")


def test_personaliser_rounds_match_reference(loop):
    got, want = loop["rep"], loop["jrep"]
    assert got["all_done"] and want["all_done"]
    assert got["rounds"] == want["rounds"] and got["ticks"] == want["ticks"]
    assert len(got["refreshes"]) == len(want["refreshes"]) >= 2
    for g, w in zip(got["refreshes"], want["refreshes"]):
        assert {k: g[k] for k in REFRESH_KEYS} == \
            {k: w[k] for k in REFRESH_KEYS}
        assert g["payload_ratio"] > 3.0
    assert any(r["deferred_users"] for r in got["refreshes"])
    assert set(loop["pers"]._ef) == set(loop["jpers"]._ef)


def test_personaliser_streams_match_reference(loop):
    assert streams(loop["reqs"]) == streams(loop["jreqs"])
    # the second wave serves the refreshed users' exchanged deltas
    assert streams(loop["w2"]) == streams(loop["jw2"])
    assert all(r.done for r in loop["w2"])


def test_personaliser_exchange_state_matches_reference(loop):
    """Each refreshed user's error-feedback residual is the JAX package's
    (the exchange ran on deltas within the fine-tune's tolerance)."""
    for uid, ef in loop["pers"]._ef.items():
        want = jax.tree_util.tree_map(np.asarray, loop["jpers"]._ef[uid])
        got = bridge.tree_to_numpy(ef)
        for a, b in zip(jax.tree_util.tree_leaves(got),
                        jax.tree_util.tree_leaves(want)):
            np.testing.assert_allclose(a, b, rtol=2e-3, atol=2e-4)


def test_personaliser_without_compression_swaps_full_precision(loop):
    """``compress=False`` swaps the fine-tuned deltas as they are: payload
    ratio 1.0 and no error-feedback state."""
    pers = loop["pers"]
    plain = Personaliser(pers.session, pers.engine, pers.policy,
                         compress=False, iters=1, seq=16)
    rng = np.random.default_rng(8)
    plain._streams[0] = [rng.integers(0, 64, 9).astype(np.int32)
                         for _ in range(2)]
    rep = plain.refresh()
    assert rep["users"] == [0] and rep["payload_ratio"] == 1.0
    assert rep["payload_bytes_wire"] == rep["payload_bytes_f32"]
    assert not plain._ef and plain._streams[0] == []
    assert plain.refresh() == {}  # nobody eligible any more


def test_personaliser_refuses_what_it_cannot_serve(loop):
    pers = loop["pers"]
    plain = ServeEngine(pers.engine.cfg, pers.engine.params, device="cpu",
                        **LOOP_ENGINE)
    with pytest.raises(ValueError, match="personalise"):
        Personaliser(pers.session, plain, pers.policy)
    with pytest.raises(ValueError, match="refresh_cap"):
        Personaliser(pers.session, pers.engine, pers.policy, refresh_cap=0)

    class Router:  # a FleetRouter's delta wire codec is item 16
        personalise = pers.policy

        def push_delta_payload(self, uid, payload):
            return 0

    with pytest.raises(NotImplementedError, match="item 16"):
        Personaliser(pers.session, Router(), pers.policy)


def test_serve_launcher_personalises(capsys):
    from repro_torch.launch import serve

    serve.main(["--preset", "smoke", "--device", "cpu", "--personalise",
                "--users", "2", "--requests", "4", "--max-new", "6",
                "--slots", "2", "--chunk", "8", "--adapt-iters", "2"])
    text = capsys.readouterr().out
    assert "personalising 2 users" in text
    assert "[serve] refresh 1: users [0, 1]" in text and "(4.0x)" in text
