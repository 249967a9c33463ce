"""Online personalisation of the ssm and hybrid families on the CPU against
the JAX package's: mamba2-smoke and zamba2-smoke, f32, the JAX weights
and two users' SSD-head deltas bridged across (the twins of
``tests/test_personalise.py``'s cases for these two archs).

The per-slot SSD overlay (each slot's ``w_z``/``w_x`` columns and
``w_out`` rows by SSD head) equals the folded weights; two users' deltas
resident at once stream as each user's folded copy does and as the JAX
engine's ``personalise=`` engine does, at prefill blocks 1 and 8, paged
and eager; the ``Personaliser`` closed loop (``adapt_many`` -> int8
error-feedback exchange -> hot swap) runs the JAX package's rounds,
users, deferrals, payload bytes, swapped rows, streams and residuals;
and ``adapt_many`` of two tasks equals ``adapt`` of each."""
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
from repro.serving import DeltaSet as JDeltaSet
from repro.serving import Personaliser as JPersonaliser
from repro.serving import Request as JRequest
from repro.serving import ServeEngine as JServeEngine
from repro_torch import api, bridge, configs
from repro_torch.core.backbones import lm_backbone
from repro_torch.core.policy import SelectedUnit, SparseUpdatePolicy
from repro_torch.models import overlay as OV
from repro_torch.serving import (
    DeltaSet, Personaliser, Request, ServeEngine,
)

ARCHS = ("mamba2-1.3b", "zamba2-1.2b")
ENGINE = dict(slots=2, max_len=24, chunk=8)
MODES = {"block1": dict(prefill_block=1), "block8": dict(prefill_block=8),
         "paged_block8": dict(prefill_block=8, kv_paging=True,
                              kv_page_size=4),
         "eager": dict(fused=False)}
LOOP_ENGINE = dict(slots=2, max_len=32, chunk=4, prefill_block=4)
LOOP = dict(iters=2, min_streams=2, seq=16, refresh_cap=1)
REFRESH_KEYS = ("round", "users", "deferred_users", "window",
                "resident_rows_swapped", "payload_bytes_f32",
                "payload_bytes_wire", "payload_ratio", "wire_serialized")


def covering_policy(bb, unit_cls, policy_cls):
    """One unit of every kind the backbone exposes (here one SSD unit,
    its first and last head), as the reference test builds it."""
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


def loop_requests(cls, vocab, users=3):
    rng = np.random.default_rng(5)
    return [cls(uid=i % users, prompt=rng.integers(0, vocab, size=5)
                .astype(np.int32), max_new=5) for i in range(9)]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module", params=ARCHS)
def ref(request):
    """The JAX engine's personalised streams in every mode and its
    Personaliser's run, once per module, and the port's weights, policy,
    two users' deltas and Personaliser run bridged from it."""
    arch = request.param
    jcfg = jconfigs.get_reduced(arch)
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
    jeng = JServeEngine(jcfg, jparams, personalise=jpolicy, **LOOP_ENGINE)
    jpers = JPersonaliser(JSession(jbb, jparams, seed=0), jeng, jpolicy,
                          **LOOP)
    jreqs = loop_requests(JRequest, jcfg.vocab)
    out["loop"] = jpers.run_online(jreqs)
    out["loop_streams"] = streams(jreqs)
    out["ef"] = {u: jax.tree_util.tree_map(np.asarray, e)
                 for u, e in jpers._ef.items()}

    cfg = configs.get_reduced(arch)
    params = bridge.params_from_numpy(
        cfg, jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    bb = lm_backbone(cfg, 32, 2)
    policy = covering_policy(bb, SelectedUnit, SparseUpdatePolicy)
    assert [(u.layer, u.kind, u.channels) for u in policy.units] == \
        [(u.layer, u.kind, u.channels) for u in jpolicy.units]
    assert {u.kind for u in policy.units} == {"ssm"}
    deltas = {u: bridge.tree_from_numpy(d, device="cpu")
              for u, d in jdeltas.items()}
    eng = ServeEngine(cfg, params, personalise=policy, device="cpu",
                      **LOOP_ENGINE)
    pers = Personaliser(api.TinyTrainSession(bb, params, seed=0), eng,
                        policy, **LOOP)
    reqs = loop_requests(Request, cfg.vocab)
    port = {"loop": pers.run_online(reqs), "loop_streams": streams(reqs),
            "ef": pers._ef}
    return cfg, params, policy, deltas, out, port


@pytest.mark.parametrize("mode", list(MODES))
def test_overlay_matches_folded_oracle_and_reference(ref, mode):
    cfg, params, policy, deltas, out, _ = ref
    kw = dict(ENGINE, **MODES[mode])
    eng = ServeEngine(cfg, params, personalise=policy, device="cpu", **kw)
    for uid, d in deltas.items():
        assert eng.swap_deltas(uid, DeltaSet.from_policy(policy, d)) == 0
    got = streams(eng.run(make(Request, out["prompts"])))
    assert all(o == "done" for _, o in got)
    assert got == out["streams"][mode]
    if kw.get("fused", True):
        rep = eng.last_run_report
        assert rep["host_syncs"] == rep["chunks"]
    per_user = {}
    for uid, d in deltas.items():
        folded = ServeEngine(cfg, OV.fold_deltas(cfg, params, d, policy),
                             device="cpu", **kw)
        per_user[uid] = streams(folded.run(make(Request, out["prompts"])))
    assert got == [per_user[i % 2][i] for i in range(len(got))]
    base = streams(ServeEngine(cfg, params, device="cpu", **kw).run(
        make(Request, out["prompts"])))
    assert base != got  # the deltas change what is served


def test_slot_params_is_the_fold_per_slot(ref):
    """A slot's SSD weights equal a folded copy's exactly (w_z and w_x
    columns, w_out rows by SSD head); a zero row is the base weights."""
    cfg, params, policy, deltas, _, _ = ref
    (u,) = policy.units
    d0 = deltas[0][f"L{u.layer}"]["ssm"]
    d_stack = {n: torch.stack([v, torch.zeros_like(v)]) for n, v in d0.items()}
    idx = torch.tensor([u.channels, u.channels])
    lp = {k: v[u.layer] for k, v in params["stacks"]["g0"]["ssm"].items()}
    eff = OV.slot_params(cfg, "ssm", lp, d_stack, idx)
    folded = OV.fold_deltas(cfg, params, deltas[0], policy)
    assert set(d_stack) == {"w_z", "w_x", "w_out"}
    for n in d_stack:
        assert eff[n].shape == (2,) + lp[n].shape
        assert torch.equal(eff[n][0],
                           folded["stacks"]["g0"]["ssm"][n][u.layer])
        assert torch.equal(eff[n][1], lp[n])
    assert eff["w_b"] is lp["w_b"]  # unedited weights stay shared


def test_personaliser_rounds_and_streams_match_reference(ref):
    *_, out, port = ref
    got, want = port["loop"], out["loop"]
    assert got["all_done"] and want["all_done"]
    assert got["rounds"] == want["rounds"] and got["ticks"] == want["ticks"]
    assert got["host_syncs"] == got["chunks"] == want["host_syncs"]
    assert len(got["refreshes"]) == len(want["refreshes"]) >= 2
    for g, w in zip(got["refreshes"], want["refreshes"]):
        assert {k: g[k] for k in REFRESH_KEYS} == \
            {k: w[k] for k in REFRESH_KEYS}
    assert any(r["deferred_users"] for r in got["refreshes"])
    assert port["loop_streams"] == out["loop_streams"]


def test_personaliser_exchange_state_matches_reference(ref):
    """Each refreshed user's error-feedback residual is the JAX package's
    (the exchange ran on deltas within the fine-tune's tolerance)."""
    *_, out, port = ref
    assert set(port["ef"]) == set(out["ef"])
    for uid, ef in port["ef"].items():
        got = bridge.tree_to_numpy(ef)
        for a, b in zip(jax.tree_util.tree_leaves(got),
                        jax.tree_util.tree_leaves(out["ef"][uid])):
            np.testing.assert_allclose(a, b, rtol=2e-3, atol=2e-4)


def test_adapt_many_equals_adapt_per_task(ref):
    """Two tasks of one shape through ``adapt_many`` (one vmapped
    fine-tune) give each task's own ``adapt`` under the same policy."""
    cfg, params, policy, *_ = ref
    bb = lm_backbone(cfg, tokens_per_batch=16 * 16, batch_size=16)
    session = api.TinyTrainSession(bb, params, max_way=4, device="cpu")
    tasks = [api.sample_lm_task(np.random.default_rng(s), cfg.vocab, seq=16,
                                max_way=4, support_pad=16, query_pad=16)
             for s in (0, 1)]
    many = session.adapt_many(tasks, api.JETSON_NANO, iters=3,
                              policy_override=policy)
    assert session.last_fleet_report["groups"] == 1
    for task, m in zip(tasks, many):
        one = session.adapt(task, api.JETSON_NANO, iters=3,
                            policy_override=policy)
        np.testing.assert_allclose(m.losses, one.losses, rtol=1e-5,
                                   atol=1e-6)
        for a, b in zip(jax.tree_util.tree_leaves(
                bridge.tree_to_numpy(m.deltas)),
                jax.tree_util.tree_leaves(bridge.tree_to_numpy(one.deltas))):
            np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-6)
