"""The port's fleet adaptation (``TinyTrainSession.adapt_many`` under a
given policy) on the CPU against the JAX package's, on qwen2-smoke in f32
with the JAX weights bridged across and the same episodes from the same
seeds: a mix of way/shot tasks in two buckets gives the same per-task
losses, deltas, skipped steps, host transfers and fleet report.  Within
the port: one task through ``adapt_many`` equals ``adapt`` under the same
policy; a static criterion raises ``ValueError`` as in the JAX package,
and ``mesh=`` and ``hosts=`` raise naming their ROADMAP item."""
import jax
import numpy as np
import pytest
import torch

from repro import api as japi
from repro import configs as jconfigs
from repro.core import lm_backbone as jlm_backbone
from repro.core.session import Task as JTask
from repro.data import synthetic as jsyn
from repro_torch import api, bridge, configs
from repro_torch.core import adapt as telemetry
from repro_torch.core.backbones import lm_backbone
from repro_torch.core.policy import SelectedUnit, SparseUpdatePolicy
from repro_torch.core.session import Task
from repro_torch.data import synthetic as syn

ITERS = 4
SEQ = 16
# (way, shots): support rows 8, 6 -> bucket 8; 16, 15 -> bucket 16
MIX = ((2, 4), (3, 2), (4, 4), (3, 5))


def port_policy(p):
    return SparseUpdatePolicy(
        horizon=p.horizon,
        units=tuple(SelectedUnit(u.layer, u.kind, tuple(int(c) for c in
                                                        u.channels))
                    for u in p.units),
        meta=dict(p.meta or {}))


def tasks(mod, task_cls, vocab):
    out = []
    for i, (way, shots) in enumerate(MIX):
        rng = np.random.default_rng(30 + i)
        ep = mod.lm_episode(rng, vocab, SEQ, max_way=way, min_way=way,
                            shots=shots, query_per_class=2)
        out.append(task_cls.from_episode(ep, rng, 5, name=f"user{i}"))
    return out


def trees_close(port_tree, jax_tree, **tol):
    want = jax.tree_util.tree_map(np.asarray, jax_tree)
    got = bridge.tree_to_numpy(port_tree)
    assert jax.tree_util.tree_structure(got) == \
        jax.tree_util.tree_structure(want)
    for g, w in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(want)):
        np.testing.assert_allclose(g, np.asarray(w, np.float32), **tol)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def ref():
    """The JAX package's fleet run, once per module, and the port's on the
    bridged weights under the same policy."""
    jcfg = jconfigs.get_reduced("qwen2-1.5b")
    jbb = jlm_backbone(jcfg, tokens_per_batch=16 * SEQ, batch_size=16)
    js = japi.TinyTrainSession(jbb, max_way=5, seed=0)
    probe = japi.sample_lm_task(np.random.default_rng(0), jcfg.vocab,
                                seq=SEQ, max_way=5, support_pad=32,
                                query_pad=32)
    jpolicy = js.adapt(probe, japi.JETSON_NANO, iters=1).policy
    jres = js.adapt_many(tasks(jsyn, JTask, jcfg.vocab), japi.JETSON_NANO,
                         iters=ITERS, policy_override=jpolicy)
    cfg = configs.get_reduced("qwen2-1.5b")
    bb = lm_backbone(cfg, tokens_per_batch=16 * SEQ, batch_size=16)
    params = bridge.params_from_numpy(
        cfg, jax.tree_util.tree_map(np.asarray, js.params), device="cpu")
    session = api.TinyTrainSession(bb, params, max_way=5)
    policy = port_policy(jpolicy)
    syncs = telemetry.host_sync_count()
    res = session.adapt_many(tasks(syn, Task, cfg.vocab), api.JETSON_NANO,
                             iters=ITERS, policy_override=policy)
    syncs = telemetry.host_sync_count() - syncs
    return dict(jres=jres, jreport=dict(js.last_fleet_report), res=res,
                report=dict(session.last_fleet_report), session=session,
                policy=policy, syncs=syncs)


def test_policy_covers_both_kinds(ref):
    assert {u.kind for u in ref["policy"].units} == {"attn", "mlp"}


@pytest.mark.parametrize("i", range(len(MIX)))
def test_losses_deltas_and_counts_match_reference(ref, i):
    got, want = ref["res"][i], ref["jres"][i]
    assert np.isfinite(got.losses).all() and len(got.losses) == ITERS
    np.testing.assert_allclose(got.losses, want.losses, rtol=1e-4, atol=1e-4)
    trees_close(got.deltas, want.deltas, rtol=2e-3, atol=2e-4)
    assert got.skipped_steps == want.skipped_steps
    assert got.host_transfers == pytest.approx(want.host_transfers)
    assert got.method == want.method
    assert got.accuracy() == pytest.approx(want.accuracy(), abs=1e-6)


def test_fleet_report_matches_reference(ref):
    got, want = ref["report"], ref["jreport"]
    for k in ("tasks", "bucketed", "buckets", "policy_structures", "groups",
              "hosts", "ingestion"):
        assert got[k] == want[k], k
    assert got["buckets"] == got["groups"] == 2
    assert got["scan_compiles"] == 2


def test_one_host_fetch_per_group(ref):
    assert ref["syncs"] == ref["report"]["groups"]
    assert sum(r.host_transfers for r in ref["res"]) == pytest.approx(2.0)


def test_one_task_equals_adapt(ref):
    session, policy = ref["session"], ref["policy"]
    task = tasks(syn, Task, session.backbone.cfg.vocab)[2]
    many = session.adapt_many([task], api.JETSON_NANO, iters=ITERS,
                              policy_override=policy)[0]
    one = session.adapt(task, api.JETSON_NANO, iters=ITERS,
                        policy_override=policy)
    np.testing.assert_allclose(many.losses, one.losses, rtol=1e-5,
                               atol=1e-6)
    for a, b in zip(jax.tree_util.tree_leaves(bridge.tree_to_numpy(
            many.deltas)), jax.tree_util.tree_leaves(
                bridge.tree_to_numpy(one.deltas))):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-6)
    assert many.host_transfers == 1.0


def test_unbucketed_groups_by_exact_shape(ref):
    session, policy = ref["session"], ref["policy"]
    ts = tasks(syn, Task, session.backbone.cfg.vocab)
    session.adapt_many(ts, api.JETSON_NANO, iters=1, policy_override=policy,
                       bucket=False)
    assert session.last_fleet_report["groups"] == len(MIX)
    assert session.last_fleet_report["bucketed"] is False
    assert session.adapt_many([], api.JETSON_NANO,
                              policy_override=policy) == []


def test_routes_of_later_items_raise(ref):
    session, policy = ref["session"], ref["policy"]
    task = tasks(syn, Task, session.backbone.cfg.vocab)[0]
    with pytest.raises(ValueError, match="static channel mode"):
        session.adapt_many([task], api.JETSON_NANO, criterion="random")
    with pytest.raises(NotImplementedError, match="item 16"):
        session.adapt_many([task], api.JETSON_NANO, policy_override=policy,
                           mesh=object())
    with pytest.raises(NotImplementedError, match="item 16"):
        session.adapt_many([task], api.JETSON_NANO, policy_override=policy,
                           hosts=2)


def test_noise_level_gradient_takes_the_same_step_in_both_paths(ref):
    """A 3-way 5-shot task from seed 23 has one MLP delta element whose
    first gradient is about 1e-8, float32 noise and Adam's eps, so its
    first update differs from the JAX package's (-0.00131 against
    -0.00217) in ``adapt`` as in ``adapt_many`` (ROADMAP section 3).
    Within the port the two paths take the same steps."""
    session, policy = ref["session"], ref["policy"]
    rng = np.random.default_rng(23)
    ep = syn.lm_episode(rng, session.backbone.cfg.vocab, SEQ, max_way=3,
                        min_way=3, shots=5, query_per_class=2)
    task = Task.from_episode(ep, rng, 5)
    many = session.adapt_many([task], api.JETSON_NANO, iters=ITERS,
                              policy_override=policy)[0]
    one = session.adapt(task, api.JETSON_NANO, iters=ITERS,
                        policy_override=policy)
    np.testing.assert_allclose(many.losses, one.losses, rtol=1e-4, atol=1e-4)
    for a, b in zip(jax.tree_util.tree_leaves(bridge.tree_to_numpy(
            many.deltas)), jax.tree_util.tree_leaves(
                bridge.tree_to_numpy(one.deltas))):
        np.testing.assert_allclose(a, b, rtol=2e-3, atol=2e-4)
