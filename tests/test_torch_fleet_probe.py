"""``adapt_many``'s criterion route (no ``policy_override``: a Fisher probe
per task, batched over each episode shape) on the CPU against the JAX
package's, on qwen2-smoke in f32 with the port's seeded weights bridged
across and the same episodes from the same seeds: a mix of way/shot tasks
in two buckets gives each task the reference's policy, losses (1e-4),
host transfers and fleet report.  Within the port: the batched probe's
scores equal each task's own probe's on its unpadded rows; the reduction
is one call a tap group a shape group; the task-axis plain reduction is
bit-equal to T one-task ones (kernel 1's plain version and both
backbones'); the Fisher kernel's task-axis launch model owns every (task,
layer, column) once, no block spanning two tasks; on tiny-cnn every task
of a fleet gets its own ``adapt``'s policy; a static criterion raises
``ValueError``."""
import jax
import jax.numpy as jnp
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
from repro_torch.core.session import Task, _bucket_episode
from repro_torch.data import synthetic as syn
from repro_torch.kernels import fisher as fisher_kernel
from repro_torch.kernels import ops
from repro_torch.kernels.ref import fisher_tapgrads_ref

ITERS = 3
SEQ = 16
# (way, shots): support rows 8, 6 -> bucket 8; 16, 15 -> bucket 16
MIX = ((2, 4), (3, 2), (4, 4), (3, 5))


def units(policy):
    return [(u.layer, u.kind, tuple(int(c) for c in u.channels))
            for u in policy.units]


def tasks(mod, task_cls, vocab):
    out = []
    for i, (way, shots) in enumerate(MIX):
        rng = np.random.default_rng(30 + i)
        ep = mod.lm_episode(rng, vocab, SEQ, max_way=way, min_way=way,
                            shots=shots, query_per_class=2)
        out.append(task_cls.from_episode(ep, rng, 5, name=f"user{i}"))
    return out


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def ref():
    """The port's fleet run on its seeded weights and the JAX package's on
    the same weights, once per module."""
    cfg = configs.get_reduced("qwen2-1.5b")
    bb = lm_backbone(cfg, tokens_per_batch=16 * SEQ, batch_size=16)
    session = api.TinyTrainSession(bb, max_way=5, seed=0, device="cpu")
    calls = []
    real = ops.fisher_tapgrads

    def counted(g, n, mask=None):
        calls.append(tuple(g.shape))
        return real(g, n, mask)

    ops.fisher_tapgrads = counted
    try:
        syncs = telemetry.host_sync_count()
        res = session.adapt_many(tasks(syn, Task, cfg.vocab),
                                 api.JETSON_NANO, iters=ITERS)
        syncs = telemetry.host_sync_count() - syncs
    finally:
        ops.fisher_tapgrads = real
    jcfg = jconfigs.get_reduced("qwen2-1.5b")
    jbb = jlm_backbone(jcfg, tokens_per_batch=16 * SEQ, batch_size=16)
    js = japi.TinyTrainSession(
        jbb, jax.tree_util.tree_map(jnp.asarray,
                                    bridge.tree_to_numpy(session.params)),
        max_way=5)
    jres = js.adapt_many(tasks(jsyn, JTask, jcfg.vocab), japi.JETSON_NANO,
                         iters=ITERS)
    return dict(res=res, jres=jres, report=dict(session.last_fleet_report),
                jreport=dict(js.last_fleet_report), session=session,
                syncs=syncs, calls=calls)


@pytest.mark.parametrize("i", range(len(MIX)))
def test_policy_and_losses_match_reference(ref, i):
    got, want = ref["res"][i], ref["jres"][i]
    assert units(got.policy) == units(want.policy)
    assert got.policy.n_units >= 1
    assert got.method == want.method == "tinytrain"
    assert np.isfinite(got.losses).all() and len(got.losses) == ITERS
    np.testing.assert_allclose(got.losses, want.losses, rtol=1e-4, atol=1e-4)
    assert got.skipped_steps == want.skipped_steps
    assert got.host_transfers == pytest.approx(want.host_transfers)
    assert got.fisher_seconds > 0


def test_fleet_report_matches_reference(ref):
    got, want = ref["report"], ref["jreport"]
    for k in ("tasks", "bucketed", "buckets", "policy_structures", "groups",
              "hosts", "ingestion"):
        assert got[k] == want[k], k
    assert got["buckets"] == 2


def test_one_reduction_a_tap_group_a_shape_group(ref):
    """Two shape groups, two tap groups (attention heads, d_ff): four
    reductions over (T, L, B, C) stacks, not one a task; one fetch of the
    scores a shape group, one of the losses a fine-tune group."""
    cfg = ref["session"].backbone.cfg
    assert sorted(ref["calls"]) == sorted(
        (2, cfg.n_layers, rows, c) for rows in (8, 16)
        for c in (cfg.n_heads, cfg.d_ff))
    assert ref["syncs"] == ref["report"]["buckets"] + ref["report"]["groups"]


def test_batched_probe_equals_each_tasks_own(ref):
    """The batched probe over a bucket-padded stack against each task's
    own probe on its unpadded rows: padded rows change nothing."""
    session = ref["session"]
    ts = tasks(syn, Task, session.backbone.cfg.vocab)[:2]  # bucket 8
    eps = [_bucket_episode(t) for t in ts]
    sup = {k: torch.stack([torch.from_numpy(e[0][k]) for e in eps])
           for k in eps[0][0]}
    pq = {k: torch.stack([torch.from_numpy(e[1][k]) for e in eps])
          for k in eps[0][1]}
    ns = torch.tensor([float(t.n_support) for t in ts])
    bb = session.backbone
    got = session.step_cache.probe_fisher_batch()(
        session.params, sup, pq, bb.make_taps(8, "cpu"), ns)
    for j, t in enumerate(ts):
        s1 = {k: torch.from_numpy(v) for k, v in t.support.items()}
        q1 = {k: torch.from_numpy(v) for k, v in t.pseudo_query.items()}
        one = session.step_cache.probe_fisher()(
            session.params, s1, q1,
            bb.make_taps(len(t.support["episode_labels"]), "cpu"),
            float(t.n_support))
        assert set(one) == set(got)
        for k, want in one.items():
            torch.testing.assert_close(got[k][j], want, rtol=1e-5,
                                       atol=1e-6 * float(want.abs().max()))


def test_static_criterion_raises(ref):
    session = ref["session"]
    task = tasks(syn, Task, session.backbone.cfg.vocab)[0]
    for crit in ("random", "l2norm"):
        with pytest.raises(ValueError, match="static channel mode"):
            session.adapt_many([task], api.JETSON_NANO, criterion=crit)


@pytest.mark.parametrize("shape", ((3, 4, 48, 8960), (4, 5, 7, 77),
                                   (1, 28, 48, 12)))
def test_task_axis_plain_reduction_equals_one_task_ones(shape):
    gen = torch.Generator().manual_seed(shape[-1])
    g = torch.randn(shape, generator=gen)
    mask = (torch.rand(shape[0], shape[2], generator=gen) > 0.3).float()
    mask[:, 0] = 1.0
    n = mask.sum(1)
    got = fisher_tapgrads_ref(g, n, mask)
    assert torch.equal(got, ops.fisher_tapgrads(g, n, mask))  # the CPU route
    for t in range(shape[0]):
        assert torch.equal(got[t], fisher_tapgrads_ref(g[t], float(n[t]),
                                                       mask[t]))


def test_backbone_batch_reductions_equal_one_task_ones(ref):
    """Both backbones' ``fisher_reduce_batch`` against ``fisher_reduce``
    task by task, bit for bit."""
    gen = torch.Generator().manual_seed(0)
    cnn = api.backbone("tiny-cnn", in_res=16, batch_size=8)
    for bb in (ref["session"].backbone, cnn):
        taps = bb.make_taps(8, "cpu")
        tg = (torch.randn((3,) + t.shape, generator=gen) for t in taps) \
            if isinstance(taps, list) else None
        if tg is not None:
            tg = list(tg)
        else:
            tg = {gk: {k: torch.randn((3,) + v.shape, generator=gen)
                       for k, v in grp.items()} for gk, grp in taps.items()}
        mask = torch.tensor([[1.0] * 8, [1.0] * 5 + [0.0] * 3,
                             [1.0] * 2 + [0.0] * 6])
        ns = mask.sum(1)
        got = bb.fisher_reduce_batch(tg, ns, mask)
        for t in range(3):
            one_tg = ([x[t] for x in tg] if isinstance(tg, list) else
                      {gk: {k: v[t] for k, v in grp.items()}
                       for gk, grp in tg.items()})
            one = bb.fisher_reduce(one_tg, float(ns[t]), mask[t])
            assert set(one) == set(got)
            for k, v in one.items():
                assert torch.equal(got[k][t], v), (bb.kind, k, t)


@pytest.mark.parametrize("tasks_, layers, c, dtype", (
    (4, 28, 1120, torch.float32), (3, 2, 77, torch.float32),
    (2, 3, 24, torch.bfloat16), (1, 28, 12, torch.float32)))
def test_task_rows_plan_owns_every_column_once(tasks_, layers, c, dtype):
    plan = fisher_kernel.rows_plan(layers, 48, c, dtype, tasks=tasks_)
    one = fisher_kernel.rows_plan(layers, 48, c, dtype)
    assert plan["blocks"] == one["blocks"] and plan["tasks"] == tasks_
    owned = {}
    for t in range(tasks_):
        for b in range(plan["blocks"]):
            seen = set()
            for th in range(plan["threads"]):
                o = plan["owner"]((b, t), th)
                if o is None:
                    continue
                seen.add(o[0])
                for v in range(plan["vec"]):
                    key = (o[0], o[1], o[2] + v)
                    assert key not in owned
                    owned[key] = (b, t)
            assert seen <= {t}  # no block spans two tasks
    assert set(owned) == {(t, l, col) for t in range(tasks_)
                          for l in range(layers) for col in range(c)}
    with pytest.raises(IndexError):
        plan["owner"]((0, tasks_), 0)


def test_edge_cnn_fleet_gets_each_tasks_own_policy():
    """tiny-cnn: adapt_many without an override gives every user the
    policy its own ``adapt`` selects (bucketed mix of way and shot)."""
    bb = api.backbone("tiny-cnn", in_res=16, batch_size=16)
    session = api.TinyTrainSession(bb, max_way=4, seed=0, device="cpu")
    rng = np.random.default_rng(1)
    ts = [api.sample_task(rng, d, res=16, max_way=4, min_way=2 + i % 3,
                          support_pad=None, query_pad=None,
                          max_support_total=5 + 5 * (i % 2),
                          max_support_per_class=4, query_per_class=2)
          for i, d in enumerate(("stripes", "spots", "waves", "glyphs"))]
    fleet = session.adapt_many(ts, api.RPI_ZERO, iters=2)
    assert session.last_fleet_report["buckets"] == 2
    for t, f in zip(ts, fleet):
        one = session.adapt(t, api.RPI_ZERO, iters=2)
        assert units(f.policy) == units(one.policy)
        np.testing.assert_allclose(f.losses, one.losses, rtol=1e-5,
                                   atol=1e-6)
