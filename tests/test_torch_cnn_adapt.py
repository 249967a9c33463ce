"""The port's TinyTrain on the edge CNN (``examples/quickstart.py``'s
tiny-cnn at in_res 32, a 'glyphs' task under ``RPI_ZERO``) on the CPU
against the JAX package's, with the JAX weights bridged across and the
same episode from the same seed: the task, per-channel Fisher scores
(1e-5), the selected policy, losses (1e-5 a step), deltas (1e-4),
accuracy, the memory report and the fold.  Within the port, bit for bit:
eager == fused, ``adapt_many`` == per-task ``adapt`` (bucketed and exact,
over a heterogeneous mix of way and shot), padded support rows change
nothing; and a fused adapt makes two blocking host transfers."""
import jax
import numpy as np
import pytest
import torch

from repro import api as japi
from repro_torch import api, bridge
from repro_torch.core import adapt as telemetry
from repro_torch.core.fisher import fisher_probe
from repro_torch.core.protonet import episode_loss
from repro_torch.core.session import Task, _pad_episode_rows
from repro_torch.models.edge_cnn import cnn_fold_deltas

ITERS = 4
RES = 32
TASK = dict(res=RES, max_way=8, support_pad=64, query_pad=96)
DOMAINS = ("stripes", "spots", "waves", "stripes")


def units(policy):
    return [(u.layer, u.kind, tuple(int(c) for c in u.channels))
            for u in policy.units]


def same_deltas(a, b):
    return all(torch.equal(x["conv"]["w"], y["conv"]["w"])
               for x, y in zip(a.deltas.values(), b.deltas.values()))


def mixed_tasks():
    """Eight users, each with their own way and shot (support rows 5 to
    16: two buckets of padded rows)."""
    rng = np.random.default_rng(1)
    return [api.sample_task(rng, d, res=RES, max_way=8, min_way=2 + i % 4,
                            support_pad=None, query_pad=None,
                            max_support_total=6 + 7 * (i % 3),
                            max_support_per_class=8, query_per_class=4)
            for i, d in enumerate(DOMAINS * 2)]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def ref():
    """The JAX package's runs, once per module (probe scores, one fused
    adapt, its fold), and the port's session on the bridged weights with
    its own adapt of the same task."""
    jbb = japi.backbone("tiny-cnn", in_res=RES, batch_size=64)
    js = japi.TinyTrainSession(jbb, max_way=8, seed=0)
    jtask = japi.sample_task(np.random.default_rng(0), "glyphs", **TASK)
    out = {"task": jtask, "zero_shot": js.evaluate(jtask)}
    out["chans"] = jax.tree_util.tree_map(
        np.asarray, js.step_cache.probe_fisher()(
            js.params, jtask.support, jtask.pseudo_query,
            jbb.make_taps(len(jtask.support["episode_labels"])),
            np.float32(jtask.n_support)))
    out["adapt"] = js.adapt(jtask, japi.RPI_ZERO, iters=ITERS)
    out["folded"] = jax.tree_util.tree_map(
        np.asarray, out["adapt"].fold_into(js.params))

    bb = api.backbone("tiny-cnn", in_res=RES, batch_size=64)
    params = bridge.params_from_numpy(
        bb.cfg, jax.tree_util.tree_map(np.asarray, js.params), device="cpu")
    session = api.TinyTrainSession(bb, params, max_way=8)
    task = api.sample_task(np.random.default_rng(0), "glyphs", **TASK)
    syncs = telemetry.host_sync_count()
    adaptation = session.adapt(task, api.RPI_ZERO, iters=ITERS)
    syncs = telemetry.host_sync_count() - syncs
    return out, session, task, adaptation, syncs


def test_task_matches_reference(ref):
    out, _, task, _, _ = ref
    jtask = out["task"]
    assert task.name == jtask.name == "glyphs"
    for name in ("support", "query", "pseudo_query"):
        want = getattr(jtask, name)
        assert set(getattr(task, name)) == set(want)
        for k, w in want.items():
            np.testing.assert_array_equal(getattr(task, name)[k],
                                          np.asarray(w))
    assert task.n_support == jtask.n_support


def test_probe_scores_match(ref):
    """The device-side probe (tap gradients of the episode loss, masked Eq.
    2) per layer within 1e-5 of max |want|, and the host-side
    ``fisher_probe`` gives the same scores."""
    out, session, task, _, _ = ref
    sup = {k: torch.from_numpy(v) for k, v in task.support.items()}
    pq = {k: torch.from_numpy(v) for k, v in task.pseudo_query.items()}
    bb = session.backbone
    chans = session.step_cache.probe_fisher()(
        session.params, sup, pq,
        bb.make_taps(len(task.support["episode_labels"]), "cpu"),
        float(task.n_support))
    assert set(chans) == set(out["chans"])
    assert len(chans) == bb.cfg.n_layers
    for key, want in out["chans"].items():
        np.testing.assert_allclose(chans[key].numpy(), want, rtol=0,
                                   atol=1e-5 * float(np.abs(want).max()))
    # the host path, on the unpadded rows (its taps are sized to the batch)
    n = task.n_support
    _, host, secs = fisher_probe(
        bb, session.params,
        lambda p, b, taps=None: episode_loss(
            bb.features, p, b, {k: v[:n] for k, v in pq.items()}, 8,
            taps=taps),
        {k: v[:n] for k, v in sup.items()}, n)
    assert secs > 0
    for key, want in out["chans"].items():
        np.testing.assert_allclose(host[key], want, rtol=0,
                                   atol=1e-5 * float(np.abs(want).max()))


def test_policy_losses_deltas_and_accuracy_match(ref):
    out, session, task, got, _ = ref
    want = out["adapt"]
    assert units(got.policy) == units(want.policy)
    assert got.policy.horizon == want.policy.horizon
    assert got.policy.n_units >= 1
    np.testing.assert_allclose(got.losses, want.losses, rtol=1e-5, atol=1e-5)
    assert got.losses[-1] < got.losses[0]
    want_d = jax.tree_util.tree_map(np.asarray, want.deltas)
    got_d = bridge.cnn_tree_to_numpy(got.deltas)
    assert set(got_d) == set(want_d)
    for k in want_d:
        np.testing.assert_allclose(got_d[k]["conv"]["w"],
                                   want_d[k]["conv"]["w"], rtol=1e-4,
                                   atol=1e-4)
    assert got.accuracy() == pytest.approx(want.accuracy(), abs=1e-6)
    assert session.evaluate(task) == pytest.approx(out["zero_shot"], abs=1e-6)
    assert got.memory_report() == want.memory_report()
    assert got.delta_param_count() == want.delta_param_count()
    assert got.skipped_steps == 0


def test_fused_adapt_makes_two_host_transfers(ref):
    _, session, task, got, syncs = ref
    assert got.host_transfers == 2 and syncs == 2
    before = telemetry.host_sync_count()
    session.adapt(task, api.RPI_ZERO, iters=2)
    assert telemetry.host_sync_count() - before == 2


def test_eager_equals_fused(ref):
    _, session, task, fused, _ = ref
    eager = session.adapt(task, api.RPI_ZERO, iters=ITERS, fused=False)
    assert units(eager.policy) == units(fused.policy)
    assert eager.losses == fused.losses
    assert same_deltas(eager, fused)
    assert eager.host_transfers == 1 + ITERS


def test_padded_support_rows_change_nothing(ref):
    """The same task with its support and pseudo-query sets padded from 96
    to 128 rows (label -1): the same policy, losses and deltas, bit for
    bit."""
    _, session, task, got, _ = ref
    padded = Task(name=task.name,
                  support=_pad_episode_rows(task.support, 128),
                  query=task.query,
                  pseudo_query=_pad_episode_rows(task.pseudo_query, 128),
                  max_way=task.max_way)
    again = session.adapt(padded, api.RPI_ZERO, iters=ITERS)
    assert units(again.policy) == units(got.policy)
    assert again.losses == got.losses
    assert same_deltas(again, got)


@pytest.mark.parametrize("bucket", [True, False])
def test_adapt_many_equals_adapt(ref, bucket):
    """A heterogeneous fleet under one policy, in one program a (bucket,
    policy structure) group: each task's losses and deltas are what
    ``adapt`` gives it alone, bit for bit."""
    _, session, _, got, _ = ref
    tasks = mixed_tasks()
    many = session.adapt_many(tasks, api.RPI_ZERO, iters=ITERS,
                              policy_override=got.policy, bucket=bucket)
    rep = session.last_fleet_report
    rows = {t.support["episode_labels"].shape[0] for t in tasks}
    assert rep["groups"] == (2 if bucket else len(rows))
    assert sum(a.host_transfers for a in many) == pytest.approx(
        rep["groups"])
    for t, a in zip(tasks, many):
        one = session.adapt(t, api.RPI_ZERO, iters=ITERS,
                            policy_override=got.policy)
        assert a.losses == one.losses
        assert same_deltas(a, one)
        assert a.accuracy() == one.accuracy()


def test_fold_matches_reference_and_the_delta_forward(ref):
    """The folded copy's plain features equal the delta forward (1e-5);
    the port's fold of the reference's deltas is the reference's fold,
    exactly; the port's own fold within the deltas' 1e-4."""
    out, session, task, got, _ = ref
    bb = session.backbone
    folded = got.fold_into(session.params)
    assert folded is not session.params
    imgs = {"images": torch.from_numpy(task.query["images"])}
    with torch.no_grad():
        delta_fwd = bb.features(session.params, imgs, deltas=got.deltas,
                                plan=got.policy)
        plain = bb.features(folded, imgs)
    np.testing.assert_allclose(plain.numpy(), delta_fwd.numpy(), rtol=0,
                               atol=1e-5 * delta_fwd.abs().max().item())
    jad = out["adapt"]
    ref_deltas = bridge.cnn_tree_from_numpy(
        jax.tree_util.tree_map(np.asarray, jad.deltas), device="cpu")
    exact = cnn_fold_deltas(bb.cfg, session.params, ref_deltas, jad.policy)
    for a, b in zip(jax.tree_util.tree_leaves(bridge.cnn_tree_to_numpy(
            exact)), jax.tree_util.tree_leaves(out["folded"])):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(jax.tree_util.tree_leaves(bridge.cnn_tree_to_numpy(
            folded)), jax.tree_util.tree_leaves(out["folded"])):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-4)


def test_describe_and_later_features(ref):
    _, session, task, got, _ = ref
    text = got.describe()
    assert "host_transfers=2" in text and ".conv[" in text
    for call in (lambda: session.adapt_many([task], api.RPI_ZERO),
                 lambda: session.baseline("tinytl", task, "rpi-zero"),
                 lambda: session.adapt(task, "rpi-zero", criterion="l2norm")):
        with pytest.raises(NotImplementedError, match="item 8"):
            call()
