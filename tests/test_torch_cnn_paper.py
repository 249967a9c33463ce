"""The paper's three edge CNNs (mcunet, mobilenetv2, proxylessnas) through
the port's façade on the CPU, against the JAX package on the same weights
(bridged) and the same episode: each adapts a ``sample_task`` episode
under ``STM32F746.scaled(mem=1.6)`` with the reference's policy (at least
one unit), Fisher scores within 1e-5, losses within 1e-5 a step, deltas
within 1e-4 and equal accuracy, and its folded copy gives the delta
forward's features.  Full depth and width at in_res 16 (the card runs
in_res 84, ``chip_smoke.py`` phase 14)."""
import jax
import numpy as np
import pytest
import torch

from repro import api as japi
from repro_torch import api, bridge

RES, BATCH, ITERS = 16, 16, 2
TASK = dict(res=RES, max_way=4, min_way=3, support_pad=16, query_pad=16,
            max_support_total=16, max_support_per_class=4, query_per_class=4)


def units(policy):
    return [(u.layer, u.kind, tuple(int(c) for c in u.channels))
            for u in policy.units]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module", params=["mcunet", "mobilenetv2",
                                        "proxylessnas"])
def run(request):
    """One backbone's JAX adapt (probe scores, adapt, accuracy) and the
    port's on the bridged weights."""
    name = request.param
    jbb = japi.backbone(name, in_res=RES, batch_size=BATCH)
    js = japi.TinyTrainSession(jbb, max_way=4, seed=0)
    jtask = japi.sample_task(np.random.default_rng(0), "blobs", **TASK)
    jad = js.adapt(jtask, japi.STM32F746.scaled(mem=1.6), iters=ITERS)
    # the adapt's own compiled probe, so no second compile
    chans = js.step_cache.probe_fisher()(
        js.params, jtask.support, jtask.pseudo_query,
        jbb.make_taps(len(jtask.support["episode_labels"])),
        np.float32(jtask.n_support))
    ref = dict(adapt=jad, accuracy=jad.accuracy(),
               chans=jax.tree_util.tree_map(np.asarray, chans),
               deltas=jax.tree_util.tree_map(np.asarray, jad.deltas))
    bb = api.backbone(name, in_res=RES, batch_size=BATCH)
    params = bridge.params_from_numpy(
        bb.cfg, jax.tree_util.tree_map(np.asarray, js.params), device="cpu")
    session = api.TinyTrainSession(bb, params, max_way=4, device="cpu")
    task = api.sample_task(np.random.default_rng(0), "blobs", **TASK)
    ad = session.adapt(task, api.STM32F746.scaled(mem=1.6), iters=ITERS)
    return name, ref, session, task, ad


def test_policy_matches_and_selects_a_unit(run):
    name, ref, session, _, got = run
    want = ref["adapt"].policy
    assert units(got.policy) == units(want)
    assert got.policy.horizon == want.horizon
    assert got.policy.n_units >= 1, name
    assert got.memory_report() == ref["adapt"].memory_report()
    assert got.host_transfers == 2


def test_fisher_scores_match(run):
    _, ref, session, task, _ = run
    on = (lambda tree: {k: torch.from_numpy(v) for k, v in tree.items()})
    chans = session.step_cache.probe_fisher()(
        session.params, on(task.support), on(task.pseudo_query),
        session.backbone.make_taps(len(task.support["episode_labels"]),
                                   "cpu"), float(task.n_support))
    assert set(chans) == set(ref["chans"])
    for key, want in ref["chans"].items():
        np.testing.assert_allclose(chans[key].numpy(), want, rtol=0,
                                   atol=1e-5 * float(np.abs(want).max()))


def test_losses_deltas_and_accuracy_match(run):
    _, ref, _, _, got = run
    np.testing.assert_allclose(got.losses, ref["adapt"].losses, rtol=1e-5,
                               atol=1e-5)
    got_d = bridge.cnn_tree_to_numpy(got.deltas)
    assert set(got_d) == set(ref["deltas"])
    for k, want in ref["deltas"].items():
        np.testing.assert_allclose(got_d[k]["conv"]["w"], want["conv"]["w"],
                                   rtol=1e-4, atol=1e-4)
    assert got.accuracy() == pytest.approx(ref["accuracy"], abs=1e-6)


def test_fold_gives_the_delta_forward(run):
    _, _, session, task, got = run
    bb = session.backbone
    imgs = {"images": torch.from_numpy(task.query["images"])}
    with torch.no_grad():
        want = bb.features(session.params, imgs, deltas=got.deltas,
                           plan=got.policy)
        plain = bb.features(got.fold_into(session.params), imgs)
    assert plain.shape == (len(task.query["images"]), bb.cfg.feat_dim)
    np.testing.assert_allclose(plain.numpy(), want.numpy(), rtol=0,
                               atol=1e-5 * want.abs().max().item())
