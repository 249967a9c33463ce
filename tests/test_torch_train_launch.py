"""The port's training launcher on the CPU against the JAX package's: the lr
schedules, Adam with a schedule, weight decay and bf16 moments, the
token-batch steps (``make_sparse_train_step`` after
``plan_sparse_update``, ``make_full_train_step``) on qwen2-smoke with the
JAX weights bridged across, ``adapt_task``'s route without a step cache
(fused and eager) against the cached one, and ``launch.train.main`` in
both modes: resume, "no new steps", ``--production-mesh`` and the card
default."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as japi
from repro import configs as jconfigs
from repro.core.baselines import make_full_train_step as jmake_full_train_step
from repro.core.sparse import make_sparse_train_step as jmake_sparse_train_step
from repro.data import TokenLoader as JTokenLoader
from repro.models import transformer as JT
from repro.optim import adam as jadam
from repro.optim import constant as jconstant
from repro.optim import warmup_cosine as jwarmup_cosine
from repro_torch import api, bridge, configs
from repro_torch.core import adapt_task
from repro_torch.core.baselines import make_full_train_step
from repro_torch.core.sparse import make_sparse_train_step
from repro_torch.data import TokenLoader
from repro_torch.launch import train as launch_train
from repro_torch.models import transformer as T
from repro_torch.optim import adam, constant, warmup_cosine

BATCH, SEQ, STEPS, LR = 4, 16, 3, 1e-3  # the launcher's default lr
PROFILE = dict(name="cli", mem_kb=8e3, compute_frac=0.5)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The smoke model's ops are tiny: several CPU threads per op only
    contend under the parallel test run."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _step(i):
    return torch.tensor(i, dtype=torch.int32), jnp.asarray(i, jnp.int32)


@pytest.mark.parametrize("warmup,floor", [(10, 0.0), (0, 1e-5), (1, 2e-4)])
def test_schedules_match_jax(warmup, floor):
    """At step 0, the end of warmup, mid-way and the end (and after)."""
    total = 100
    got_f = warmup_cosine(3e-3, total, warmup_steps=warmup, floor=floor)
    want_f = jwarmup_cosine(3e-3, total, warmup_steps=warmup, floor=floor)
    for i in (0, warmup // 2, warmup, (warmup + total) // 2, total - 1,
              total, total + 7):
        t, j = _step(i)
        got = got_f(t)
        assert got.dtype == torch.float32 and got.shape == ()
        np.testing.assert_allclose(float(got), float(want_f(j)), rtol=1e-6)
    t, j = _step(5)
    assert float(constant(2.5e-4)(t)) == float(jconstant(2.5e-4)(j))


def test_schedule_stays_on_the_steps_device():
    t = torch.zeros((), dtype=torch.int32, device="meta")
    assert warmup_cosine(1e-3, 10, 2)(t).device.type == "meta"
    assert constant(1e-3)(t).device.type == "meta"


@pytest.mark.parametrize("weight_decay,state_dtype", [
    (0.0, None), (0.05, None), (0.05, "bfloat16")])
def test_adam_with_schedule_decay_and_state_dtype_matches_jax(
        weight_decay, state_dtype):
    """Three updates under ``warmup_cosine``: updates within float32
    rounding, the bf16 moments bit for bit (the twin of
    ``test_optim.py::test_bf16_state_dtype``)."""
    rng = np.random.default_rng(0)
    p = {"w": rng.normal(size=(6, 5)).astype(np.float32),
         "b": rng.normal(size=(5,)).astype(np.float32)}
    sched, jsched = (f(1e-2, 10, warmup_steps=2)
                     for f in (warmup_cosine, jwarmup_cosine))
    opt = adam(sched, weight_decay=weight_decay,
               state_dtype=getattr(torch, state_dtype) if state_dtype
               else None)
    jopt = jadam(jsched, weight_decay=weight_decay,
                 state_dtype=getattr(jnp, state_dtype) if state_dtype
                 else None)
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    st, jst = opt.init(tp), jopt.init(jp)
    want_dtype = torch.bfloat16 if state_dtype else torch.float32
    assert st["m"]["w"].dtype == st["v"]["b"].dtype == want_dtype
    for _ in range(3):
        g = {k: rng.normal(size=v.shape).astype(np.float32)
             for k, v in p.items()}
        upd, st = opt.update({k: torch.from_numpy(v) for k, v in g.items()},
                             st, tp)
        jupd, jst = jopt.update({k: jnp.asarray(v) for k, v in g.items()},
                                jst, jp)
        for k in p:
            np.testing.assert_allclose(upd[k].numpy(), np.asarray(jupd[k]),
                                       rtol=1e-6, atol=1e-9)
            for slot in ("m", "v"):
                got = bridge.tree_to_numpy(st[slot][k])
                np.testing.assert_array_equal(
                    got, np.asarray(jst[slot][k], np.float32))
    assert int(st["step"]) == int(jst["step"]) == 3


@pytest.fixture(scope="module")
def ref():
    """The JAX launcher's pieces on qwen2-smoke: weights, the probe's
    policy, the sparse step's and the full step's losses and results over
    the loader's next batches; and the port's backbone and bridged
    weights."""
    jcfg = jconfigs.preset_config("qwen2-1.5b", "smoke")
    jparams = JT.init_params(jcfg, jax.random.PRNGKey(0))
    jbb = japi.backbone("qwen2-1.5b", preset="smoke", batch_size=BATCH,
                        seq=SEQ)
    loader = JTokenLoader(jcfg.vocab, global_batch=BATCH, seq=SEQ, seed=0)
    probe = {k: jnp.asarray(v) for k, v in loader.next().items()}
    profile = japi.DeviceProfile(**PROFILE)
    policy, _ = japi.plan_sparse_update(jbb, jparams, probe, profile,
                                        n_samples=BATCH)
    opt = jadam(jwarmup_cosine(LR, STEPS, warmup_steps=1))
    step = jmake_sparse_train_step(jbb.loss, policy, opt, donate=False)
    deltas = jbb.init_deltas(policy)
    ost = opt.init(deltas)
    sparse_losses = []
    for _ in range(STEPS):
        b = {k: jnp.asarray(v) for k, v in loader.next().items()}
        deltas, ost, loss = step(jparams, deltas, ost, b)
        sparse_losses.append(float(loss))
    host = jax.tree_util.tree_map(np.asarray, jparams)  # the full step donates
    full = jmake_full_train_step(lambda p, b: JT.lm_loss(jcfg, p, b), opt)
    p, ost = jparams, opt.init(jparams)
    full_losses = []
    for _ in range(STEPS):
        b = {k: jnp.asarray(v) for k, v in loader.next().items()}
        p, ost, loss = full(p, ost, b)
        full_losses.append(float(loss))
    tree = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    out = dict(policy=policy, sparse_losses=sparse_losses,
               deltas=tree(deltas), full_losses=full_losses,
               params=tree(p), full_m=tree(ost["m"]))

    cfg = configs.preset_config("qwen2-1.5b", "smoke")
    bb = api.backbone("qwen2-1.5b", preset="smoke", batch_size=BATCH,
                      seq=SEQ)
    params = bridge.params_from_numpy(cfg, host, device="cpu")
    return out, cfg, bb, params


def _units(policy):
    return [(u.layer, u.kind, tuple(np.asarray(u.channels).tolist()))
            for u in policy.units]


def _close(port_tree, jax_tree, **tol):
    got = bridge.tree_to_numpy(port_tree)
    want_leaves = jax.tree_util.tree_leaves(jax_tree)
    got_leaves = jax.tree_util.tree_leaves(got)
    assert jax.tree_util.tree_structure(got) == \
        jax.tree_util.tree_structure(jax_tree)
    for g, w in zip(got_leaves, want_leaves):
        np.testing.assert_allclose(g, np.asarray(w, np.float32), **tol)


def test_sparse_step_after_the_probe_matches_jax(ref):
    """plan_sparse_update's policy, then the sparse step's losses and
    deltas over three batches."""
    out, cfg, bb, params = ref
    dev = torch.device("cpu")
    loader = TokenLoader(cfg.vocab, global_batch=BATCH, seq=SEQ, seed=0)
    probe = launch_train.on_device(loader.next(), dev)
    policy, _ = api.plan_sparse_update(bb, params, probe,
                                       api.DeviceProfile(**PROFILE),
                                       n_samples=BATCH)
    assert _units(policy) == _units(out["policy"])
    assert policy.n_units > 0
    opt = adam(warmup_cosine(LR, STEPS, warmup_steps=1))
    step = make_sparse_train_step(bb.loss, policy, opt, donate=False)
    deltas = bb.init_deltas(policy, dev)
    ost = opt.init(deltas)
    losses = []
    for _ in range(STEPS):
        deltas, ost, loss = step(params, deltas, ost,
                                 launch_train.on_device(loader.next(), dev))
        losses.append(float(loss))
    np.testing.assert_allclose(losses, out["sparse_losses"], rtol=1e-5)
    # test_torch_adapt.py's tolerance for deltas at this lr
    _close(deltas, out["deltas"], rtol=2e-3, atol=2e-4)


def test_sparse_step_skips_a_non_finite_step(ref):
    """A NaN loss leaves deltas and Adam state as they were and reports
    NaN, as the JAX step's in-graph guard does."""
    _, cfg, bb, params = ref
    policy, _ = api.plan_sparse_update(
        bb, params, launch_train.on_device(
            TokenLoader(cfg.vocab, BATCH, SEQ).next(), torch.device("cpu")),
        api.DeviceProfile(**PROFILE), n_samples=BATCH)
    opt = adam(1e-3)
    step = make_sparse_train_step(
        lambda p, b, **kw: bb.loss(p, b, **kw) * float("nan"), policy, opt)
    deltas = bb.init_deltas(policy, "cpu")
    ost = opt.init(deltas)
    batch = launch_train.on_device(TokenLoader(cfg.vocab, BATCH, SEQ).next(),
                                   torch.device("cpu"))
    d2, ost2, loss = step(params, deltas, ost, batch)
    assert torch.isnan(loss)
    for a, b in zip(*(jax.tree_util.tree_leaves(t) for t in
                      ((deltas, ost), (d2, ost2)))):
        assert torch.equal(a, b)


def test_full_step_matches_jax(ref):
    """make_full_train_step's losses over three batches; params and Adam's
    first moments after them (Adam's first steps are lr · sign(g) for
    gradients at float32 noise, so the params are held to a few steps of
    lr where such elements part; ROADMAP §3)."""
    out, cfg, _, params = ref
    dev = torch.device("cpu")
    loader = TokenLoader(cfg.vocab, global_batch=BATCH, seq=SEQ, seed=0)
    loader.next()
    for _ in range(STEPS):  # the sparse run's batches
        loader.next()
    opt = adam(warmup_cosine(LR, STEPS, warmup_steps=1))
    step = make_full_train_step(lambda p, b: T.lm_loss(cfg, p, b), opt)
    p, ost = params, opt.init(params)
    losses = []
    for _ in range(STEPS):
        p, ost, loss = step(p, ost, launch_train.on_device(loader.next(),
                                                           dev))
        losses.append(float(loss))
    np.testing.assert_allclose(losses, out["full_losses"], rtol=1e-5)
    _close(p, out["params"], rtol=0, atol=STEPS * LR)
    _close(ost["m"], out["full_m"], rtol=1e-3, atol=1e-6)


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "eager"])
def test_adapt_task_without_step_cache_equals_cached_route(ref, fused):
    """``adapt_task(step_cache=None)`` builds its steps for the task
    (``make_episode_sparse_scan`` / ``make_episode_sparse_step``) and
    reduces the probe on the host: the same policy, losses and deltas as
    the cached route, two host transfers when fused."""
    from repro_torch.core import adapt as telemetry

    _, cfg, bb, params = ref
    session = api.TinyTrainSession(
        api.backbone("qwen2-1.5b", preset="smoke", batch_size=32, seq=16),
        params, max_way=5)
    task = api.sample_lm_task(np.random.default_rng(0), cfg.vocab, seq=16,
                              max_way=5, support_pad=32, query_pad=32)
    sup = launch_train.on_device(task.support, torch.device("cpu"))
    pq = launch_train.on_device(task.pseudo_query, torch.device("cpu"))
    budget = api.JETSON_NANO.budget()
    runs = {}
    for name, cache in (("cached", session.step_cache), ("uncached", None)):
        telemetry.reset_host_sync_count()
        # the cache steps with its own optimiser: the session's
        runs[name] = adapt_task(session.backbone, params, sup, pq, budget,
                                session.optimizer, iters=3, max_way=5,
                                step_cache=cache, fused=fused,
                                n_support=task.n_support)
        runs[name].syncs = telemetry.host_sync_count()
    a, b = runs["cached"], runs["uncached"]
    assert _units(a.policy) == _units(b.policy) and a.policy.n_units > 0
    assert a.losses == b.losses
    for x, y in zip(jax.tree_util.tree_leaves(a.deltas),
                    jax.tree_util.tree_leaves(b.deltas)):
        assert torch.equal(x, y)
    assert a.host_transfers == b.host_transfers == a.syncs == b.syncs
    assert b.host_transfers == (2 if fused else 1 + 3)


ARGV = ["--device", "cpu", "--steps", "4", "--batch", "2", "--seq", "16",
        "--ckpt-every", "2", "--mem-budget-mb", "8"]


@pytest.mark.parametrize("mode", ["tinytrain", "full"])
def test_launcher_trains_resumes_and_stops(tmp_path, capsys, mode):
    """``main`` trains, checkpoints, resumes from its own checkpoint to a
    larger ``--steps``, and runs no step when the checkpoint covers
    ``--steps``."""
    argv = ARGV + ["--mode", mode, "--ckpt-dir", str(tmp_path)]
    launch_train.main(argv)
    first = capsys.readouterr().out
    assert "[train] done: 4 steps" in first and "final loss" in first
    if mode == "tinytrain":
        assert "[train] policy: horizon=" in first
    launch_train.main([*argv[:3], "6", *argv[4:]])
    resumed = capsys.readouterr().out
    assert "[trainer] restored step 4" in resumed
    assert "[train] done: 6 steps" in resumed and "final loss" in resumed
    launch_train.main([*argv[:3], "6", *argv[4:]])
    again = capsys.readouterr().out
    assert "[trainer] restored step 6" in again
    assert "no new steps (checkpoint already at --steps)" in again


def test_launcher_refuses_the_production_mesh_and_a_missing_card(
        tmp_path, monkeypatch, capsys):
    """``--production-mesh``, refused until the planning tools were ported,
    now lays the pod's 16 x 16 mesh over the chosen device, prints it as the
    JAX launcher prints ``dict(mesh.shape)`` and trains as on the debug
    mesh; the card default still refuses a machine without a card."""
    launch_train.main(ARGV + ["--production-mesh", "--ckpt-dir",
                              str(tmp_path / "pod")])
    out = capsys.readouterr().out
    assert "mesh={'data': 16, 'model': 16}" in out
    assert "[train] done: 4 steps" in out and "final loss" in out
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        launch_train.main(["--steps", "1", "--ckpt-dir", str(tmp_path)])
