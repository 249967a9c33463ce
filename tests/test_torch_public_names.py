"""The smaller public names the port shares with the JAX package, on the
CPU against their JAX twins: the tree helpers of ``utils``,
``optim.momentum(state_dtype=)``, ``FleetShardingRules.replicated`` and
``.tasks``, ``layers.dot_attention(q_offset=)`` (a scalar and a per-slot
vector) and the zero delta packs of ``mlp_delta_init`` /
``attn_delta_init``, ``AdaptResult.steps_per_sec``,
``EpisodeStepCache.probe_grad`` (the tap gradients of autograd's probe,
built once), ``TinyTrainSession.compiled_steps`` (two adapts of one
policy structure share one step), ``FaultConfig.any_serving``,
``launch.train.preset_config`` and the packages' re-exports."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro import utils as ju
from repro.dist.sharding import FleetShardingRules as JRules
from repro.models import layers as JL
from repro.optim import momentum as jmomentum
from repro.serving.faults import FaultConfig as JFaultConfig
from repro_torch import api, configs, utils
from repro_torch.core.adapt import AdaptResult
from repro_torch.core.fisher import leaf_taps, tap_grads
from repro_torch.core.policy import SparseUpdatePolicy
from repro_torch.core.protonet import episode_loss
from repro_torch.dist.sharding import FleetShardingRules
from repro_torch.models import layers as L
from repro_torch.optim import momentum
from repro_torch.serving.faults import FaultConfig

TOL = dict(rtol=1e-6, atol=1e-6)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tree(seed=0):
    rng = np.random.default_rng(seed)
    return {"a": rng.standard_normal((3, 4)).astype(np.float32),
            "b": {"c": rng.standard_normal((5,)).astype(np.float32),
                  "d": [rng.standard_normal((2, 2)).astype(np.float32)]}}


def as_torch(t):
    return utils.tree_map(torch.from_numpy, t)


def as_jax(t):
    return jax.tree_util.tree_map(jnp.asarray, t)


def same(got, want, **tol):
    for g, w in zip(utils.tree_leaves(got), jax.tree_util.tree_leaves(want)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **tol)


def test_tree_helpers_match_the_jax_package():
    a, b = tree(0), tree(1)
    ta, tb, ja, jb = as_torch(a), as_torch(b), as_jax(a), as_jax(b)
    assert utils.tree_size(ta) == ju.tree_size(ja) == 12 + 5 + 4
    assert utils.tree_bytes(ta) == ju.tree_bytes(ja)
    assert utils.tree_bytes(utils.tree_cast(ta, torch.bfloat16)) == \
        ju.tree_bytes(ju.tree_cast(ja, jnp.bfloat16))
    same(utils.tree_add(ta, tb), ju.tree_add(ja, jb))
    same(utils.tree_scale(ta, 0.5), ju.tree_scale(ja, 0.5))
    z = utils.tree_zeros_like(ta, torch.float64)
    assert all(x.dtype == torch.float64 and not x.any()
               for x in utils.tree_leaves(z))
    np.testing.assert_allclose(float(utils.global_norm(ta)),
                               float(ju.global_norm(ja)), rtol=1e-6)
    assert bool(utils.tree_finite(ta)) and bool(ju.tree_finite(ja))
    ta["b"]["c"][2] = float("nan")
    ja = as_jax(utils.tree_map(lambda t: t.numpy(), ta))
    assert not bool(utils.tree_finite(ta)) and not bool(ju.tree_finite(ja))
    assert bool(utils.tree_finite({})) and bool(ju.tree_finite({}))
    for x, m in ((0, 8), (7, 8), (8, 8), (9, 4)):
        assert utils.round_up(x, m) == ju.round_up(x, m)
        assert utils.cdiv(x, m) == ju.cdiv(x, m)


def test_momentum_state_dtype_matches_the_jax_package():
    p, g = tree(0), tree(1)
    for sd, jsd in ((None, None), (torch.bfloat16, jnp.bfloat16)):
        opt, jopt = momentum(0.1, 0.9, state_dtype=sd), jmomentum(
            0.1, 0.9, state_dtype=jsd)
        st, jst = opt.init(as_torch(p)), jopt.init(as_jax(p))
        for _ in range(3):
            u, st = opt.update(as_torch(g), st, as_torch(p))
            ju_, jst = jopt.update(as_jax(g), jst, as_jax(p))
        assert all(m.dtype == (sd or torch.float32)
                   for m in utils.tree_leaves(st["mu"]))
        same(u, ju_, **TOL)
        same(utils.tree_map(lambda m: m.float(), st["mu"]),
             jax.tree_util.tree_map(lambda m: m.astype(jnp.float32),
                                    jst["mu"]), **TOL)


class FakeMesh:
    def __init__(self, **shape):
        self.axis_names = tuple(shape)
        self.shape = dict(shape)


@pytest.mark.parametrize("shape", [dict(data=4, model=2), dict(model=4),
                                   dict(pod=2, data=2, model=2)])
def test_fleet_rules_specs(shape):
    rules, jrules = FleetShardingRules(FakeMesh(**shape)), JRules(
        FakeMesh(**shape))
    leaves = {"ep": np.zeros((8, 3, 2)), "idx": np.zeros((6,)),
              "n": np.float32(1.0), "t": torch.zeros((4, 5))}
    specs = rules.tasks(leaves)
    for k, v in leaves.items():
        nd = np.ndim(v)
        assert specs[k] == jrules.task_spec(nd, np.shape(v)[0] if nd else 0)
    assert rules.replicated(leaves) == {k: () for k in leaves}


@pytest.mark.parametrize("q_offset", ["scalar", "vector"])
@pytest.mark.parametrize("window", [0, 3])
def test_dot_attention_q_offset_matches_the_jax_package(q_offset, window):
    rng = np.random.default_rng(4)
    q = rng.standard_normal((3, 4, 4, 8)).astype(np.float32)
    k = rng.standard_normal((3, 9, 2, 8)).astype(np.float32)
    v = rng.standard_normal((3, 9, 2, 8)).astype(np.float32)
    off = 5 if q_offset == "scalar" else np.array([0, 3, 5], np.int32)
    # every query sees a key (a row with none averages v's rows, which the
    # port zeroes past kv_len and the JAX package does not)
    kv_len = np.array([7, 8, 9], np.int32)
    want = JL.dot_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            causal=True, window=window,
                            q_offset=off if np.isscalar(off)
                            else jnp.asarray(off),
                            kv_len=jnp.asarray(kv_len))
    got = L.dot_attention(torch.from_numpy(q), torch.from_numpy(k),
                          torch.from_numpy(v), causal=True, window=window,
                          q_offset=off if np.isscalar(off)
                          else torch.from_numpy(off),
                          kv_len=torch.from_numpy(kv_len))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_delta_inits_match_the_jax_package():
    cfg = configs.get_reduced("qwen2-1.5b")
    jcfg = jconfigs.get_reduced("qwen2-1.5b")
    for act in ("swiglu", "gelu"):
        got = L.mlp_delta_init(cfg.d_model, 3, act, torch.bfloat16)
        want = JL.mlp_delta_init(jcfg.d_model, 3, act, jnp.bfloat16)
        assert {n: (tuple(t.shape), t.dtype) for n, t in got.items()} == {
            n: (t.shape, torch.bfloat16) for n, t in want.items()}
    got = L.attn_delta_init(cfg, 2)
    want = JL.attn_delta_init(jcfg, 2)
    assert {n: tuple(t.shape) for n, t in got.items()} == {
        n: t.shape for n, t in want.items()}
    assert not any(t.any() for t in got.values())


def test_adapt_result_steps_per_sec():
    pol = SparseUpdatePolicy(horizon=0, units=())
    assert AdaptResult({}, pol, 0.0, 2.0, [1.0] * 8).steps_per_sec == 4.0
    assert AdaptResult({}, pol, 0.0, 0.0, [1.0]).steps_per_sec == 0.0
    assert AdaptResult({}, pol, 0.0, 1.0, None).steps_per_sec == 0.0


@pytest.fixture(scope="module")
def session():
    bb = api.backbone("tiny-cnn", in_res=32, batch_size=64)
    return api.TinyTrainSession(bb, max_way=8, seed=0, device="cpu")


@pytest.fixture(scope="module")
def task():
    return api.sample_task(np.random.default_rng(0), "glyphs", res=32,
                           max_way=8, support_pad=64, query_pad=96)


def test_probe_grad_is_the_autograd_probe_built_once(session, task):
    cache = session.step_cache
    sup = session._on(task.support)
    pq = session._on(task.pseudo_query)
    taps = session.backbone.make_taps(len(task.support["episode_labels"]),
                                      "cpu")
    g = cache.probe_grad()
    assert cache.probe_grad() is g
    got = g(session.params, sup, pq, taps)
    leaves = leaf_taps(taps)
    loss = episode_loss(session.backbone.features, session.params, sup, pq,
                        cache.max_way, taps=leaves)
    want = tap_grads(loss, leaves)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.shape == b.shape
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-7)
        assert b.abs().max() > 0


def test_compiled_steps_shared_by_one_structure(session, task):
    a1 = session.adapt(task, api.RPI_ZERO, iters=2)
    n = session.compiled_steps()
    a2 = session.adapt(task, api.RPI_ZERO, iters=2)
    assert session.compiled_steps() == n == 1
    key = session.step_cache._key
    assert key(a1.policy) == key(a2.policy) and a1.policy.n_units > 0
    session.adapt(task, api.RPI_ZERO, iters=2, fused=False)
    assert session.compiled_steps() == 2  # the eager step of it


@pytest.mark.parametrize("kw", [{}, dict(nan_logits=((0, 1),)),
                                dict(force_preempt=((1, 2),)),
                                dict(exhaust_ticks=(2, 4)),
                                dict(queue_limit=3)])
def test_fault_config_any_serving(kw):
    assert FaultConfig(**kw).any_serving == JFaultConfig(**kw).any_serving \
        == bool(kw)


def test_reexports():
    from repro_torch import models, optim, serving
    from repro_torch.launch import train
    from repro_torch.models import api as mapi
    from repro_torch.models import overlay
    from repro_torch.optim import compress
    from repro_torch.serving import paging
    assert train.preset_config is configs.preset_config
    assert models.ArchConfig is mapi.ArchConfig
    assert models.SHAPES_BY_NAME is mapi.SHAPES_BY_NAME
    assert optim.int8_compress is compress.int8_compress
    assert serving.fold_deltas is overlay.fold_deltas
    assert serving.make_pool is paging.make_pool
    assert L.delta_out_cols is overlay.delta_out_cols
