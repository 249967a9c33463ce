"""The port's unit-kind overlay registry on the CPU against the JAX
package's, on qwen2-smoke and deepseek-smoke (MLA heads, a dense-head MLP
layer, MoE experts), f32, with the JAX weights and deltas bridged across.

The built-in kinds fold through the registry bit for bit as
``repro.models.overlay.fold_deltas`` does; a declarative kind registered
from outside both packages, and a raw folder, fold equal too, with the
caller's params untouched; ``slot_params`` gives each slot the weights of
its user's fold; ``unit_cols`` agrees; both engines refuse a raw folder
under ``personalise=``; the port refuses a kind its per-slot forward would
not apply, where the JAX engine serves the base weights for it (pinned);
and a spec that replaces the built-in ``mlp`` serves per slot what the
folded copies serve.  Every kind a test registers is unregistered after
it (both registries are process-wide, and xdist workers run several
modules in one process)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core import lm_backbone as jlm_backbone
from repro.core.policy import SelectedUnit as JUnit
from repro.core.policy import SparseUpdatePolicy as JPolicy
from repro.models import overlay as JOV
from repro.models import transformer as JT
from repro.serving import DeltaSet as JDeltaSet
from repro.serving import Request as JRequest
from repro.serving import ServeEngine as JServeEngine
from repro_torch import bridge, configs
from repro_torch.core.backbones import lm_backbone
from repro_torch.core.policy import SelectedUnit, SparseUpdatePolicy
from repro_torch.models import layers as L
from repro_torch.models import overlay as OV
from repro_torch.models import transformer as T
from repro_torch.serving import DeltaSet, Request, ServeEngine
from repro_torch.serving import engine as port_engine
from repro_torch.utils import tree_leaves, tree_map

ARCHS = ("qwen2-1.5b", "deepseek-v3-671b")
ENGINE = dict(slots=2, max_len=16, chunk=4, prefill_block=4)
CUSTOM = "mlp_updown"  # a kind of neither package: w_up columns, w_down rows


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def registries():
    """Both registries as they were before the test, restored after it."""
    saved = dict(OV._UNIT_OVERLAYS), dict(JOV._UNIT_OVERLAYS)
    yield
    for reg, old in zip((OV._UNIT_OVERLAYS, JOV._UNIT_OVERLAYS), saved):
        reg.clear()
        reg.update(old)


def covering_policy(costs, unit_cls, policy_cls):
    """One unit of every kind (its first and last channel)."""
    units, seen = [], set()
    for c in reversed(costs):
        if c.kind not in seen:
            units.append(unit_cls(c.layer, c.kind,
                                  tuple(sorted({0, c.n_channels - 1}))))
            seen.add(c.kind)
    units.sort(key=lambda u: (u.layer, u.kind))
    return policy_cls(horizon=0, units=tuple(units))


def rand_tree(tree, seed):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda x: (rng.standard_normal(x.shape) * 0.5).astype(np.float32),
        tree)


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    """(jcfg, JAX params, cfg, port params, JAX policy, port policy, two
    users' deltas in numpy): the covering policy and seeded deltas."""
    arch = request.param
    jcfg = jconfigs.get_reduced(arch)
    jparams = JT.init_params(jcfg, jax.random.PRNGKey(0))
    jbb = jlm_backbone(jcfg, tokens_per_batch=32, batch_size=2)
    jpolicy = covering_policy(jbb.unit_costs, JUnit, JPolicy)
    cfg = configs.get_reduced(arch)
    params = bridge.params_from_numpy(
        cfg, jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    policy = covering_policy(lm_backbone(cfg, 32, 2).unit_costs,
                             SelectedUnit, SparseUpdatePolicy)
    assert [(u.layer, u.kind, u.channels) for u in policy.units] == \
        [(u.layer, u.kind, u.channels) for u in jpolicy.units]
    zero = jax.tree_util.tree_map(np.asarray, jbb.init_deltas(jpolicy))
    users = [rand_tree(zero, 3), rand_tree(zero, 4)]
    return jcfg, jparams, cfg, params, jpolicy, policy, users


def assert_trees_equal(jtree, ttree):
    if isinstance(jtree, dict):
        assert sorted(jtree) == sorted(ttree)
        for k in jtree:
            assert_trees_equal(jtree[k], ttree[k])
        return
    want = np.asarray(jtree)
    got = ttree.detach().cpu().numpy()
    assert got.dtype == want.dtype and np.array_equal(got, want)


def snapshot(params):
    return tree_map(lambda t: t.clone(), params)


def assert_untouched(params, before):
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(params),
                                                 tree_leaves(before)))


def mlp_layer(costs) -> int:
    return next(c.layer for c in costs if c.kind == "mlp")


def custom_edits(ov):
    return (ov.Edit("w_up", "w_up", "out"), ov.Edit("w_down", "w_down", "in"))


def register_custom(kind=CUSTOM):
    """The same declarative kind in both packages, from outside them."""
    JOV.register_unit_overlay(JOV.UnitOverlay(
        kind, "mlp", custom_edits(JOV),
        delta_init=lambda cfg, lid, k, dtype: {
            "w_up": jnp.zeros((cfg.d_model, k), dtype),
            "w_down": jnp.zeros((k, cfg.d_model), dtype)}))
    OV.register_unit_overlay(OV.UnitOverlay(
        kind, "mlp", custom_edits(OV),
        delta_init=lambda cfg, lid, k, dtype, device: {
            "w_up": torch.zeros((cfg.d_model, k), dtype=dtype, device=device),
            "w_down": torch.zeros((k, cfg.d_model), dtype=dtype,
                                  device=device)}))


def custom_case(jcfg, cfg, kind=CUSTOM, seed=7):
    """A one-unit policy of ``kind`` on the first MLP layer and its
    deltas, in both packages' types."""
    layer = mlp_layer(lm_backbone(cfg, 32, 2).unit_costs)
    chans = (1, 3)
    rng = np.random.default_rng(seed)
    d = {"w_up": rng.standard_normal((cfg.d_model, 2)).astype(np.float32),
         "w_down": rng.standard_normal((2, cfg.d_model)).astype(np.float32)}
    jpol = JPolicy(horizon=0, units=(JUnit(layer, kind, chans),))
    pol = SparseUpdatePolicy(horizon=0, units=(SelectedUnit(layer, kind,
                                                            chans),))
    deltas = {f"L{layer}": {kind: d}}
    return jpol, pol, deltas


def test_builtin_kinds_fold_as_the_jax_package(model):
    jcfg, jparams, cfg, params, jpolicy, policy, users = model
    before = snapshot(params)
    for d in users:
        want = JOV.fold_deltas(jcfg, jparams, d, jpolicy)
        got = OV.fold_deltas(cfg, params, bridge.tree_from_numpy(
            d, device="cpu"), policy)
        assert_trees_equal(want, got)
    assert_untouched(params, before)


def test_declarative_kind_folds_as_the_jax_package(model):
    jcfg, jparams, cfg, params, *_ = model
    register_custom()
    jpol, pol, deltas = custom_case(jcfg, cfg)
    before = snapshot(params)
    want = JOV.fold_deltas(jcfg, jparams, deltas, jpol)
    got = OV.fold_deltas(cfg, params, bridge.tree_from_numpy(
        deltas, device="cpu"), pol)
    assert_trees_equal(want, got)
    assert_untouched(params, before)
    lid = pol.units[0].layer
    g = next(f"g{gi}" for gi, (_, ids) in enumerate(T.stack_groups(cfg))
             if lid in ids)
    assert not torch.equal(got["stacks"][g]["mlp"]["w_up"],
                           params["stacks"][g]["mlp"]["w_up"])
    # the kind's registered delta_init gives the zero pack of its shapes
    z = OV.delta_init(cfg, lid, CUSTOM, 2, torch.float32, "cpu")
    assert {k: tuple(v.shape) for k, v in z.items()} == {
        k: v.shape for k, v in deltas[f"L{lid}"][CUSTOM].items()}


def test_raw_folder_folds_as_the_jax_package(model):
    jcfg, jparams, cfg, params, *_ = model

    @JOV.register_unit_folder("rawup")
    def jfold(cfg_, stack, j, d, idx):
        stack["mlp"]["w_up"] = stack["mlp"]["w_up"].at[j, :, idx].add(
            d["w"].T)

    @OV.register_unit_folder("rawup")
    def fold(cfg_, stack, j, d, idx):
        w = stack["mlp"]["w_up"].clone()
        w[j, :, torch.as_tensor(idx).long()] += d["w"].to(w.dtype)
        stack["mlp"]["w_up"] = w

    jpol, pol, deltas = custom_case(jcfg, cfg, kind="rawup")
    lid = pol.units[0].layer
    deltas = {f"L{lid}": {"rawup": {"w": deltas[f"L{lid}"]["rawup"]["w_up"]}}}
    before = snapshot(params)
    want = JOV.fold_deltas(jcfg, jparams, deltas, jpol)
    got = OV.fold_deltas(cfg, params, bridge.tree_from_numpy(
        deltas, device="cpu"), pol)
    assert_trees_equal(want, got)
    assert_untouched(params, before)
    with pytest.raises(ValueError, match="no per-slot overlay"):
        OV.slot_params(cfg, "rawup", {}, {}, torch.zeros((1, 1)))


def test_slot_params_equal_each_users_fold(model):
    _, _, cfg, params, _, policy, users = model
    udeltas = [bridge.tree_from_numpy(d, device="cpu") for d in users]
    folded = [OV.fold_deltas(cfg, params, d, policy) for d in udeltas]
    where = {lid: (gi, j) for gi, (_, ids) in enumerate(T.stack_groups(cfg))
             for j, lid in enumerate(ids)}
    for u in policy.units:
        gi, j = where[u.layer]
        spec = OV.get_overlay(OV.resolve_kind(cfg, u.kind))
        layer = {k: v[j] for k, v in
                 params["stacks"][f"g{gi}"][spec.param_key].items()
                 if torch.is_tensor(v)}
        d_stack = {k: torch.stack([d[f"L{u.layer}"][u.kind][k]
                                   for d in udeltas])
                   for k in udeltas[0][f"L{u.layer}"][u.kind]}
        idx = torch.tensor([u.channels, u.channels])
        eff = OV.slot_params(cfg, u.kind, layer, d_stack, idx)
        for e in spec.edits:
            if e.delta_name not in d_stack:
                continue
            for b, f in enumerate(folded):
                want = f["stacks"][f"g{gi}"][spec.param_key][e.param_name][j]
                assert torch.equal(eff[e.param_name][b], want), (u, e)


@pytest.mark.parametrize("rows", [1, 3])
def test_per_slot_product_is_the_whole_blocks_rows(rows):
    """``layers.bmm`` gives slot b the rows of the whole block's product
    with ``w[b]``, the product a folded copy runs, bit for bit, as one
    contiguous tensor (the flash kernels downstream take no strides)."""
    g = torch.Generator().manual_seed(5)
    x = torch.randn((4, rows, 2, 24), generator=g)
    w = torch.randn((4, 24, 40), generator=g)
    got = L.bmm(x, w)
    assert got.shape == (4, rows, 2, 40) and got.is_contiguous()
    flat = x.reshape(-1, 24)
    for b in range(4):
        want = (flat @ w[b]).view(4, rows, 2, 40)[b]
        assert torch.equal(got[b], want)


def test_unit_cols_equal(model):
    jcfg, _, cfg, _, jpolicy, _, _ = model
    idx = np.array([0, 2], np.int32)
    for kind in sorted({u.kind for u in jpolicy.units}):
        spec = JOV.get_overlay(JOV.resolve_kind(jcfg, kind))
        for e in spec.edits:
            want = np.asarray(JOV.unit_cols(jcfg, kind, e.param_name)(idx))
            got = OV.unit_cols(cfg, kind, e.param_name)(
                torch.from_numpy(idx).long())
            assert np.array_equal(got.numpy(), want), (kind, e.param_name)
    with pytest.raises(ValueError, match="no unit folder registered"):
        OV.get_overlay("nope")
    with pytest.raises(ValueError, match="has no edit for weight"):
        OV.unit_cols(cfg, "mlp", "nope")


def test_both_engines_refuse_a_raw_folder_per_slot(model):
    jcfg, jparams, cfg, params, *_ = model
    JOV.register_unit_folder("rawup")(lambda *a: None)
    port_engine.register_unit_folder("rawup")(lambda *a: None)
    jpol, pol, _ = custom_case(jcfg, cfg, kind="rawup")
    with pytest.raises(ValueError) as jerr:
        JServeEngine(jcfg, jparams, personalise=jpol, **ENGINE)
    with pytest.raises(ValueError) as err:
        ServeEngine(cfg, params, personalise=pol, device="cpu", **ENGINE)
    assert str(err.value) == str(jerr.value)
    assert "no per-slot overlay" in str(err.value)


def requests(cls, vocab, uid_of=lambda i: i % 2):
    rng = np.random.default_rng(2)
    return [cls(uid=uid_of(i), prompt=rng.integers(
        0, vocab, size=int(rng.integers(3, 7))).astype(np.int32), max_new=4)
        for i in range(4)]


def streams(reqs):
    return [(list(r.out), r.outcome) for r in reqs]


def test_a_kind_the_forward_would_not_apply(model):
    """The port refuses it; the JAX engine builds an arena for it and
    serves the base weights (a known state of the reference, pinned)."""
    jcfg, jparams, cfg, params, *_ = model
    register_custom()
    jpol, pol, deltas = custom_case(jcfg, cfg)
    with pytest.raises(ValueError, match="not one the per-slot forward "
                                         "applies"):
        ServeEngine(cfg, params, personalise=pol, device="cpu", **ENGINE)
    if cfg.mla:
        return  # one pinned JAX run is enough
    eng = JServeEngine(jcfg, jparams, personalise=jpol, **ENGINE)
    eng.swap_deltas(0, JDeltaSet.from_policy(jpol, deltas))
    got = streams(eng.run(requests(JRequest, jcfg.vocab, lambda i: 0)))
    base = streams(JServeEngine(jcfg, jparams, **ENGINE).run(
        requests(JRequest, jcfg.vocab, lambda i: 0)))
    folded = streams(JServeEngine(
        jcfg, JOV.fold_deltas(jcfg, jparams, deltas, jpol), **ENGINE).run(
        requests(JRequest, jcfg.vocab, lambda i: 0)))
    assert got == base != folded


def test_a_replaced_builtin_serves_per_slot_as_folded(model):
    """A spec registered under the built-in ``mlp`` (w_up and w_down only)
    folds as the JAX package's same replacement does and serves two users
    per slot as their folded copies serve them."""
    jcfg, jparams, cfg, params, *_ = model
    register_custom(kind="mlp")
    jpol, pol, deltas = custom_case(jcfg, cfg, kind="mlp")
    users = {0: deltas, 1: rand_tree(deltas, 9)}
    tusers = {u: bridge.tree_from_numpy(d, device="cpu")
              for u, d in users.items()}
    for u in users:
        assert_trees_equal(JOV.fold_deltas(jcfg, jparams, users[u], jpol),
                           OV.fold_deltas(cfg, params, tusers[u], pol))
    eng = ServeEngine(cfg, params, personalise=pol, device="cpu", **ENGINE)
    for u, d in tusers.items():
        assert eng.swap_deltas(u, DeltaSet.from_policy(pol, d)) == 0
    got = streams(eng.run(requests(Request, cfg.vocab)))
    per_user = {u: streams(ServeEngine(
        cfg, OV.fold_deltas(cfg, params, d, pol), device="cpu",
        **ENGINE).run(requests(Request, cfg.vocab)))
        for u, d in tusers.items()}
    assert got == [per_user[i % 2][i] for i in range(len(got))]
    assert got != streams(ServeEngine(cfg, params, device="cpu",
                                      **ENGINE).run(requests(Request,
                                                             cfg.vocab)))


def test_engine_reexports_the_registry():
    assert port_engine.fold_deltas is OV.fold_deltas
    assert port_engine.fold_kind is OV.resolve_kind
    assert port_engine.register_unit_overlay is OV.register_unit_overlay
    assert port_engine.register_unit_folder is OV.register_unit_folder
