"""The port's MoE layer (``models.layers.moe_apply`` and the per-row
dispatch) on the CPU against the JAX package's, on the expert shapes of
mixtral-smoke (4 experts, top-2) and deepseek-smoke (8 experts, top-2, a
shared expert), f32, with the JAX weights bridged across: outputs and the
Switch aux loss at capped and drop-free capacities, a skewed batch whose
dropped choices park in the trash slot, the probe's (B, E) tap and the
selected experts' deltas with their gradients, the per-row dispatch with
shared (E, D, F) and per-slot (B, E, D, F) expert weights, and the routing
of planted ties in the router's probabilities, which ``lax.top_k`` breaks
by the lower index.  Within the port: the per-row dispatch equals the
global one bit for bit at drop-free capacities, and the route reads
nothing on the host."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import layers as JL
from repro_torch import bridge, configs
from repro_torch.models import layers as L

ARCHS = ("mixtral-8x7b", "deepseek-v3-671b")
B, S = 3, 8
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module", params=ARCHS)
def layer(request):
    """One MoE layer's JAX weights (numpy) and the port's copy, a random
    input and the selected experts' random deltas."""
    arch = request.param
    jcfg, cfg = jconfigs.get_reduced(arch), configs.get_reduced(arch)
    jp = jax.tree_util.tree_map(np.asarray,
                                JL.moe_init(jax.random.PRNGKey(1), jcfg))
    rng = np.random.default_rng(2)
    x = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    idx = np.array([0, cfg.n_experts - 1])
    delta = {n: (rng.standard_normal((2,) + jp[n].shape[1:]) * 0.05)
             .astype(np.float32) for n in ("w_gate", "w_up", "w_down")}
    tap = (1.0 + 0.1 * rng.standard_normal((B, cfg.n_experts))).astype(
        np.float32)
    return jcfg, cfg, jp, bridge.tree_from_numpy(jp, device="cpu"), x, \
        idx, delta, tap


def t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize("drop_free", [False, True])
def test_moe_apply_matches_reference(layer, drop_free):
    jcfg, cfg, jp, tp, x, _, _, _ = layer
    want, jaux = JL.moe_apply(jp, jnp.asarray(x), jcfg, drop_free=drop_free)
    got, aux = L.moe_apply(tp, t(x), cfg, drop_free=drop_free)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert float(aux) == pytest.approx(float(jaux), rel=1e-5)
    if "shared" in tp:  # deepseek: the shared expert adds its MLP
        no_shared = {k: v for k, v in tp.items() if k != "shared"}
        assert not torch.allclose(L.moe_apply(no_shared, t(x), cfg)[0], got)


def test_dropped_choices_park_in_the_trash_slot(layer):
    """A batch skewed towards one expert overflows its capped queue: the
    dropped choices contribute nothing, exactly as in the JAX package, and
    at drop-free capacities nothing drops."""
    jcfg, cfg, jp, tp, x, _, _, _ = layer
    skew = x + 4.0 * jp["router"][:, 0] / np.linalg.norm(jp["router"][:, 0])
    xt = t(skew).reshape(-1, cfg.d_model)
    _, sel, _ = L._route((xt @ tp["router"]).float(), cfg.n_experts,
                         cfg.top_k)
    n = B * S
    cap = max(int(cfg.capacity_factor * n * cfg.top_k / cfg.n_experts), 4)
    _, keep, _ = L._queue_slots(sel, cfg.n_experts, cap)
    assert 0 < int((~keep).sum()) < keep.numel()
    for drop_free in (False, True):
        want, _ = JL.moe_apply(jp, jnp.asarray(skew), jcfg,
                               drop_free=drop_free)
        got, _ = L.moe_apply(tp, t(skew), cfg, drop_free=drop_free)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    _, keep, _ = L._queue_slots(sel, cfg.n_experts, n)
    assert bool(keep.all())


@pytest.mark.parametrize("rows", [False, True])
def test_taps_and_deltas_match_reference_with_gradients(layer, rows):
    """The probe's tap and the selected experts' deltas, global and per
    row: the output and the gradients of a weighted sum of it with
    respect to the tap and the deltas (Eq. 2's inner sum and the sparse
    update's)."""
    jcfg, cfg, jp, tp, x, idx, delta, tap = layer
    w = np.random.default_rng(7).standard_normal(x.shape).astype(np.float32)
    japply = JL._moe_apply_rows if rows else JL.moe_apply
    apply = L._moe_apply_rows if rows else L.moe_apply

    def jloss(tp_, d_):
        y, aux = japply(jp, jnp.asarray(x), jcfg, delta=d_, expert_idx=idx,
                        tap=tp_)
        return jnp.sum(y * w) + aux, y

    (_, want), (jg_tap, jg_d) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(
        jnp.asarray(tap), jax.tree_util.tree_map(jnp.asarray, delta))
    tap_t = t(tap).requires_grad_()
    d_t = {k: t(v).requires_grad_() for k, v in delta.items()}
    y, aux = apply(tp, t(x), cfg, delta=d_t, expert_idx=t(idx), tap=tap_t)
    (torch.sum(y * t(w)) + aux).backward()
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(tap_t.grad.numpy(), np.asarray(jg_tap),
                               rtol=1e-4, atol=1e-5)
    for k in delta:
        np.testing.assert_allclose(d_t[k].grad.numpy(), np.asarray(jg_d[k]),
                                   rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("drop_free", [False, True])
def test_row_dispatch_matches_reference(layer, drop_free):
    """Per-row queues with the shared (E, D, F) stacks, and with per-slot
    (B, E, D, F) stacks (the serving overlay, which ``moe_apply`` routes
    to the rows by their rank)."""
    jcfg, cfg, jp, tp, x, _, _, _ = layer
    want, jaux = JL._moe_apply_rows(jp, jnp.asarray(x), jcfg,
                                    drop_free=drop_free)
    got, aux = L._moe_apply_rows(tp, t(x), cfg, drop_free=drop_free)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert float(aux) == pytest.approx(float(jaux), rel=1e-5)
    rng = np.random.default_rng(3)
    jslot = dict(jp)
    for n in ("w_gate", "w_up", "w_down"):
        jslot[n] = (jp[n][None] + 0.05 * rng.standard_normal(
            (B,) + jp[n].shape)).astype(np.float32)
    want, _ = JL.moe_apply(jslot, jnp.asarray(x), jcfg, drop_free=drop_free)
    got, _ = L.moe_apply(bridge.tree_from_numpy(jslot, device="cpu"), t(x),
                         cfg, drop_free=drop_free)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_row_dispatch_equals_global_bit_for_bit_at_drop_free(layer):
    """The serving overlay's per-row dispatch with every slot's stack equal
    to the shared one gives the global dispatch's output bit for bit at
    drop-free capacities, so a personalised engine's zero rows serve the
    base model exactly."""
    _, cfg, _, tp, x, _, _, _ = layer
    want, _ = L.moe_apply(tp, t(x), cfg, drop_free=True)
    slot = dict(tp)
    for n in ("w_gate", "w_up", "w_down"):
        slot[n] = tp[n].expand(B, *tp[n].shape).clone()
    got, _ = L.moe_apply(slot, t(x), cfg, drop_free=True)
    assert torch.equal(got, want)


def test_top_k_breaks_ties_by_the_lower_index():
    """Probabilities drawn from three values tie everywhere: the port's
    pick is ``lax.top_k``'s, value and index, at every k."""
    rng = np.random.default_rng(0)
    probs = rng.choice(np.float32([0.1, 0.25, 0.4]), size=(64, 8))
    for k in (1, 2, 3, 8):
        jv, ji = jax.lax.top_k(jnp.asarray(probs), k)
        v, i = L.top_k(t(probs), k)
        np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(v.numpy(), np.asarray(jv))


def test_planted_router_tie_routes_as_the_reference(layer):
    """Two experts with the same router column have equal probabilities
    on every token: both packages send each token to the lower one first,
    so outputs, gates and queues agree."""
    jcfg, cfg, jp, tp, x, _, _, _ = layer
    jtie = dict(jp, router=jp["router"].copy())
    jtie["router"][:, 1] = jtie["router"][:, 0]
    ttie = dict(tp, router=t(jtie["router"]))
    probs = torch.softmax((t(x).reshape(-1, cfg.d_model)
                           @ ttie["router"]).float(), -1)
    assert torch.equal(probs[:, 0], probs[:, 1])
    for drop_free in (False, True):
        want, jaux = JL.moe_apply(jtie, jnp.asarray(x), jcfg,
                                  drop_free=drop_free)
        got, aux = L.moe_apply(ttie, t(x), cfg, drop_free=drop_free)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        assert float(aux) == pytest.approx(float(jaux), rel=1e-5)
    _, sel = L.top_k(probs, cfg.top_k)
    _, jsel = jax.lax.top_k(jnp.asarray(probs.numpy()), cfg.top_k)
    np.testing.assert_array_equal(sel.numpy(), np.asarray(jsel))
