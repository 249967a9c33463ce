"""Per-slot personalisation of the encoder-decoder and VLM families on the
CPU: the twin of ``tests/test_personalise.py``'s
``test_overlay_parity_whisper_xattn``.  Two users' random deltas over one
unit of every kind the config has (whisper-smoke: self-attention heads,
cross-attention heads ``xattn``, MLP neurons; paligemma-smoke: attention
heads over one KV head, GeGLU neurons) resident at once through the
engine's delta arena (``swap_deltas``), every request with its own
encoder inputs: the streams equal each user's folded serving copy on the
eager loop, fused B1 and fused B8, contiguous and paged, and the JAX
engine's personalised streams on the same weights and deltas."""
import jax
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core.policy import SelectedUnit as JUnit
from repro.core.policy import SparseUpdatePolicy as JPolicy
from repro.models import transformer as JT
from repro.serving import DeltaSet as JDeltaSet
from repro.serving import Request as JRequest
from repro.serving import ServeEngine as JServeEngine
from repro_torch import bridge, configs
from repro_torch.core.backbones import lm_backbone
from repro_torch.core.policy import SelectedUnit, SparseUpdatePolicy
from repro_torch.models import overlay as OV
from repro_torch.serving import DeltaSet, Request, ServeEngine
from repro_torch.utils import tree_map

ARCHS = ["whisper-base", "paligemma-3b"]
ENGINE = dict(slots=2, max_len=32, chunk=8)
MODES = {"b8": {}, "b1": dict(prefill_block=1), "eager": dict(fused=False),
         "paged": dict(kv_paging=True, kv_page_size=4)}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def covering_units(cfg):
    """One unit of every kind, two channels each (the first and the last),
    over the last layer's units of each kind."""
    units, seen = [], set()
    for c in reversed(lm_backbone(cfg, 32, 2).unit_costs):
        if c.kind not in seen:
            seen.add(c.kind)
            units.append((c.layer, c.kind, (0, c.n_channels - 1)))
    return sorted(units)


@pytest.fixture(scope="module", params=ARCHS)
def setup(request):
    arch = request.param
    jcfg, cfg = jconfigs.get_reduced(arch), configs.get_reduced(arch)
    jp = JT.init_params(jcfg, jax.random.PRNGKey(0))
    tp = bridge.params_from_numpy(cfg, jax.tree_util.tree_map(np.asarray, jp),
                                  device="cpu")
    units = covering_units(cfg)
    policy = SparseUpdatePolicy(horizon=0, units=tuple(
        SelectedUnit(*u) for u in units))
    jpolicy = JPolicy(horizon=0, units=tuple(JUnit(*u) for u in units))
    bb = lm_backbone(cfg, 32, 2)
    gen = torch.Generator().manual_seed(5)
    user_deltas = {u: tree_map(lambda z: 0.5 * torch.randn(
        z.shape, generator=gen), bb.init_deltas(policy, "cpu"))
        for u in (0, 1)}
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, cfg.vocab, int(rng.integers(3, 8)))
               .astype(np.int32) for _ in range(4)]
    feats = [rng.standard_normal(cfg.enc_feats_shape).astype(np.float32)
             for _ in prompts]
    return dict(arch=arch, jcfg=jcfg, cfg=cfg, jp=jp, tp=tp, policy=policy,
                jpolicy=jpolicy, user_deltas=user_deltas, prompts=prompts,
                feats=feats)


def _requests(make, s):
    return [make(uid=i % 2, prompt=p.copy(), max_new=5, enc_feats=f.copy())
            for i, (p, f) in enumerate(zip(s["prompts"], s["feats"]))]


def streams(reqs):
    return [(list(r.out), r.outcome) for r in reqs]


def test_units_cover_every_kind(setup):
    kinds = {u.kind for u in setup["policy"].units}
    want = ({"attn", "xattn", "mlp"} if setup["cfg"].is_encoder_decoder
            else {"attn", "mlp"})
    assert kinds == want


@pytest.mark.parametrize("mode", list(MODES))
def test_overlay_streams_equal_the_per_user_fold(setup, mode):
    """Each slot serves its own user's deltas from one copy of the base
    weights: the streams of users 0 and 1 equal their folded copies',
    with one host sync a chunk on the fused loops."""
    s = setup
    cfg, tp, policy = s["cfg"], s["tp"], s["policy"]
    kw = dict(ENGINE, **MODES[mode])
    eng = ServeEngine(cfg, tp, device="cpu", personalise=policy, **kw)
    for u, d in s["user_deltas"].items():
        eng.swap_deltas(u, DeltaSet.from_policy(policy, d))
    reqs = _requests(Request, s)
    eng.run(reqs)
    if kw.get("fused", True):
        rep = eng.last_run_report
        assert rep["host_syncs"] == rep["chunks"]
    got = streams(reqs)
    want = []
    for u, d in s["user_deltas"].items():
        folded = ServeEngine(cfg, OV.fold_deltas(cfg, tp, d, policy),
                             device="cpu", **kw)
        mine = [r for r in _requests(Request, s) if r.uid == u]
        folded.run(mine)
        want.append(streams(mine))
    oracle = [want[i % 2][i // 2] for i in range(len(reqs))]
    assert got == oracle
    assert all(o == "done" for _, o in got)


def test_overlay_streams_equal_the_jax_engine(setup):
    """The JAX engine, personalised with the same deltas per user on the
    same weights, serves the same streams."""
    s = setup
    jeng = JServeEngine(s["jcfg"], s["jp"], personalise=s["jpolicy"],
                        **ENGINE)
    for u, d in s["user_deltas"].items():
        jeng.swap_deltas(u, JDeltaSet.from_policy(
            s["jpolicy"], jax.tree_util.tree_map(
                jax.numpy.asarray, bridge.tree_to_numpy(d))))
    jreqs = _requests(JRequest, s)
    jeng.run(jreqs)
    eng = ServeEngine(s["cfg"], s["tp"], device="cpu",
                      personalise=s["policy"], **ENGINE)
    for u, d in s["user_deltas"].items():
        eng.swap_deltas(u, DeltaSet.from_policy(s["policy"], d))
    reqs = _requests(Request, s)
    eng.run(reqs)
    assert streams(reqs) == streams(jreqs)


def test_xattn_slot_params_is_the_fold(setup):
    """``slot_params("xattn")`` gives each slot the fold's cross-attention
    weights (a zero row the base weights); only ``wq``/``wo`` change."""
    s = setup
    cfg, tp, policy = s["cfg"], s["tp"], s["policy"]
    if not cfg.is_encoder_decoder:
        with pytest.raises(ValueError, match="no unit folder registered"):
            OV.slot_params(cfg, "conv", {}, {}, torch.zeros((1, 1)))
        return
    (u,) = [u for u in policy.units if u.kind == "xattn"]
    d = s["user_deltas"][0][f"L{u.layer}"]["xattn"]
    stk = {n: torch.stack([v, torch.zeros_like(v)]) for n, v in d.items()}
    lp = {k: v[u.layer] for k, v in tp["stacks"]["g0"]["xattn"].items()}
    eff = OV.slot_params(cfg, "xattn", lp, stk,
                         torch.tensor([u.channels, u.channels]))
    folded = OV.fold_deltas(cfg, tp, s["user_deltas"][0], policy)
    for n in ("wq", "wo"):
        assert torch.equal(eff[n][0], folded["stacks"]["g0"]["xattn"][n][
            u.layer])
        assert torch.equal(eff[n][1], lp[n])
    assert eff["wk"] is lp["wk"] and eff["wv"] is lp["wv"]


@pytest.mark.parametrize("arch", ARCHS)
def test_adapt_many_equals_adapt(arch):
    """Two tasks of different row counts through ``adapt_many``'s batched
    probe and fine-tune (bucket padding to 64 rows): each task's
    conditioning rides with its rows, so each gets its own adapt's policy
    and losses."""
    from repro_torch import api

    bb = api.backbone(arch, preset="smoke", batch_size=40, seq=16)
    session = api.TinyTrainSession(bb, max_way=5, device="cpu", seed=0)
    tasks = [api.sample_encdec_task(np.random.default_rng(i), bb.cfg,
                                    seq=16, max_way=5, support_pad=pad,
                                    query_pad=pad)
             for i, pad in enumerate((33, 40))]
    many = session.adapt_many(tasks, api.JETSON_NANO, iters=2)
    for got, task in zip(many, tasks):
        want = session.adapt(task, api.JETSON_NANO, iters=2)
        assert got.policy.units == want.policy.units
        np.testing.assert_allclose(got.losses, want.losses, rtol=1e-5,
                                   atol=1e-6)
