"""Shared checks of the port's encoder-decoder and VLM families against
the JAX package, imported by ``test_torch_encdec.py`` (whisper-smoke) and
``test_torch_vlm.py`` (paligemma-smoke), each of which names its ``ARCH``.

Every check runs on the smoke config in float32 with the JAX weights
bridged across (``repro_torch.bridge``), against one module-scoped run of
the JAX package: the parameter tree, unit costs and tap groups (the
cross-attention ``xattn`` group on whisper); ``encode``; ``lm_loss``,
pooled features and every tap group's gradient; the probe's Eq. 2 scores;
TinyTrain's policy, losses and deltas, the fold and the folded engine's
streams; the remat option (the loss and the deltas equal a plain
policy's) and ``logit_chunk`` (the loss and its gradient equal the
unchunked ones).  Tolerances are ROADMAP's: float32 values within 1e-5,
policies and streams identical."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro import api as japi
from repro import configs as jconfigs
from repro.core import lm_backbone as jlm_backbone
from repro.models import transformer as JT
from repro.serving import Request as JRequest
from repro.serving import ServeEngine as JServeEngine
from repro_torch import api, bridge, configs
from repro_torch.core.backbones import lm_backbone
from repro_torch.core.fisher import leaf_taps, tap_grads
from repro_torch.models import overlay as OV
from repro_torch.models import transformer as T
from repro_torch.serving import Request, ServeEngine
from repro_torch.utils import tree_map

ITERS = 4
TASK = dict(seq=16, max_way=5, support_pad=40, query_pad=40)
ENGINE = dict(slots=3, max_len=40, chunk=4)
PROMPT_LENS = (3, 5, 8, 9, 17)
TOL = dict(rtol=1e-5, atol=1e-5)

__all__ = [
    "one_thread", "ref",
    "test_params_unit_costs_and_taps_match_reference",
    "test_encode_matches_reference",
    "test_loss_features_and_tap_gradients_match_reference",
    "test_probe_scores_match_reference",
    "test_policy_losses_deltas_and_folded_streams_match",
    "test_fold_is_exact_on_reference_deltas",
    "test_remat_matches_a_plain_policy",
    "test_logit_chunk_matches_the_unchunked_loss",
]


def streams(reqs):
    return [(list(r.out), r.outcome) for r in reqs]


def requests(make, cfg, max_new=6, seed=3):
    """Five requests of ragged prompts, each with its own encoder inputs."""
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, cfg.vocab, n).astype(np.int32)
               for n in PROMPT_LENS]
    feats = [rng.standard_normal(cfg.enc_feats_shape).astype(np.float32)
             for _ in PROMPT_LENS]
    return [make(uid=i, prompt=p, max_new=max_new, enc_feats=f)
            for i, (p, f) in enumerate(zip(prompts, feats))]


def request_arch(cfg) -> str:
    """The registry id of a smoke config."""
    return {"whisper-smoke": "whisper-base",
            "paligemma-smoke": "paligemma-3b"}[cfg.name]


def feat_key(cfg) -> str:
    return "frames" if cfg.is_encoder_decoder else "image_embeds"


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
    """The smoke model's ops are tiny: several CPU threads per op only
    contend under the parallel test run."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def ref(request):
    """The JAX package's runs, once per module: a conditioned batch's loss,
    pooled features, tap gradients and (whisper) encoder output, the
    probe's scores, one fused adapt and its folded engine's streams; plus the port's session on the
    bridged weights and its own adapt."""
    arch = request.module.ARCH
    jcfg = jconfigs.get_reduced(arch)
    rows = TASK["support_pad"]
    jbb = jlm_backbone(jcfg, tokens_per_batch=rows * TASK["seq"],
                       batch_size=rows)
    js = japi.TinyTrainSession(jbb, max_way=5, seed=0)
    jtask = japi.sample_encdec_task(np.random.default_rng(0), jcfg, **TASK)
    n = len(jtask.support["episode_labels"])
    key = feat_key(jcfg)
    toks = np.asarray(jtask.support["tokens"])[:6].copy()
    labels = np.roll(toks, -1, axis=1)
    labels[:, -1] = -1
    toks[5, 10:] = -1  # a padded row: pooled features average fewer tokens
    batch = {"tokens": toks, "labels": labels,
             key: np.asarray(jtask.support[key])[:6]}
    out = {"batch": batch,
           "loss": float(jax.jit(JT.lm_loss, static_argnums=0)(
               jcfg, js.params, batch)),
           "features": np.asarray(jax.jit(JT.pooled_features,
                                          static_argnums=0)(
               jcfg, js.params, batch))}
    if jcfg.is_encoder_decoder:
        out["encode"] = np.asarray(JT.encode(jcfg, js.params,
                                             batch["frames"]))
    out["tap_grads"] = jax.tree_util.tree_map(np.asarray, jax.jit(jax.grad(
        lambda taps: JT.lm_loss(jcfg, js.params, batch, taps=taps)))(
        jbb.make_taps(6)))
    out["chans"] = jax.tree_util.tree_map(
        np.asarray, js.step_cache.probe_fisher()(
            js.params, jtask.support, jtask.pseudo_query,
            jbb.make_taps(n), np.float32(jtask.n_support)))
    out["adapt"] = js.adapt(jtask, japi.JETSON_NANO, iters=ITERS)
    eng = JServeEngine(jcfg, js.params, **ENGINE)
    out["adapt"].fold_into(eng)
    out["streams"] = streams(eng.run(requests(JRequest, jcfg)))

    cfg = configs.get_reduced(arch)
    bb = lm_backbone(cfg, tokens_per_batch=rows * TASK["seq"],
                     batch_size=rows)
    params = bridge.params_from_numpy(
        cfg, jax.tree_util.tree_map(np.asarray, js.params), device="cpu")
    session = api.TinyTrainSession(bb, params, max_way=5)
    task = api.sample_encdec_task(np.random.default_rng(0), cfg, **TASK)
    port = {"adapt": session.adapt(task, api.JETSON_NANO, iters=ITERS)}
    return out, session, task, port


def _batch(out):
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in out["batch"].items()}


@pytest.mark.parametrize("preset", ["smoke", "full"])
def test_params_unit_costs_and_taps_match_reference(request, preset):
    """Unit costs (whisper: an ``xattn`` unit a decoder layer), tap
    groups, and the parameter tree (whisper's ``encoder``, ``enc_norm``,
    ``norm_x``/``xattn``; paligemma's ``img_proj``) have the reference's
    shapes, at the smoke preset and at the published config."""
    arch = request.module.ARCH
    cfg = configs.preset_config(arch, preset)
    jcfg = jconfigs.preset_config(arch, preset)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    T.check_supported(cfg)
    bb = lm_backbone(cfg, 48 * 64, 48)
    jbb = jlm_backbone(jcfg, 48 * 64, 48)
    assert ([vars(c) for c in bb.unit_costs]
            == [vars(c) for c in jbb.unit_costs])
    kinds = {c.kind for c in bb.unit_costs}
    assert kinds == ({"attn", "xattn", "mlp"} if cfg.is_encoder_decoder
                     else {"attn", "mlp"})
    shapes = {g: {k: tuple(v.shape) for k, v in grp.items()}
              for g, grp in bb.make_taps(5, "meta").items()}
    assert shapes == {g: {k: tuple(v.shape) for k, v in grp.items()}
                      for g, grp in jbb.make_taps(5).items()}
    jp = jax.eval_shape(lambda: JT.init_params(jcfg, jax.random.PRNGKey(0)))
    if preset == "full":
        n = sum(int(np.prod(a.shape)) for a in jax.tree_util.tree_leaves(jp))
        assert n == {"whisper-base": 70_627_840,
                     "paligemma-3b": 2_511_022_080}[arch]
        return
    tp = T.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    assert (jax.tree_util.tree_map(lambda a: (tuple(a.shape), str(a.dtype)),
                                   bridge.tree_to_numpy(tp))
            == jax.tree_util.tree_map(lambda a: (tuple(a.shape),
                                                 str(a.dtype)), jp))


def test_encode_matches_reference(ref):
    """whisper's encoder over the batch's frames; paligemma's image prefix
    (``img_proj``) as ``build_inputs`` lays it ahead of the tokens."""
    out, session, _, _ = ref
    cfg, params = session.backbone.cfg, session.params
    b = _batch(out)
    if cfg.is_encoder_decoder:
        got = T.encode(cfg, params, b["frames"])
        np.testing.assert_allclose(got.numpy(), out["encode"], **TOL)
        return
    x, positions, enc_out = T.build_inputs(cfg, params, b)
    want_x, want_pos, want_enc = JT.build_inputs(
        jconfigs.get_reduced(request_arch(cfg)),
        jax.tree_util.tree_map(jax.numpy.asarray,
                               bridge.tree_to_numpy(params)),
        out["batch"])
    assert enc_out is None and want_enc is None
    assert x.shape == (6, cfg.n_img_tokens + 16, cfg.d_model)
    np.testing.assert_allclose(x.numpy(), np.asarray(want_x), **TOL)
    np.testing.assert_array_equal(positions.numpy(), np.asarray(want_pos))


def test_loss_features_and_tap_gradients_match_reference(ref):
    out, session, _, _ = ref
    cfg, params = session.backbone.cfg, session.params
    loss = T.lm_loss(cfg, params, _batch(out))
    assert float(loss) == pytest.approx(out["loss"], rel=1e-5)
    feats = T.pooled_features(cfg, params, _batch(out))
    np.testing.assert_allclose(feats.numpy(), out["features"], **TOL)
    taps = leaf_taps(session.backbone.make_taps(6, "cpu"))
    got = tap_grads(T.lm_loss(cfg, params, _batch(out), taps=taps), taps)
    want = out["tap_grads"]
    assert {g: sorted(v) for g, v in got.items()} == {
        g: sorted(v) for g, v in want.items()}
    if cfg.is_encoder_decoder:
        assert "xattn" in got["g0"]
    for g, grp in want.items():
        for k, w in grp.items():
            np.testing.assert_allclose(
                got[g][k].numpy(), w, rtol=1e-5,
                atol=1e-5 * float(np.abs(w).max()), err_msg=f"{g}/{k}")


def test_probe_scores_match_reference(ref):
    """Eq. 2 per unit through the port's probe (the Fisher kernel's plain
    version on the CPU), the xattn group included on whisper."""
    out, session, task, _ = ref
    sup = {k: torch.from_numpy(v) for k, v in task.support.items()}
    pq = {k: torch.from_numpy(v) for k, v in task.pseudo_query.items()}
    taps = session.backbone.make_taps(len(task.support["episode_labels"]),
                                      "cpu")
    chans = session.step_cache.probe_fisher()(session.params, sup, pq, taps,
                                              float(task.n_support))
    assert set(chans) == set(out["chans"])
    if session.backbone.cfg.is_encoder_decoder:
        assert any(kind == "xattn" for _, kind in chans)
    for key, want in out["chans"].items():
        np.testing.assert_allclose(chans[key].numpy(), want, rtol=1e-5,
                                   atol=1e-5 * float(np.abs(want).max()))


def test_policy_losses_deltas_and_folded_streams_match(ref):
    out, session, _, port = ref
    got, want = port["adapt"], out["adapt"]
    assert ([(u.layer, u.kind, u.channels) for u in got.policy.units]
            == [(u.layer, u.kind, u.channels) for u in want.policy.units])
    assert got.policy.horizon == want.policy.horizon and got.policy.units
    np.testing.assert_allclose(got.losses, want.losses, **TOL)
    trees_close(got.deltas, want.deltas, rtol=2e-3, atol=2e-4)
    assert got.memory_report() == want.memory_report()
    assert got.host_transfers == 2 and got.skipped_steps == 0
    cfg = session.backbone.cfg
    eng = ServeEngine(cfg, session.params, device="cpu", **ENGINE)
    got.fold_into(eng)
    assert streams(eng.run(requests(Request, cfg))) == out["streams"]


def test_fold_is_exact_on_reference_deltas(ref):
    """The reference's deltas, folded by the port, give the reference's
    folded weights exactly (the xattn unit's ``wq``/``wo`` included); the
    encoder and the image projection are untouched."""
    out, session, _, _ = ref
    jad = out["adapt"]
    want = jad.fold_into(jax.tree_util.tree_map(
        jax.numpy.asarray, bridge.tree_to_numpy(session.params)))
    got = OV.fold_deltas(session.backbone.cfg, session.params,
                         bridge.tree_from_numpy(jax.tree_util.tree_map(
                             np.asarray, jad.deltas), device="cpu"),
                         jad.policy)
    trees_close(got, want, rtol=0, atol=0)
    for key in ("encoder", "img_proj"):
        if key in got:
            assert got[key] is session.params[key]


def test_remat_matches_a_plain_policy(ref):
    """A policy with ``meta["remat"]``: the loss and every delta's
    gradient equal the plain policy's bit for bit (the recomputed layers
    run the same ops) and the reference's within 1e-5; a fine-tune under
    it gives the plain policy's deltas."""
    out, session, task, port = ref
    cfg, params = session.backbone.cfg, session.params
    plain = port["adapt"].policy
    remat = dataclasses.replace(plain, meta=dict(plain.meta or {},
                                                 remat=True))
    deltas = tree_map(lambda t: 0.05 * torch.randn(
        t.shape, generator=torch.Generator().manual_seed(1)),
        session.backbone.init_deltas(plain, "cpu"))

    def loss_and_grads(pol):
        d = tree_map(lambda t: t.clone().requires_grad_(), deltas)
        loss = T.lm_loss(cfg, params, _batch(out), deltas=d, plan=pol)
        leaves = [t for k in sorted(d) for kind in sorted(d[k])
                  for _, t in sorted(d[k][kind].items())]
        return loss, torch.autograd.grad(loss, leaves)

    l0, g0 = loss_and_grads(plain)
    l1, g1 = loss_and_grads(remat)
    assert torch.equal(l0, l1)
    assert all(torch.equal(a, b) for a, b in zip(g0, g1))
    jplain = out["adapt"].policy
    jremat = dataclasses.replace(jplain, meta=dict(jplain.meta or {},
                                                   remat=True))
    jcfg = jconfigs.get_reduced(request_arch(cfg))
    jparams = jax.tree_util.tree_map(jax.numpy.asarray,
                                     bridge.tree_to_numpy(params))
    jd = jax.tree_util.tree_map(jax.numpy.asarray,
                                bridge.tree_to_numpy(deltas))
    want = float(JT.lm_loss(jcfg, jparams, out["batch"], deltas=jd,
                            plan=jremat))
    assert l1.item() == pytest.approx(want, rel=1e-5)
    ad = session.adapt(task, api.JETSON_NANO, iters=2,
                       policy_override=remat)
    base = session.adapt(task, api.JETSON_NANO, iters=2,
                         policy_override=plain)
    assert ad.losses == base.losses
    for a, b in zip(jax.tree_util.tree_leaves(bridge.tree_to_numpy(
            ad.deltas)), jax.tree_util.tree_leaves(bridge.tree_to_numpy(
            base.deltas))):
        np.testing.assert_array_equal(a, b)


def test_logit_chunk_matches_the_unchunked_loss(ref):
    """``lm_loss(logit_chunk=4)`` over 16 labels: the loss equals the
    unchunked one within 1e-5 and the reference's chunked loss within
    1e-5, and the deltas' gradients agree with the unchunked ones."""
    out, session, _, port = ref
    cfg, params = session.backbone.cfg, session.params
    policy = port["adapt"].policy
    d0 = session.backbone.init_deltas(policy, "cpu")

    def run(chunk):
        d = tree_map(lambda t: t.clone().requires_grad_(), d0)
        loss = T.lm_loss(cfg, params, _batch(out), deltas=d, plan=policy,
                         logit_chunk=chunk)
        leaves = [t for k in sorted(d) for kind in sorted(d[k])
                  for _, t in sorted(d[k][kind].items())]
        return loss, torch.autograd.grad(loss, leaves)

    l0, g0 = run(0)
    l1, g1 = run(4)
    assert l1.item() == pytest.approx(l0.item(), rel=1e-5)
    for a, b in zip(g0, g1):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4,
                                   atol=1e-6)
    jcfg = jconfigs.get_reduced(request_arch(cfg))
    jparams = jax.tree_util.tree_map(jax.numpy.asarray,
                                     bridge.tree_to_numpy(params))
    want = float(JT.lm_loss(jcfg, jparams, out["batch"], logit_chunk=4))
    got = float(T.lm_loss(cfg, params, _batch(out), logit_chunk=4))
    assert got == pytest.approx(want, rel=1e-5)
