"""The float32 reference against the port at smoke size: the weights'
layout, the forward and logits with and without head deltas, the probe
and the fine-tune; a lower precision reads far above the program."""
import pytest
import torch
import pb_smoke
from pb_smoke import MAMBA2_SMOKE, ZAMBA2_SMOKE

from port_bench import inputs
from port_bench.drivers import adapt as DA
from port_bench.drivers import common as C
from port_bench.reference import ssm_lm as R

ARCHS = [MAMBA2_SMOKE, ZAMBA2_SMOKE]


def _tree_sig(t, pre=""):
    if isinstance(t, dict):
        out = {}
        for k, v in t.items():
            out.update(_tree_sig(v, f"{pre}/{k}"))
        return out
    return {pre: (tuple(t.shape), t.dtype)}


@pytest.mark.parametrize("arch", ARCHS, ids=lambda a: a["name"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_weights_have_the_ports_layout(arch, dtype):
    from repro_torch.models import transformer as T

    sz = inputs.Sizes(dict(arch, dtype=dtype))
    cfg = C.arch_config(sz)
    ours = inputs.make_weights(sz, 3, torch.device("cpu"))
    theirs = T.init_params(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    assert _tree_sig(ours) == _tree_sig(theirs)
    again = inputs.make_weights(sz, 3, torch.device("cpu"))
    assert torch.equal(ours["embed"], again["embed"])


def _policy(units):
    from repro_torch.core.policy import SelectedUnit, SparseUpdatePolicy

    sel = tuple(SelectedUnit(l, "ssm", tuple(h)) for l, h in units)
    return SparseUpdatePolicy(horizon=min(l for l, _ in units), units=sel)


@pytest.mark.parametrize("arch", ARCHS, ids=lambda a: a["name"])
def test_forward_and_logits_match_the_port(arch):
    from repro_torch.models import transformer as T

    R.strict_f32()
    with pb_smoke.one_thread():
        sz = inputs.Sizes(arch)
        cfg = C.arch_config(sz)
        params = inputs.make_weights(sz, 11, torch.device("cpu"))
        toks = torch.randint(0, sz.vocab, (3, 80),
                             generator=torch.Generator().manual_seed(1))
        x, pos, _ = T.build_inputs(cfg, params, {"tokens": toks})
        units = [(1, [0, 2]), (2, [3])]
        gen = torch.Generator().manual_seed(5)
        deltas = {f"L{l}": {"ssm": {
            "w_z": 0.05 * torch.randn(sz.d_model, k, generator=gen),
            "w_x": 0.05 * torch.randn(sz.d_model, k, generator=gen),
            "w_out": 0.05 * torch.randn(k, sz.d_model, generator=gen)}}
            for l, k in ((l, len(hs) * sz.ssm_head_dim) for l, hs in units)}
        for d in (None, deltas):
            kw = {} if d is None else {"deltas": d, "plan": _policy(units)}
            h, _ = T.forward_hidden(cfg, params, x, pos, **kw)
            want = T.unembed(cfg, params, h)
            rd = None if d is None else {
                l: ({w: t.float() for w, t in d[f"L{l}"]["ssm"].items()},
                    torch.tensor(hs)) for l, hs in units}
            got = R.logits(params, R.forward(params, sz, toks, deltas=rd))
            err = (got - want).abs().max() / want.abs().max()
            assert err < 1e-5, float(err)
        # the deltas change the logits: an overlay left out would show
        plain = R.logits(params, R.forward(params, sz, toks))
        assert (plain - got).abs().max() > 1e-3


@pytest.mark.parametrize("arch", ARCHS, ids=lambda a: a["name"])
def test_adaptation_matches_and_fp8_does_not(arch):
    """The program's check task against the reference in float32: every
    gap near rounding; the reference with e4m3 products in the program's
    place reads at least ten times higher on the probe's choice and the
    first gradient."""
    from port_bench.reference import adapt as RA

    with pb_smoke.one_thread():
        ctx = pb_smoke.context(arch, pb_smoke.small_adapt_mix(), {})
        api, session, profile, params = DA.build(ctx)
        mix, sz = ctx.mix, ctx.sizes
        task = C.task_of(api, DA.traffic.episode(mix, sz.vocab, ctx.seed,
                                                 DA.CHECK_TASK),
                         mix["way"], "c")
        prog = DA.program_check(api, session, task, profile, 3,
                                mix["adam"]["b1"], ctx.device)
        ep = DA.episode_tensors(task, ctx.device)
        ref = DA.readings(params, sz, ep, mix, prog["units"], 3)
        g = DA.gaps(prog, ref)
        for k, lim in pb_smoke.ADAPT_LIMITS.items():
            assert g[k] < lim, (k, g[k])
        fp8 = R.Prec("fp8")
        scores = RA.fisher(params, sz, ep, mix["max_way"], prec=fp8)
        units = RA.topk_units(scores, prog["units"])
        ctl = DA.readings(params, sz, ep, mix, units, 3, prec=fp8,
                          scores=scores)
        c = DA.gaps(ctl, DA.readings(params, sz, ep, mix, units, 3,
                                     scores=ref["scores"]))
        assert c["fisher_gap"] > 10 * max(g["fisher_gap"], 1e-6)
        assert c["grad_gap"] > 10 * max(g["grad_gap"], 1e-6)
