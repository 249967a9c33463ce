"""Adaptation traffic: one worker in a closed loop of
``TinyTrainSession.adapt(task, profile, iters)`` calls, a new user's
episode each.

Set-up builds the session on the benchmark's weights and drives the
check task through the window's own call (``adapt`` with the mix's
``iters``, so the window's fused loop is built before the window opens)
and through its own probe and step functions (the probe's scores, the
state after one step); that same session then runs the window.  After
the window the float32 reference works the check task out again, all
``iters`` steps, and the gaps are judged."""
from __future__ import annotations

import math
import time
from typing import Any, Dict, List, Tuple

import torch

from .. import compare, flops, inputs, traffic, trace
from ..reference import adapt as RA
from ..reference import ssm_lm as R
from . import common as C

CHECK_TASK = 1 << 30  # the check episode's index, apart from the window's


def _leaves(deltas) -> Dict[str, torch.Tensor]:
    """{"L3": {"ssm": {"w_z": t}}} -> {"L3.w_z": float32 on the host}."""
    return {f"{lk}.{w}": t.detach().float().cpu()
            for lk, kinds in deltas.items() for pack in kinds.values()
            for w, t in pack.items()}


def program_check(api, session, task, profile, steps: int, b1: float,
                  device) -> Dict[str, Any]:
    """The check task through the program: the window's ``adapt`` call at
    ``steps`` iterations (policy, losses, deltas), the probe's per-channel
    scores and the optimizer's state after one step of the same fused
    loop (its first moment / (1 - b1) is the first gradient)."""
    a = session.adapt(task, profile, iters=steps)
    pol = a.policy
    sc = session.step_cache
    bb = session.backbone
    sup, pq = C.on(task.support, device), C.on(task.pseudo_query, device)
    taps = bb.make_taps(sup["episode_labels"].shape[0], device)
    chans = sc.probe_fisher()(session.params, sup, pq, taps,
                              float(task.n_support))
    n_layers = bb.cfg.n_layers
    scores = torch.stack([chans[(j, "ssm")].float() for j in
                          range(n_layers)]).cpu()
    d0 = bb.init_deltas(pol, device)
    run1 = sc.scan_steps(pol, 1)
    _, st1, _, _ = run1(session.params, d0, session.optimizer.init(d0),
                        sup, pq, sc.chan_idx_arrays(pol, device))
    grad1 = {k: v / (1.0 - b1) for k, v in _leaves(st1["m"]).items()}
    return {"units": [(u.layer, list(u.channels)) for u in pol.units],
            "horizon": pol.horizon, "losses": list(a.losses),
            "scores": scores, "grad1": grad1, "deltas": _leaves(a.deltas)}


def episode_tensors(task, device) -> Dict[str, torch.Tensor]:
    """The check task's support and pseudo-query rows on the device, as the
    reference takes them."""
    return {"s_tokens": torch.as_tensor(task.support["tokens"],
                                        device=device),
            "s_labels": torch.as_tensor(task.support["episode_labels"],
                                        device=device),
            "q_tokens": torch.as_tensor(task.pseudo_query["tokens"],
                                        device=device),
            "q_labels": torch.as_tensor(task.pseudo_query["episode_labels"],
                                        device=device)}


def readings(params, sizes, ep, mix: dict, units, steps: int, *,
             prec=R.F32, scores=None, drop_half: bool = False
             ) -> Dict[str, Any]:
    """What the reference (at ``prec``) works out for an episode: the
    probe's scores and ``steps`` Adam steps on ``units``' heads."""
    R.strict_f32()
    if scores is None:
        scores = RA.fisher(params, sizes, ep, mix["max_way"],
                           prec=prec).cpu()
    ad = mix["adam"]
    losses, grad1, deltas = RA.finetune(
        params, sizes, ep, mix["max_way"], units, steps=steps, lr=mix["lr"],
        b1=ad["b1"], b2=ad["b2"], eps=ad["eps"], prec=prec,
        drop_half=drop_half)
    return {"units": [(l, list(h)) for l, h in units], "losses": losses,
            "scores": scores,
            "grad1": {k: v.cpu() for k, v in grad1.items()},
            "deltas": {k: v.cpu() for k, v in deltas.items()}}


def gaps(got: Dict[str, Any], ref: Dict[str, Any]) -> Dict[str, float]:
    """The five numbers compared: ``got`` (the program's, or what stands
    in its place) against the reference's ``ref`` on the same units."""
    keep = compare.counted_leaves(ref["grad1"])
    return {
        "fisher_gap": compare.norm_gap(compare.rows(got["scores"]),
                                       compare.rows(ref["scores"])),
        "select_regret": RA.regret(ref["scores"], got["units"]),
        "loss_gap": compare.loss_gap(got["losses"], ref["losses"]),
        "grad_gap": compare.norm_gap(got["grad1"], ref["grad1"], keep),
        "change_gap": compare.norm_gap(got["deltas"], ref["deltas"], keep),
    }


def build(ctx):
    """The session on the benchmark's weights, the profile, and the
    weights themselves."""
    from repro_torch import api
    from repro_torch.optim import adam

    mix, sz = ctx.mix, ctx.sizes
    cfg = C.arch_config(sz)
    params = inputs.make_weights(sz, ctx.seed, ctx.device)
    bb = api.backbone("lm", cfg=cfg, batch_size=mix["pad"], seq=mix["seq"])
    ad = mix["adam"]
    session = api.TinyTrainSession(
        bb, params=params, max_way=mix["max_way"],
        optimizer=adam(mix["lr"], b1=ad["b1"], b2=ad["b2"], eps=ad["eps"]))
    return api, session, C.profile_of(api, mix["profile"]), params


def run(ctx) -> Dict[str, Any]:
    mix, sz, dev = ctx.mix, ctx.sizes, ctx.device
    api, session, profile, params = build(ctx)

    def task(i: int):
        return C.task_of(api, traffic.episode(mix, sz.vocab, ctx.seed, i),
                         mix["way"], f"user-{i}")

    check_task = task(CHECK_TASK)
    prog = program_check(api, session, check_task, profile, mix["iters"],
                         mix["adam"]["b1"], dev)
    t_start = C.now(dev)
    setup_s = t_start - ctx.t0

    tasks: List[Dict[str, Any]] = []
    rows, seq = 2 * mix["pad"], mix["seq"]

    def one(i: int, traced: bool) -> Dict[str, Any]:
        a = session.adapt(task(i), profile, iters=mix["iters"])
        done = C.now(dev) - t_start
        units = [(u.layer, u.n_channels) for u in a.policy.units]
        return {"t_done": done, "fisher_s": a.fisher_seconds,
                "train_s": a.train_seconds, "units": units,
                "horizon": a.policy.horizon, "traced": traced,
                "finite": all(math.isfinite(x) for x in a.losses)
                and a.skipped_steps == 0,
                "flops": flops.adapt_task_flops(sz, rows, seq, units,
                                                a.policy.horizon,
                                                mix["iters"])}

    while not tasks or tasks[-1]["t_done"] < ctx.seconds:
        tasks.append(one(len(tasks), False))
    summary = None
    if ctx.trace:  # one more task, traced, after the window
        with trace.Traced() as tr:
            t = one(len(tasks), True)
        summary = dict(tr.reduce(), tasks=1, flops=t["flops"],
                       ssd_bwd_expected=2 * (sz.n_layers - 1)
                       + mix["iters"] * 2 * (sz.n_layers - t["horizon"]))
    peak = C.peak_bytes(dev)
    del session
    C.release(dev)
    t_ref = time.perf_counter()
    ref = readings(params, sz, episode_tensors(check_task, dev), mix,
                   prog["units"], len(prog["losses"]))
    checks = {k: {"value": v, "limit": ctx.limits[k]}
              for k, v in gaps(prog, ref).items() if k in ctx.limits}
    out = {"kind": "adapt", "setup_s": setup_s, "peak_bytes": peak,
           "window_s": tasks[-1]["t_done"], "tasks": tasks,
           "window": {"tasks": len(tasks),
                      "task_s": [round(b["t_done"] - a, 4) for a, b in
                                 zip([0.0] + [t["t_done"] for t in tasks],
                                     tasks)]},
           "attempted": len(tasks),
           "failed": sum(not t["finite"] for t in tasks),
           "checks": checks, "reference_s": time.perf_counter() - t_ref,
           "sizes": sz, "mix": mix, "device_kind": C.device_kind(dev)}
    if summary is not None:
        out["trace"] = summary
    return out

