"""The port's fleet serving on the CPU against the JAX package's, on the
reference test's two-layer ``tiny_cfg`` (``tests/test_fleet_serving.py``)
with the JAX weights bridged across: ``FleetRouter`` replicas' streams
and outcomes equal to the JAX ``FleetRouter``'s and to one engine's,
greedy and sampled on paged caches and personalised, each replica at one
host sync a chunk; sticky placement with the user's delta set migrating on
re-homing; ``queue_full`` only when every replica is saturated; a replica
killed mid-run (every request terminal once, the streams unchanged); the
int8 delta payload written by each package decoded by the other; and the
``Personaliser`` over a router (the refresh as serialized bytes) with the
JAX Personaliser's rounds, users and wire bytes."""
import jax
import numpy as np
import pytest
import torch

from repro.core import TinyTrainSession as JSession
from repro.core import lm_backbone as jlm_backbone
from repro.core.policy import SelectedUnit as JUnit
from repro.core.policy import SparseUpdatePolicy as JPolicy
from repro.models import transformer as JT
from repro.models.api import ArchConfig as JArchConfig
from repro.optim import compress as JC
from repro.serving import DeltaSet as JDeltaSet
from repro.serving import FleetRouter as JFleetRouter
from repro.serving import Personaliser as JPersonaliser
from repro.serving import Request as JRequest
from repro.serving import decode_delta_payload as jdecode
from repro.serving import encode_delta_payload as jencode
from repro_torch import api, bridge
from repro_torch.core.backbones import lm_backbone
from repro_torch.core.policy import SelectedUnit, SparseUpdatePolicy
from repro_torch.models.api import ArchConfig
from repro_torch.optim import compress as C
from repro_torch.serving import (
    DeltaSet, FleetRouter, Personaliser, Request, ServeEngine,
    decode_delta_payload, encode_delta_payload,
)
from repro_torch.utils import tree_leaves

TINY = dict(name="t", family="dense", n_layers=2, d_model=32, vocab=64,
            n_heads=2, n_kv_heads=2, head_dim=16, d_ff=64, dtype="float32")
PAGED = dict(slots=2, max_len=32, chunk=8, fused=True, prefill_block=4,
             kv_paging=True, kv_page_size=4)
SAMPLED = dict(temperature=0.8, top_k=8)
PERS = dict(slots=2, max_len=32, chunk=8, fused=True, prefill_block=4)
LOOP = dict(slots=2, max_len=32, chunk=4, fused=True, prefill_block=4)
KILL = dict(slots=2, max_len=48, chunk=4, fused=True, prefill_block=4,
            kv_paging=True, kv_page_size=4)
CPU = ["cpu"]


def requests(make, seed, n=10, users=4, max_new=6):
    rng = np.random.default_rng(seed)
    return [make(uid=i % users,
                 prompt=rng.integers(0, TINY["vocab"],
                                     size=int(rng.integers(3, 9)))
                 .astype(np.int32),
                 max_new=max_new)
            for i in range(n)]


def streams(reqs):
    return [(tuple(r.out), r.outcome) for r in reqs]


def covering_policy(bb, unit_cls, policy_cls):
    """One unit of every kind (first and last channel), as the reference
    test builds it."""
    units, seen = [], set()
    for c in reversed(bb.unit_costs):
        if c.kind not in seen:
            units.append(unit_cls(c.layer, c.kind,
                                  tuple(sorted({0, c.n_channels - 1}))))
            seen.add(c.kind)
    units.sort(key=lambda u: (u.layer, u.kind))
    return policy_cls(horizon=0, units=tuple(units))


def rand_deltas(bb, policy, seed, scale=0.05):
    """The reference test's random deltas, as numpy."""
    leaves, treedef = jax.tree_util.tree_flatten(bb.init_deltas(policy))
    keys = jax.random.split(jax.random.PRNGKey(seed), len(leaves))
    return jax.tree_util.tree_unflatten(
        treedef, [np.asarray(jax.random.normal(k, x.shape, x.dtype) * scale)
                  for k, x in zip(keys, leaves)])


def loop_requests(make):
    rng = np.random.default_rng(5)
    return [make(uid=i % 2, prompt=rng.integers(0, TINY["vocab"], size=5)
                 .astype(np.int32), max_new=5) for i in range(6)]


def refresh_summary(rep):
    return (rep["rounds"], rep["all_done"], [
        (r["users"], r["deferred_users"], r["payload_bytes_wire"],
         r["payload_bytes_f32"], r["wire_serialized"])
        for r in rep["refreshes"]])


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def ref():
    """The JAX package's router runs, once per module, and the bridged
    weights, policy and delta sets."""
    jcfg = JArchConfig(**TINY).validate()
    jp = JT.init_params(jcfg, jax.random.PRNGKey(0))
    jbb = jlm_backbone(jcfg, tokens_per_batch=32, batch_size=2)
    jpol = covering_policy(jbb, JUnit, JPolicy)
    sets = {u: rand_deltas(jbb, jpol, 3 + u) for u in (0, 1)}
    out = {"jcfg": jcfg, "jp": jp, "jbb": jbb, "jpol": jpol, "sets": sets}
    for name, kw in (("greedy", PAGED), ("sampled", dict(PAGED, **SAMPLED))):
        reqs = requests(JRequest, seed=7)
        JFleetRouter(jcfg, jp, replicas=3, **kw).run(reqs)
        out[name] = streams(reqs)
    router = JFleetRouter(jcfg, jp, replicas=2, personalise=jpol, **PERS)
    for u, d in sets.items():
        router.swap_deltas(u, JDeltaSet.from_policy(jpol, d))
    reqs = requests(JRequest, seed=11, n=8, users=2)
    router.run(reqs)
    out["personalised"] = streams(reqs)
    jsession = JSession(jbb, jp, seed=0)
    jrouter = JFleetRouter(jcfg, jp, replicas=2, personalise=jpol, **LOOP)
    out["loop"] = refresh_summary(JPersonaliser(
        jsession, jrouter, jpol, iters=2, min_streams=2, seq=16,
        refresh_cap=1).run_online(loop_requests(JRequest)))

    cfg = ArchConfig(**TINY).validate()
    out["cfg"] = cfg
    out["params"] = bridge.params_from_numpy(
        cfg, jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    out["bb"] = lm_backbone(cfg, tokens_per_batch=32, batch_size=2)
    out["policy"] = covering_policy(out["bb"], SelectedUnit,
                                    SparseUpdatePolicy)
    return out


@pytest.mark.parametrize("mode", ["greedy", "sampled"])
def test_router_streams_match_reference(ref, mode):
    """An R = 3 fleet's streams equal the JAX fleet's and one engine's,
    request by request, with the work spread and one host sync a chunk on
    every replica."""
    kw = dict(PAGED, **SAMPLED) if mode == "sampled" else PAGED
    reqs = requests(Request, seed=7)
    router = FleetRouter(ref["cfg"], ref["params"], replicas=3, devices=CPU,
                         **kw)
    router.run(reqs)
    assert streams(reqs) == ref[mode]
    assert all(r.done for r in reqs)
    one = requests(Request, seed=7)
    ServeEngine(ref["cfg"], ref["params"], device="cpu", **kw).run(one)
    assert streams(one) == ref[mode]
    per = router.last_run_report["replicas"]
    assert sum(1 for r in per if r["chunks"]) >= 2
    for rep in per:
        assert rep["host_syncs"] == rep["chunks"]
    rep = router.last_run_report
    assert rep["host_syncs"] == rep["chunks"] == sum(r["chunks"] for r in per)
    assert rep["outcomes"] == {"done": len(reqs)}
    mem = router.memory_report()
    assert mem["replicas"] == 3 and mem["alive"] == 3 and mem["kv_paging"]
    assert mem["pages_free"] == sum(m["pages_free"]
                                    for m in mem["per_replica"])


def test_router_personalised_matches_reference(ref):
    """Delta sets registered through the router before any user has a
    home serve the JAX fleet's personalised streams."""
    router = FleetRouter(ref["cfg"], ref["params"], replicas=2, devices=CPU,
                         personalise=ref["policy"], **PERS)
    for u, d in ref["sets"].items():
        assert router.swap_deltas(
            u, DeltaSet.from_policy(ref["policy"], d)) == 0
    reqs = requests(Request, seed=11, n=8, users=2)
    router.run(reqs)
    assert streams(reqs) == ref["personalised"]
    assert router.memory_report()["delta_arena_bytes"] > 0


def test_sticky_uid_placement_and_delta_migration(ref):
    ds = DeltaSet.from_policy(ref["policy"], ref["sets"][0])
    router = FleetRouter(ref["cfg"], ref["params"], replicas=2, devices=CPU,
                         queue_limit=2, personalise=ref["policy"], **PERS)
    router.swap_deltas(7, ds)
    reqs = requests(Request, seed=3, n=3, users=1, max_new=4)
    for r in reqs:
        r.uid = 7
    assert router.submit(reqs[0]).accepted
    home = router._home[7]
    # the registered set moved to the home replica at first routing
    assert 7 in router.engines[home]._user_deltas
    assert router.submit(reqs[1]).accepted
    assert router._home[7] == home  # sticky while the home has room
    assert router.engines[home].backlog_size() == 2
    # the home saturated (queue_limit 2): the third submission re-homes
    # and the user's deltas migrate with it
    assert router.submit(reqs[2]).accepted
    other = router._home[7]
    assert other != home and 7 in router.engines[other]._user_deltas
    router.scan_chunks()
    assert all(r.done for r in reqs)
    # sample ids are the global submission index, whatever the replica
    assert [r.sample_id for r in reqs] == [0, 1, 2]


def test_queue_full_only_at_fleet_saturation(ref):
    router = FleetRouter(ref["cfg"], ref["params"], replicas=2, devices=CPU,
                         queue_limit=2, **PERS)
    reqs = requests(Request, seed=9, n=5, users=5, max_new=4)
    results = [router.submit(r) for r in reqs]
    # two replicas at queue_limit 2 take four; the fifth sheds, typed
    assert [r.accepted for r in results] == [True] * 4 + [False]
    assert results[-1].reason == "queue_full"
    assert reqs[-1].outcome == "rejected"
    router.scan_chunks()
    assert all(r.done for r in reqs[:4])


def test_replica_kill_every_request_terminal_exactly_once(ref):
    """A replica killed with streams resident: its backlog re-routes, the
    resumed streams equal one engine's, every request ends with one typed
    outcome; a dead replica fails again as a no-op and the last alive one
    cannot be failed."""
    one = requests(Request, seed=13, n=8, users=4, max_new=10)
    ServeEngine(ref["cfg"], ref["params"], device="cpu", **KILL).run(one)
    reqs = requests(Request, seed=13, n=8, users=4, max_new=10)
    router = FleetRouter(ref["cfg"], ref["params"], replicas=2, devices=CPU,
                         **KILL)
    for r in reqs:
        assert router.submit(r).accepted
    router.scan_chunks(rounds=2)  # some streams now mid-decode
    victim = 0 if router.engines[0].has_work() else 1
    moved = router.fail_replica(victim)
    assert moved["rerouted"] >= 1 and moved["shed"] == 0
    assert not router.alive[victim]
    router.scan_chunks()
    assert all(r.outcome in ("done", "truncated") for r in reqs)
    assert streams(reqs) == streams(one)
    assert router.fail_replica(victim) == {"rerouted": 0, "shed": 0}
    with pytest.raises(RuntimeError, match="last alive"):
        router.fail_replica(1 - victim)
    with pytest.raises(ValueError, match="no replica"):
        router.fail_replica(5)


def test_payloads_decode_in_both_packages(ref):
    """A payload the port writes decodes in the JAX package, one the JAX
    package writes decodes in the port, each to the in-process int8
    exchange's deltas and the policy's channels."""
    jd = ref["sets"][0]
    jq, js, _ = JC.int8_compress(jd, JC.ef_state_init(jd))
    td = jax.tree_util.tree_map(torch.from_numpy, jd)
    tq, ts, _ = C.int8_compress(td, C.ef_state_init(td))
    for a, b in zip(jax.tree_util.tree_leaves(jq), tree_leaves(tq)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    want = C.int8_decompress(tq, ts)
    port_bytes = encode_delta_payload(ref["policy"], tq, ts)
    jax_bytes = jencode(ref["jpol"], jq, js)
    assert isinstance(port_bytes, bytes) and len(port_bytes) == len(jax_bytes)
    for ds in (decode_delta_payload(jax_bytes), jdecode(port_bytes)):
        got = jax.tree_util.tree_map(np.asarray, ds.deltas)
        for g, w in zip(jax.tree_util.tree_leaves(got), tree_leaves(want)):
            np.testing.assert_array_equal(g, w.numpy())
        for u in ref["policy"].units:
            np.testing.assert_array_equal(
                np.asarray(ds.channels[f"L{u.layer}"][u.kind]), u.channels)


def test_personaliser_ships_bytes_through_router(ref):
    """Over a router every refresh crosses as serialized bytes, at most
    ``refresh_cap`` users a window, and the rounds, users, deferrals and
    wire bytes are the JAX Personaliser's over its router."""
    session = api.TinyTrainSession(ref["bb"], ref["params"], seed=0,
                                   device="cpu")
    router = FleetRouter(ref["cfg"], ref["params"], replicas=2, devices=CPU,
                         personalise=ref["policy"], **LOOP)
    pers = Personaliser(session, router, ref["policy"], iters=2,
                        min_streams=2, seq=16, refresh_cap=1)
    reqs = loop_requests(Request)
    rep = pers.run_online(reqs)
    assert refresh_summary(rep) == ref["loop"]
    assert rep["all_done"] and rep["refreshes"]
    for r in rep["refreshes"]:
        assert r["wire_serialized"] is True and len(r["users"]) <= 1
        assert 0 < r["payload_bytes_wire"] < r["payload_bytes_f32"]
    assert {u for r in rep["refreshes"] for u in r["users"]} == {0, 1}


def test_router_refuses_what_it_cannot_run(ref):
    cfg, params = ref["cfg"], ref["params"]
    with pytest.raises(ValueError, match="replicas must be >= 1"):
        FleetRouter(cfg, params, replicas=0, devices=CPU)
    with pytest.raises(ValueError, match="fused"):
        FleetRouter(cfg, params, devices=CPU, fused=False)
    with pytest.raises(RuntimeError, match="without personalise"):
        FleetRouter(cfg, params, devices=CPU, **PERS).swap_deltas(0, None)
    if not torch.cuda.is_available():
        # no card and no devices=: never a silent fall-back to the CPU
        with pytest.raises(RuntimeError, match="no CUDA device"):
            FleetRouter(cfg, params, replicas=2, **PERS)
