"""The port's mesh-sharded fleet adaptation on the CPU: the twin of
``tests/test_fleet_sharding.py``.

``FleetShardingRules`` equals the JAX package's rules on mesh-shaped fakes
(task specs, padded counts, host blocks, a pure-'model' mesh).  On an
8-position CPU mesh with the reference test's micro CNN session and
heterogeneous tasks, ``adapt_many(mesh=)`` equals the port's single-device
run (policies equal, losses within rtol 1e-4 / atol 1e-5, the JAX test's
tolerance) and matches the JAX package's single-device ``adapt_many``
within the same tolerance (the JAX mesh test itself fails on this tree, so
the port is held against the single-device reference); per-host ingestion
(``hosts=2``) equals the global mesh bit for bit; a pure-'model' mesh runs
locally, bit for bit; the reference's ``ValueError``s.  Then one
mamba2-smoke fleet split over two positions (kernels 5 and 5b's plain
versions under ``vmap``, a shard a position) against its single-device
run."""
import jax
import numpy as np
import pytest
import torch

from repro import api as japi
from repro.core.backbones import cnn_backbone as jcnn_backbone
from repro.dist.sharding import FleetShardingRules as JRules
from repro.models import edge_cnn as JE
from repro_torch import api, bridge
from repro_torch.core.backbones import cnn_backbone
from repro_torch.dist import context, make_mesh
from repro_torch.dist.sharding import FleetShardingRules
from repro_torch.launch.mesh import make_debug_mesh
from repro_torch.models import edge_cnn as E

MICRO = ("micro", [(1, 8, 1, 2, 3)], 1.0, 8, 0, 12)
COMBOS = [(2, 2), (3, 3), (4, 3), (2, 7)]
ITERS = 2
CPU = ["cpu"]


def het_tasks(sample, n=8):
    """The reference test's unpadded tasks cycling through (way, shots)."""
    rng = np.random.default_rng(0)
    tasks = []
    for i in range(n):
        way, shots = COMBOS[i % len(COMBOS)]
        tasks.append(sample(
            rng, "stripes", res=12, max_way=4, min_way=way,
            support_pad=None, query_pad=None,
            max_support_total=way * shots, max_support_per_class=shots,
            query_per_class=2))
    return tasks


def units(ad):
    return [(u.layer, u.kind, tuple(int(c) for c in u.channels))
            for u in ad.policy.units]


def close_fleets(got, want, accuracy=True):
    for g, w in zip(got, want):
        assert units(g) == units(w)
        np.testing.assert_allclose(g.losses, w.losses, rtol=1e-4, atol=1e-5)
        if accuracy:
            assert abs(g.accuracy() - w.accuracy()) < 1e-5


def same_fleets(got, want):
    for g, w in zip(got, want):
        assert units(g) == units(w) and g.losses == w.losses
        assert all(torch.equal(a, b) for a, b in zip(
            jax.tree_util.tree_leaves(g.deltas),
            jax.tree_util.tree_leaves(w.deltas)))


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def ref():
    """The JAX package's single-device fleet, and the port's session on the
    bridged weights with its single-device, mesh and per-host fleets."""
    jcfg = JE.build_ir_net(*MICRO)
    js = japi.TinyTrainSession(jcnn_backbone(jcfg, batch_size=8), max_way=4,
                               seed=0)
    jax_fleet = js.adapt_many(het_tasks(japi.sample_task), japi.RPI_ZERO,
                              iters=ITERS)
    cfg = E.build_ir_net(*MICRO)
    params = bridge.params_from_numpy(
        cfg, jax.tree_util.tree_map(np.asarray, js.params), device="cpu")
    session = api.TinyTrainSession(cnn_backbone(cfg, batch_size=8), params,
                                   max_way=4, device="cpu")
    tasks = het_tasks(api.sample_task)
    mesh = make_mesh((8,), ("data",), CPU)
    out = {"jax": jax_fleet, "session": session, "tasks": tasks,
           "mesh": mesh}
    out["single"] = session.adapt_many(tasks, api.RPI_ZERO, iters=ITERS)
    out["single_report"] = dict(session.last_fleet_report)
    out["mesh_fleet"] = session.adapt_many(tasks, api.RPI_ZERO, iters=ITERS,
                                           mesh=mesh)
    out["mesh_report"] = dict(session.last_fleet_report)
    out["hosted"] = session.adapt_many(tasks, api.RPI_ZERO, iters=ITERS,
                                       mesh=mesh, hosts=2)
    out["hosted_report"] = dict(session.last_fleet_report)
    return out


class FakeMesh:
    def __init__(self, **shape):
        self.axis_names = tuple(shape)
        self.shape = dict(shape)


FAKES = {"data_model": dict(data=4, model=2), "model": dict(model=4),
         "pod_data_model": dict(pod=2, data=2, model=2), "data": dict(data=8)}


@pytest.mark.parametrize("fake", sorted(FAKES))
def test_rules_match_reference_on_fakes(fake):
    got = FleetShardingRules(FakeMesh(**FAKES[fake]))
    want = JRules(FakeMesh(**FAKES[fake]))
    assert (got.dp, got.dp_size) == (want.dp, want.dp_size)
    for ndim in (0, 1, 3):
        for n in (1, 4, 6, 8, 16):
            assert got.task_spec(ndim, n) == want.task_spec(ndim, n)
    for n in range(1, 18):
        assert got.padded_count(n) == want.padded_count(n)
    for n, hosts in ((8, 1), (8, 2), (8, 4), (16, 8)):
        assert got.host_blocks(n, hosts) == want.host_blocks(n, hosts)
    for n, hosts, msg in ((8, 0, "n_hosts"), (8, 3, "does not split")):
        with pytest.raises(ValueError, match=msg):
            got.host_blocks(n, hosts)
        with pytest.raises(ValueError, match=msg):
            want.host_blocks(n, hosts)


def test_mesh_matches_single_device_and_reference(ref):
    """8 tasks over 8 positions equal the port's single-device fleet and
    the JAX package's, within the JAX mesh test's tolerance."""
    close_fleets(ref["mesh_fleet"], ref["single"])
    close_fleets(ref["single"], ref["jax"])
    close_fleets(ref["mesh_fleet"], ref["jax"])
    rep, one = ref["mesh_report"], ref["single_report"]
    assert rep["mesh_axes"] == {"data": 8} and rep["ingestion"] == "global"
    assert rep["hosts"] == 1
    assert (one["mesh_axes"], one["hosts"], one["ingestion"]) == (
        None, 1, "local")
    for key in ("tasks", "buckets", "policy_structures", "groups"):
        assert rep[key] == one[key]
    # the deltas come back to the session's device, padding sliced off
    for ad, t in zip(ref["mesh_fleet"], ref["tasks"]):
        assert ad.task is t
        leaves = jax.tree_util.tree_leaves(ad.deltas)
        assert all(x.device.type == "cpu" for x in leaves)


def test_each_shard_is_the_single_device_fleet_of_its_tasks(ref):
    """Over 8 positions every group's tasks sit one a shard, so each mesh
    result is the single-device fleet of that task alone, bit for bit:
    the mesh runs the single-device program a shard a position."""
    session = ref["session"]
    for ad, task in zip(ref["mesh_fleet"], ref["tasks"]):
        same_fleets([ad], session.adapt_many([task], api.RPI_ZERO,
                                             iters=ITERS))


def test_hosted_ingestion_equals_global_mesh_bit_for_bit(ref):
    same_fleets(ref["hosted"], ref["mesh_fleet"])
    rep = ref["hosted_report"]
    assert rep["hosts"] == 2 and rep["ingestion"] == "per-host"
    assert rep["mesh_axes"] == {"data": 8}
    # the sharding context's fleet_hosts is the default of hosts=
    session, tasks = ref["session"], ref["tasks"][:3]
    with context.sharding_context(fleet_hosts=2):
        hosted = session.adapt_many(tasks, api.RPI_ZERO, iters=ITERS,
                                    mesh=ref["mesh"])
    assert session.last_fleet_report["ingestion"] == "per-host"
    assert context.get("fleet_hosts") is None
    same_fleets(hosted, session.adapt_many(tasks, api.RPI_ZERO, iters=ITERS,
                                           mesh=ref["mesh"]))


def test_padding_and_a_pure_model_mesh(ref):
    """Three tasks over a 2 x 2 mesh pad to 4 (the copies sliced off); a
    pure-'model' mesh has no data axis and runs locally, bit for bit."""
    session, tasks = ref["session"], ref["tasks"][:3]
    one = session.adapt_many(tasks, api.RPI_ZERO, iters=ITERS)
    padded = session.adapt_many(tasks, api.RPI_ZERO, iters=ITERS,
                                mesh=make_debug_mesh(4, model=2,
                                                     devices=CPU))
    assert len(padded) == 3
    assert session.last_fleet_report["mesh_axes"] == {"data": 2, "model": 2}
    close_fleets(padded, one)
    model_only = session.adapt_many(
        tasks, api.RPI_ZERO, iters=ITERS,
        mesh=make_mesh((2,), ("model",), CPU))
    same_fleets(model_only, one)


def test_fleet_modes_agree(ref):
    """vmap_scan_steps's "map" mode (tasks one by one) equals its "vmap"
    mode within rounding."""
    session, ads = ref["session"], ref["single"][:2]
    cache, pol = session.step_cache, ads[0].policy
    from repro_torch.core.session import _bucket_episode, _stack_trees

    eps = [_bucket_episode(a.task) for a in ads]
    sup = session._on(_stack_trees([e[0] for e in eps]))
    pq = session._on(_stack_trees([e[1] for e in eps]))
    ci = jax.tree_util.tree_map(
        lambda *xs: torch.stack(xs),
        *[cache.chan_idx_arrays(pol, "cpu") for _ in ads])
    got = cache.vmap_scan_steps(pol, ITERS, mode="map")(
        session.params, sup, pq, ci)
    want = cache.vmap_scan_steps(pol, ITERS, mode="vmap")(
        session.params, sup, pq, ci)
    torch.testing.assert_close(got[2], want[2], rtol=1e-5, atol=1e-6)
    for a, b in zip(jax.tree_util.tree_leaves(got[0]),
                    jax.tree_util.tree_leaves(want[0])):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-6)
    with pytest.raises(ValueError, match="unknown fleet mode"):
        cache.vmap_scan_steps(pol, ITERS, mode="pmap")


def test_reference_errors(ref):
    session, task = ref["session"], ref["tasks"][:1]
    with pytest.raises(ValueError, match="hosts must be >= 1"):
        session.adapt_many(task, api.RPI_ZERO, iters=1, hosts=0)
    with pytest.raises(ValueError, match="requires mesh="):
        session.adapt_many(task, api.RPI_ZERO, iters=1, hosts=2)
    with pytest.raises(ValueError, match="must divide the mesh data size"):
        session.adapt_many(task, api.RPI_ZERO, iters=1, mesh=ref["mesh"],
                           hosts=3)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_debug_mesh(2)
    mesh = make_debug_mesh(3, devices=CPU)  # devices repeat
    assert mesh.shape == {"data": 3, "model": 1} and mesh.size == 3
    assert set(mesh.devices) == {torch.device("cpu")}


def test_mamba2_fleet_over_two_positions():
    """A mamba2-smoke fleet of four tasks probed and fine-tuned a shard of
    two a position (kernel 1's task axis a shard, kernels 5 and 5b under
    vmap a shard) against the single-device fleet."""
    bb = api.backbone("mamba2-1.3b", preset="smoke", batch_size=16, seq=16)
    session = api.TinyTrainSession(bb, max_way=4, seed=0, device="cpu")
    rng = np.random.default_rng(3)
    tasks = [api.sample_lm_task(rng, bb.cfg.vocab, seq=16, max_way=4,
                                support_pad=16, query_pad=16)
             for _ in range(4)]
    one = session.adapt_many(tasks, api.JETSON_NANO, iters=ITERS)
    two = session.adapt_many(tasks, api.JETSON_NANO, iters=ITERS,
                             mesh=make_debug_mesh(2, devices=CPU))
    assert session.last_fleet_report["mesh_axes"] == {"data": 2, "model": 1}
    assert all(ad.policy.n_units for ad in one)
    close_fleets(two, one, accuracy=False)
